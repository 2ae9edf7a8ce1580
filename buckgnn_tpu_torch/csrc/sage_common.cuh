// Pieces shared by the fused SAGE layer's forward and backward kernels.
//
// dropout_bits: the port's counter-based dropout words, a keyed
// murmur3-finalizer chain of (seed s0, seed s1, global row, column). It is
// the same function, bit for bit, as buckgnn_tpu_torch/ops/dropout.py::
// dropout_bits, so a layer's backward regenerates its forward's mask from
// the two seed words alone (the TPU kernels regenerate theirs from the
// chip's hardware generator, which has no GPU counterpart).
//
// table_reduce_kernel: the deterministic second pass of a star-table sum.
// The TPU kernels sum a [tg, H] table across node tiles in scratch memory
// over their sequential grid; here every 64-row block writes f32 partials
// [2GW, H] and this kernel adds them in block order for each table row.
//
// spill_window_start: the spill window of a node tile, for the spill term
// of the band product (banded.cuh::add_spill, in the banded SpMM and the
// forward). Tile t's messages are SPILL_CHUNK rows of the receiver-sorted
// spill list from w_t = clip(off[t] / SPILL_ALIGN * SPILL_ALIGN, 0, Es -
// SPILL_CHUNK) (graph/batch.py::_host_spill_ranges), and each row's
// messages are one contiguous run [lo, hi) of that window.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace sage {

constexpr int SPILL_CHUNK = 256;  // window rows
constexpr int SPILL_ALIGN = 16;   // window start alignment

__device__ __forceinline__ int spill_window_start(int off_t, int n_spill) {
  return max(0, min(off_t / SPILL_ALIGN * SPILL_ALIGN, n_spill - SPILL_CHUNK));
}

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// the row half of the hash, computed once per row
__device__ __forceinline__ uint32_t row_key(uint32_t s0, uint32_t row) {
  return fmix32(row * 0x9E3779B1u + s0);
}

__device__ __forceinline__ uint32_t dropout_bits(uint32_t rk, uint32_t s1,
                                                 uint32_t col) {
  return fmix32(rk ^ (col * 0x85EBCA77u + s1));
}

// ftab[r, c] = sum over blocks b whose tile window holds table row r of
// partial[b, code(r), c], in block order. gwin null: every tile's window is
// the whole table (gw == t0, base 0). Windows are not monotone in t (empty
// tiles sit at base 0), so every tile is checked.
__global__ void table_reduce_kernel(const float* partial, const int* gwin,
                                    float* ftab, int n_tiles, int bpt,
                                    int gw, int t0, int h) {
  const int r = blockIdx.y;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= h) return;
  const int g2 = 2 * gw;
  float s = 0.f;
  for (int t = 0; t < n_tiles; ++t) {
    const int wb = gwin ? gwin[t] : 0;
    int code;
    if (r >= wb && r < wb + gw) {
      code = r - wb;
    } else if (r >= t0 + wb && r < t0 + wb + gw) {
      code = gw + r - t0 - wb;
    } else {
      continue;
    }
    for (int k = 0; k < bpt; ++k)
      s += partial[((size_t)(t * bpt + k) * g2 + code) * h + c];
  }
  ftab[(size_t)r * h + c] = s;
}

}  // namespace sage
