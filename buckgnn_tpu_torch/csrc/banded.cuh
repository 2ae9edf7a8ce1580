// The banded product of the fused SAGE layer's backward and of the banded
// SpMM, one kernel for both: bf16 in, f32 accumulate. Per node tile t (T
// rows) with slab start s_t = clip(t*T - W/2, 0, max(N - (T+W), 0)) and,
// with spill, the window start w_t (sage_common.cuh::spill_window_start):
//
//   acc = band_t @ x[s_t : s_t+T+W]                              f32
//       + sum_{m in [lo_r, hi_r)} msgs[w_t + m]                  (spill)
//       + table[gcode_r]  (the sentinel code tg adds nothing)     (table)
//       + acc_in_r                                                (acc)
//   out = out_dtype(acc)
//
// banded_matmul.cu launches it with any of the three options;
// sage_layer_bwd.cu's merged backward launches it as its band pass,
// dx = bf16(band @ dagg slab + dxp), with acc only.
//
// Design, simple first: one block of 8 warps owns 64 rows across the full
// width H (each output row is written by one block: no float atomics, two
// runs give the same bits). The int8 band is converted to bf16 in shared
// memory (counts <= 127 are exact) and multiplied with wmma 16x16x16 bf16
// fragments read from global memory; the f32 accumulator is staged in
// shared memory, and a warp per row then adds its spill run, table row and
// acc row and writes the row. The table one-hot of the TPU kernel selects
// at most one row per output row, so the row is added directly.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "sage_common.cuh"

namespace sage {

constexpr int BAND_BM = 64;  // rows per block
constexpr int BAND_NWARP = 8;
constexpr int BAND_NTHREADS = BAND_NWARP * 32;

struct BandParams {
  const __nv_bfloat16* x;      // [N, H]
  const int8_t* band;          // [N, T+W] (tile t = rows t*T .. t*T+T)
  const __nv_bfloat16* msgs;   // [Es, H] receiver-sorted spill messages
  const int* off;              // [n_tiles + 1] spill offsets (spill)
  const int* lo;               // [N] first window column of each row (spill)
  const int* hi;               // [N] end window column of each row (spill)
  const int* gcode;            // [N] table row of each row, tg = none (table)
  const __nv_bfloat16* table;  // [tg, H] (table)
  const __nv_bfloat16* acc;    // [N, H] added before the cast (acc)
  void* out;                   // [N, H] bf16 or f32
  int n, tile, width, n_spill, tg, has_spill, has_table, has_acc, out_f32;
};

template <int H>
__global__ void __launch_bounds__(BAND_NTHREADS, 1)
    banded_kernel(BandParams p) {
  namespace wmma = nvcuda::wmma;
  typedef __nv_bfloat16 bf16;
  constexpr int BM = BAND_BM;
  constexpr int NWARP = BAND_NWARP;
  constexpr int NTHREADS = BAND_NTHREADS;
  constexpr int WN = H / NWARP;  // accumulator columns per warp
  constexpr int NF = WN / 16;    // column fragments per warp
  constexpr int MF = BM / 16;    // row fragments
  constexpr int LDF = H + 4;     // f32 staging stride (floats)
  constexpr int NQ = H / 64;     // column pairs per lane
  constexpr int RPW = BM / NWARP;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sf = reinterpret_cast<float*>(smem);
  bf16* sA = reinterpret_cast<bf16*>(smem);  // aliases sf

  const int S = p.tile + p.width;
  const int LD1 = S + 8;
  const int bpt = p.tile / BM;
  const int t = blockIdx.x / bpt;
  const int row0 = blockIdx.x * BM;
  const int start = max(0, min(t * p.tile - p.width / 2, max(p.n - S, 0)));
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int n0 = warp * WN;

  const int8_t* band = p.band + (size_t)row0 * S;
  for (int i = tid; i < BM * S; i += NTHREADS) {
    const int r = i / S;
    const int k = i - r * S;
    sA[r * LD1 + k] = __float2bfloat16((float)band[i]);
  }
  __syncthreads();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MF][NF];
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  for (int k0 = 0; k0 < S; k0 += 16) {
    const bf16* brow = p.x + (size_t)(start + k0) * H;
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[MF];
#pragma unroll
    for (int i = 0; i < MF; ++i)
      wmma::load_matrix_sync(a[i], sA + i * 16 * LD1 + k0, LD1);
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(b, brow + n0 + j * 16, H);
#pragma unroll
      for (int i = 0; i < MF; ++i) wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
    }
  }
  __syncthreads();  // every warp is done with sA before sf overwrites it
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j)
      wmma::store_matrix_sync(sf + i * 16 * LDF + n0 + j * 16, acc[i][j], LDF,
                              wmma::mem_row_major);
  __syncthreads();

  const int ws = p.has_spill ? spill_window_start(p.off[t], p.n_spill) : 0;
  for (int rr = 0; rr < RPW; ++rr) {
    const int r = warp * RPW + rr;
    const int grow = row0 + r;
    const size_t gh = (size_t)grow * H;
    float v[NQ][2];
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int c = q * 64 + lane * 2;
      v[q][0] = sf[r * LDF + c];
      v[q][1] = sf[r * LDF + c + 1];
    }
    if (p.has_spill)
      add_spill_run<H>(p.msgs, ws, p.lo[grow], p.hi[grow], lane, v);
    if (p.has_table) {
      const int code = p.gcode[grow];
      if (code < p.tg) {
        const bf16* trow = p.table + (size_t)code * H;
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const __nv_bfloat162 t2 = *reinterpret_cast<const __nv_bfloat162*>(
              trow + q * 64 + lane * 2);
          v[q][0] += __bfloat162float(t2.x);
          v[q][1] += __bfloat162float(t2.y);
        }
      }
    }
    if (p.has_acc) {
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const __nv_bfloat162 a2 = *reinterpret_cast<const __nv_bfloat162*>(
            p.acc + gh + q * 64 + lane * 2);
        v[q][0] += __bfloat162float(a2.x);
        v[q][1] += __bfloat162float(a2.y);
      }
    }
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int c = q * 64 + lane * 2;
      if (p.out_f32) {
        *reinterpret_cast<float2*>(static_cast<float*>(p.out) + gh + c) =
            make_float2(v[q][0], v[q][1]);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(p.out) + gh +
                                           c) =
            __floats2bfloat162_rn(v[q][0], v[q][1]);
      }
    }
  }
}

template <int H>
cudaError_t launch_banded(const BandParams& p, cudaStream_t stream) {
  int smem = BAND_BM * (H + 4) * 4;
  const int a_bytes = BAND_BM * (p.tile + p.width + 8) * 2;
  if (a_bytes > smem) smem = a_bytes;
  cudaError_t e = cudaFuncSetAttribute(
      banded_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  banded_kernel<H><<<p.n / BAND_BM, BAND_NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace sage
