// CSR segment sum of gathered rows, for Hopper (sm_90a): bf16 or f32 in,
// f32 accumulate, one rounding.
//
// Replaces the TPU kernel buckgnn_tpu/ops/pallas_segment.py::_kernel
// (launched by gather_segment_reduce, the impl='pallas' aggregation of
// ops/sage.py). For each output row i,
//
//     out[i] = sum over k in [off[i], off[i+1]) of x[idx[k], :]
//
// summed in f32 and cast once to x's type; with ``mean`` the output is f32:
// the rounded sum divided by max(off[i+1] - off[i], 1), as the TPU route
// divides its x.dtype result by the count (pallas_segment.py:165-167). The
// forward runs it with idx = the senders in receiver order and off = the
// receiver offsets; the backward (which the TPU kernel lacks) with idx = the
// receivers in sender order and off = the sender offsets, on the cotangent.
//
// The TPU kernel first gathers the messages x[senders] into an [E, H]
// array in HBM, then streams each 256-row node tile's run of it in
// 256-message windows and reduces every window with a [256, 256] one-hot
// selection product on the MXU. Here a warp owns one output row and reads
// its run's rows of x directly: the [E, H] message array is never built,
// and no zero products are made. The sum has a fixed order (lane groups
// add every GROUPS-th edge in turn, then combine with a fixed butterfly),
// with no float atomics, so two runs give the same bits.
//
// What bounds it on an H100: it does H adds per edge and no product, so it
// is bound by bytes. The compulsory traffic is x read once, out written
// once and the indices (at the csr-virtual cell, N = 102,982, E = 450,432,
// H = 512 bf16: 105 + 105 + 2 MB, 0.063 ms at 3.35 TB/s); the rows it
// gathers are x read once per edge (461 MB, 0.14 ms), which the 50 MB L2
// cache only partly absorbs. A row with a long run (a hub, or the dead
// node that owns every pad edge) is summed by one warp, serially.

#include <cuda_bf16.h>
#include <stdint.h>

#include "pack16.cuh"

namespace {

using pack16::Pack;

constexpr int kWarpsPerBlock = 8;

// A warp per output row. The row's ch 16-byte chunks are spread over G
// lanes (NPL chunks a lane); the warp's 32 / G lane groups add every
// (32 / G)-th edge of the run, U edges' loads in flight, and combine their
// partial sums with a butterfly over the groups.
template <typename T, int G, int NPL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
csr_sum_kernel(const T* __restrict__ x, const int* __restrict__ idx,
               const int* __restrict__ off, T* __restrict__ out,
               float* __restrict__ out_mean, int n_rows, int ch) {
  constexpr int GROUPS = 32 / G;
  constexpr int U = NPL >= 8 ? 1 : NPL >= 4 ? 2 : 4;
  constexpr int E = Pack<T>::N;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // warp-uniform
  const int lane = threadIdx.x & 31;
  const int grp = lane / G;
  const int gl = lane % G;
  const int beg = __ldg(off + row);
  const int end = __ldg(off + row + 1);
  const uint4* xv = reinterpret_cast<const uint4*>(x);

  float acc[NPL][E];
#pragma unroll
  for (int p = 0; p < NPL; ++p)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[p][e] = 0.f;

  for (int k0 = beg + grp; k0 < end; k0 += U * GROUPS) {
    uint4 v[U][NPL];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = k0 + u * GROUPS;
      if (k < end) {
        const uint4* src = xv + (size_t)__ldg(idx + k) * ch;
#pragma unroll
        for (int p = 0; p < NPL; ++p) {
          const int c = gl + p * G;
          if (c < ch) v[u][p] = __ldg(src + c);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (k0 + u * GROUPS < end) {
#pragma unroll
        for (int p = 0; p < NPL; ++p) {
          if (gl + p * G >= ch) continue;
          float f[E];
          Pack<T>::unpack(v[u][p], f);
#pragma unroll
          for (int e = 0; e < E; ++e) acc[p][e] += f[e];
        }
      }
    }
  }
#pragma unroll
  for (int o = G; o < 32; o <<= 1)
#pragma unroll
    for (int p = 0; p < NPL; ++p)
#pragma unroll
      for (int e = 0; e < E; ++e)
        acc[p][e] += __shfl_xor_sync(0xffffffffu, acc[p][e], o);
  if (grp != 0) return;

  const float cnt = (float)max(end - beg, 1);
#pragma unroll
  for (int p = 0; p < NPL; ++p) {
    const int c = gl + p * G;
    if (c >= ch) continue;
    const size_t at = (size_t)row * ch + c;
    if (out_mean) {
      float4* dst = reinterpret_cast<float4*>(out_mean + at * E);
#pragma unroll
      for (int q = 0; q < E / 4; ++q)
        dst[q] = make_float4(Pack<T>::round(acc[p][4 * q]) / cnt,
                             Pack<T>::round(acc[p][4 * q + 1]) / cnt,
                             Pack<T>::round(acc[p][4 * q + 2]) / cnt,
                             Pack<T>::round(acc[p][4 * q + 3]) / cnt);
    } else {
      reinterpret_cast<uint4*>(out)[at] = Pack<T>::pack(acc[p]);
    }
  }
}

template <typename T, int G, int NPL>
cudaError_t launch(const void* x, const int* idx, const int* off, void* out,
                   float* out_mean, int n_rows, int ch, cudaStream_t st) {
  const int blocks = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  csr_sum_kernel<T, G, NPL><<<blocks, kWarpsPerBlock * 32, 0, st>>>(
      static_cast<const T*>(x), idx, off, static_cast<T*>(out), out_mean,
      n_rows, ch);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const int* idx, const int* off, void* out,
                     float* out_mean, int n_rows, int ch, cudaStream_t st) {
  if (ch <= 1) return launch<T, 1, 1>(x, idx, off, out, out_mean, n_rows, ch, st);
  if (ch <= 2) return launch<T, 2, 1>(x, idx, off, out, out_mean, n_rows, ch, st);
  if (ch <= 4) return launch<T, 4, 1>(x, idx, off, out, out_mean, n_rows, ch, st);
  if (ch <= 8) return launch<T, 8, 1>(x, idx, off, out, out_mean, n_rows, ch, st);
  if (ch <= 16) return launch<T, 16, 1>(x, idx, off, out, out_mean, n_rows, ch, st);
  if (ch <= 32) return launch<T, 32, 1>(x, idx, off, out, out_mean, n_rows, ch, st);
  if (ch <= 64) return launch<T, 32, 2>(x, idx, off, out, out_mean, n_rows, ch, st);
  if (ch <= 128) return launch<T, 32, 4>(x, idx, off, out, out_mean, n_rows, ch, st);
  if (ch <= 256) return launch<T, 32, 8>(x, idx, off, out, out_mean, n_rows, ch, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// x [n_src, h] (bf16 when is_f32 == 0, else f32), idx [off[n_rows]] int32
// rows of x, off [n_rows + 1] int32; out [n_rows, h] of x's type, or with
// ``mean`` out_mean [n_rows, h] f32 (out unused). h % 8 == 0, h <= 1024.
extern "C" int csr_segment_sum(const void* x, const void* idx, const void* off,
                               void* out, void* out_mean, int n_rows, int h,
                               int is_f32, int mean, void* stream) {
  if (h <= 0 || h % 8 != 0 || h > 1024 || n_rows < 0)
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ip = static_cast<const int*>(idx);
  const int* op = static_cast<const int*>(off);
  float* mp = mean ? static_cast<float*>(out_mean) : nullptr;
  if (is_f32)
    return (int)dispatch<float>(x, ip, op, out, mp, n_rows, h / 4, st);
  return (int)dispatch<__nv_bfloat16>(x, ip, op, out, mp, n_rows, h / 8, st);
}
