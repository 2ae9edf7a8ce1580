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
// selection product on the MXU. Here the rows of x are read directly: the
// [E, H] message array is never built, and no zero products are made.
//
// What bounds it on an H100: it does H adds per edge and no product, so it
// is bound by bytes. The compulsory traffic is x read once, out written
// once and the indices (at the csr-virtual cell, N = 102,982, E = 450,432,
// H = 512 bf16: 105 + 105 + 2 MB, 0.064 ms at 3.35 TB/s); the rows it
// gathers are x read once per edge (461 MB, 0.17 ms at the HBM rate),
// which L2 and L1 partly absorb.
//
// Design. A warp owns an output row whose run has at most kSplit = 32
// edges (every real row of the cells: in-degree <= 10): its lane groups
// keep U edges' index and row loads in flight and add them in a fixed
// order. A longer run (a hub, or the dead row that owns every pad edge:
// 190 at csr-virtual, thousands in a trainer-packed batch) would be one
// long serial warp that the whole launch waits for, so it is cut into
// chunks of kSplit edges: the first blocks of the launch (two per SM) each
// scan a stripe of the offsets for such rows and sum them one at a time,
// their warps summing chunks into f32 partials in shared memory that the
// block adds in chunk order. Those blocks start first, beside the row
// blocks, and need no plan from the host. Every sum has a fixed order and
// no float atomics, so two runs give the same bits; each output is rounded
// once.

#include <cuda_bf16.h>
#include <stdint.h>

#include "pack16.cuh"

namespace {

using pack16::Pack;

constexpr int kWarpsPerBlock = 8;
constexpr int kSplit = 32;  // edges of a chunk (ops/csr_segment.py::SPLIT)
constexpr int kMaxH = 1024;

// acc = the f32 sum of x's rows idx[beg .. beg + len) (len <= 32), summed
// by one warp. A row's ch 16-byte chunks are spread over G lanes (NPL
// chunks a lane); the warp's 32 / G lane groups add every (32 / G)-th edge
// in turn, U edges' index and row loads in flight, and combine their
// partial sums with a butterfly over the groups (every lane ends with its
// chunks' totals).
template <typename T, int G, int NPL>
__device__ __forceinline__ void warp_sum(const uint4* xv, const int* idx,
                                         int beg, int len, int ch, int lane,
                                         float (&acc)[NPL][Pack<T>::N]) {
  constexpr int GROUPS = 32 / G;
  constexpr int U = NPL >= 8 ? 1 : NPL >= 4 ? 2 : 4;
  constexpr int E = Pack<T>::N;
  const int grp = lane / G;
  const int gl = lane % G;
#pragma unroll
  for (int p = 0; p < NPL; ++p)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[p][e] = 0.f;
  for (int k0 = grp; k0 < len; k0 += U * GROUPS) {
    uint4 v[U][NPL];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = k0 + u * GROUPS;
      if (k < len) {
        // (clamped: a load hoisted above the test stays inside the run)
        const int src = __ldg(idx + beg + min(k, len - 1));
        const uint4* row = xv + (size_t)src * ch;
#pragma unroll
        for (int p = 0; p < NPL; ++p) {
          const int c = gl + p * G;
          if (c < ch) v[u][p] = __ldg(row + c);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (k0 + u * GROUPS < len) {
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
}

// the rows of this split block's stripe whose run is longer than kSplit,
// one at a time: each round, warp w sums chunk c0 + w of kSplit edges into
// f32 partials in shared memory, then each thread adds its columns'
// partials to its running totals in chunk order; one rounding at the end.
// The block finds those rows itself, 256 offsets at a time (their order
// does not matter: each row's sum is its own).
template <typename T, int G, int NPL>
__device__ __forceinline__ void split_rows(const uint4* xv, const int* idx,
                                           const int* off, int n_rows,
                                           int n_split, T* out,
                                           float* out_mean, int ch,
                                           float* part) {
  constexpr int E = Pack<T>::N;
  constexpr int NT = kWarpsPerBlock * 32;
  __shared__ int list[NT];
  __shared__ int n_long;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h = ch * E;
  const int per = (n_rows + n_split - 1) / n_split;
  const int r_lo = blockIdx.x * per, r_hi = min(n_rows, r_lo + per);
  for (int base = r_lo; base < r_hi; base += NT) {
    const int r = base + threadIdx.x;
    const int rc = min(r, r_hi - 1);  // a hoisted load stays in the stripe
    const int len = __ldg(off + rc + 1) - __ldg(off + rc);
    if (threadIdx.x == 0) n_long = 0;
    __syncthreads();
    if (r < r_hi && len > kSplit) list[atomicAdd(&n_long, 1)] = r;
    __syncthreads();
    for (int j = 0; j < n_long; ++j) {
      const int row = list[j];
      const int beg = __ldg(off + row), end = __ldg(off + row + 1);
      const int nch = (end - beg + kSplit - 1) / kSplit;
      float tot[kMaxH / NT];
#pragma unroll
      for (int i = 0; i < kMaxH / NT; ++i) tot[i] = 0.f;
      for (int c0 = 0; c0 < nch; c0 += kWarpsPerBlock) {
        const int c = c0 + warp;
        if (c < nch) {
          float acc[NPL][E];
          const int cb = beg + c * kSplit;
          warp_sum<T, G, NPL>(xv, idx, cb, min(kSplit, end - cb), ch, lane,
                              acc);
          if (lane < G) {
#pragma unroll
            for (int p = 0; p < NPL; ++p) {
              const int cc = lane + p * G;
              if (cc >= ch) continue;
#pragma unroll
              for (int e = 0; e < E; ++e)
                part[warp * h + cc * E + e] = acc[p][e];
            }
          }
        }
        __syncthreads();
        const int nw = min(kWarpsPerBlock, nch - c0);
#pragma unroll
        for (int i = 0; i < kMaxH / NT; ++i) {
          const int col = threadIdx.x + i * NT;
          if (col < h)
            for (int w = 0; w < nw; ++w) tot[i] += part[w * h + col];
        }
        __syncthreads();
      }
      const float cnt = (float)(end - beg);
#pragma unroll
      for (int i = 0; i < kMaxH / NT; ++i) {
        const int col = threadIdx.x + i * NT;
        if (col >= h) continue;
        const size_t at = (size_t)row * h + col;
        if (out_mean)
          out_mean[at] = Pack<T>::round(tot[i]) / cnt;
        else
          out[at] = Pack<T>::one(tot[i]);
      }
    }
    __syncthreads();  // every thread has read the list before it is reset
  }
}

// Blocks [0, n_split) sum the runs longer than kSplit edges, each in its
// stripe of rows (`split_rows`); the rest a warp per output row, for rows
// of at most kSplit edges (`warp_sum`).
template <typename T, int G, int NPL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
csr_sum_kernel(const T* __restrict__ x, const int* __restrict__ idx,
               const int* __restrict__ off, int n_split, T* __restrict__ out,
               float* __restrict__ out_mean, int n_rows, int ch) {
  constexpr int E = Pack<T>::N;
  extern __shared__ float part[];  // [kWarpsPerBlock, H] chunk partials
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  if ((int)blockIdx.x < n_split) {
    split_rows<T, G, NPL>(xv, idx, off, n_rows, n_split, out, out_mean, ch,
                          part);
    return;
  }
  const int row =
      ((int)blockIdx.x - n_split) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // warp-uniform
  const int lane = threadIdx.x & 31;
  const int beg = __ldg(off + row);
  const int end = __ldg(off + row + 1);
  if (end - beg > kSplit) return;  // a split block sums it
  float acc[NPL][E];
  warp_sum<T, G, NPL>(xv, idx, beg, end - beg, ch, lane, acc);
  if (lane >= G) return;

  const float cnt = (float)max(end - beg, 1);
#pragma unroll
  for (int p = 0; p < NPL; ++p) {
    const int c = lane + p * G;
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

// split blocks of a launch: two per SM, at most one per row
int split_blocks(int n_rows) {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 1;
  }
  return n_rows < 2 * sms ? n_rows : 2 * sms;
}

template <typename T, int G, int NPL>
cudaError_t launch(const void* x, const int* idx, const int* off, void* out,
                   float* out_mean, int n_rows, int ch, cudaStream_t st) {
  const int n_split = split_blocks(n_rows);
  const int blocks =
      n_split + (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int smem = kWarpsPerBlock * ch * Pack<T>::N * (int)sizeof(float);
  csr_sum_kernel<T, G, NPL><<<blocks, kWarpsPerBlock * 32, smem, st>>>(
      static_cast<const T*>(x), idx, off, n_split, static_cast<T*>(out),
      out_mean, n_rows, ch);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const int* idx, const int* off, void* out,
                     float* out_mean, int n_rows, int ch, cudaStream_t st) {
#define CSR_LAUNCH(G, NPL) \
  launch<T, G, NPL>(x, idx, off, out, out_mean, n_rows, ch, st)
  if (ch <= 1) return CSR_LAUNCH(1, 1);
  if (ch <= 2) return CSR_LAUNCH(2, 1);
  if (ch <= 4) return CSR_LAUNCH(4, 1);
  if (ch <= 8) return CSR_LAUNCH(8, 1);
  if (ch <= 16) return CSR_LAUNCH(16, 1);
  if (ch <= 32) return CSR_LAUNCH(32, 1);
  if (ch <= 64) return CSR_LAUNCH(32, 2);
  if (ch <= 128) return CSR_LAUNCH(32, 4);
  if (ch <= 256) return CSR_LAUNCH(32, 8);
#undef CSR_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

// x [n_src, h] (bf16 when is_f32 == 0, else f32), idx [off[n_rows]] int32
// rows of x, off [n_rows + 1] int32; out [n_rows, h] of x's type, or with
// ``mean`` out_mean [n_rows, h] f32 (out unused). h % 8 == 0, h <= 1024.
extern "C" int csr_segment_sum(const void* x, const void* idx, const void* off,
                               void* out, void* out_mean, int n_rows, int h,
                               int is_f32, int mean, void* stream) {
  if (h <= 0 || h % 8 != 0 || h > kMaxH || n_rows < 0)
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
