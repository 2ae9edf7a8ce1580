// The unfused SAGE layer's epilogue, relu -> (+ skip) -> dropout, forward
// and backward, for Hopper (sm_90a): bf16 or f32, one elementwise pass each.
//
// Replaces the TPU kernels buckgnn_tpu/ops/pallas_epilogue.py::_fwd_kernel
// (forward, #8) and ::_bwd_kernel (backward, #9). Forward:
//
//     t = relu(c) (+ p)                  rounded to c's type
//     y = keep ? round(f32(t) * scale) : 0
//
// backward, from the cotangent g and the forward's input c alone:
//
//     dp = keep ? round(f32(g) * scale) : 0,   dc = c > 0 ? dp : 0.
//
// The TPU kernels draw their keep bits from the chip's generator per
// 1024-row tile and regenerate them in the backward. Here the bits are the
// port's keyed hash of (seed words, global row, column), sage_common.cuh::
// dropout_bits (ops/dropout.py::keep_mask is the same function), so the
// backward regenerates the forward's mask from the two seed words and no
// mask is stored. The scale multiplies in f32 and rounds once, as the JAX
// model's XLA epilogue does (ops/dropout.py:64-68 of the JAX package); the
// TPU kernel rounds the scale to bf16 first.
//
// What bounds it on an H100: a few integer operations per element and no
// product, so bytes: forward c, p read and y written, backward g, c read
// and dc, dp written, each 2 bytes an element in bf16 (at N = 102,982,
// H = 512: 316 MB, 0.094 ms; 421 MB, 0.126 ms at 3.35 TB/s). Each thread
// moves 16 bytes per operand per step of a grid-stride loop.

#include <cuda_bf16.h>
#include <stdint.h>

#include "pack16.cuh"
#include "sage_common.cuh"

namespace {

using pack16::Pack;

struct Drop {
  uint32_t thr, s0, s1;
  float scale;
};

// keep[e] of the E elements of row ``row`` from column col0 on
template <int E>
__device__ __forceinline__ void keep_bits(const Drop& d, uint32_t row,
                                          uint32_t col0, bool (&keep)[E]) {
  const uint32_t rk = sage::row_key(d.s0, row);
#pragma unroll
  for (int e = 0; e < E; ++e)
    keep[e] = sage::dropout_bits(rk, d.s1, col0 + e) < d.thr;
}

template <typename T, bool SKIP>
__global__ void epilogue_fwd_kernel(const T* __restrict__ c,
                                    const T* __restrict__ p,
                                    T* __restrict__ y, long long n_chunks,
                                    int h, Drop d) {
  constexpr int E = Pack<T>::N;
  const uint4* cv = reinterpret_cast<const uint4*>(c);
  const uint4* pv = reinterpret_cast<const uint4*>(p);
  uint4* yv = reinterpret_cast<uint4*>(y);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_chunks; i += (long long)gridDim.x * blockDim.x) {
    const long long at = i * E;
    float t[E], s[E];
    Pack<T>::unpack(__ldg(cv + i), t);
    if (SKIP) Pack<T>::unpack(__ldg(pv + i), s);
    bool keep[E];
    keep_bits<E>(d, (uint32_t)(at / h), (uint32_t)(at % h), keep);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      float v = t[e] <= 0.f ? 0.f : t[e];
      if (SKIP) v = Pack<T>::round(v + s[e]);
      t[e] = keep[e] ? v * d.scale : 0.f;
    }
    yv[i] = Pack<T>::pack(t);
  }
}

template <typename T, bool SKIP>
__global__ void epilogue_bwd_kernel(const T* __restrict__ g,
                                    const T* __restrict__ c,
                                    T* __restrict__ dc, T* __restrict__ dp,
                                    long long n_chunks, int h, Drop d) {
  constexpr int E = Pack<T>::N;
  const uint4* gv = reinterpret_cast<const uint4*>(g);
  const uint4* cv = reinterpret_cast<const uint4*>(c);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_chunks; i += (long long)gridDim.x * blockDim.x) {
    const long long at = i * E;
    float gm[E], cc[E];
    Pack<T>::unpack(__ldg(gv + i), gm);
    Pack<T>::unpack(__ldg(cv + i), cc);
    bool keep[E];
    keep_bits<E>(d, (uint32_t)(at / h), (uint32_t)(at % h), keep);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      gm[e] = keep[e] ? Pack<T>::round(gm[e] * d.scale) : 0.f;
      cc[e] = cc[e] > 0.f ? gm[e] : 0.f;
    }
    if (SKIP) reinterpret_cast<uint4*>(dp)[i] = Pack<T>::pack(gm);
    reinterpret_cast<uint4*>(dc)[i] = Pack<T>::pack(cc);
  }
}

constexpr int kThreads = 256;

int grid_for(long long n_chunks) {
  const long long want = (n_chunks + kThreads - 1) / kThreads;
  return (int)(want < 132 * 16 ? (want > 0 ? want : 1) : 132 * 16);
}

template <typename T>
cudaError_t fwd(const void* c, const void* p, void* y, long long n_chunks,
                int h, Drop d, cudaStream_t st) {
  const int grid = grid_for(n_chunks);
  const T* cp = static_cast<const T*>(c);
  if (p)
    epilogue_fwd_kernel<T, true><<<grid, kThreads, 0, st>>>(
        cp, static_cast<const T*>(p), static_cast<T*>(y), n_chunks, h, d);
  else
    epilogue_fwd_kernel<T, false><<<grid, kThreads, 0, st>>>(
        cp, nullptr, static_cast<T*>(y), n_chunks, h, d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd(const void* g, const void* c, void* dc, void* dp,
                long long n_chunks, int h, Drop d, cudaStream_t st) {
  const int grid = grid_for(n_chunks);
  const T* gp = static_cast<const T*>(g);
  const T* cp = static_cast<const T*>(c);
  if (dp)
    epilogue_bwd_kernel<T, true><<<grid, kThreads, 0, st>>>(
        gp, cp, static_cast<T*>(dc), static_cast<T*>(dp), n_chunks, h, d);
  else
    epilogue_bwd_kernel<T, false><<<grid, kThreads, 0, st>>>(
        gp, cp, static_cast<T*>(dc), nullptr, n_chunks, h, d);
  return cudaGetLastError();
}

}  // namespace

// c, p (null: no skip), y: [n, h] bf16 (is_f32 == 0) or f32; h % 8 == 0.
extern "C" int epilogue_fwd(const void* c, const void* p, void* y, long long n,
                            int h, int is_f32, uint32_t thr, uint32_t s0,
                            uint32_t s1, float scale, void* stream) {
  if (h <= 0 || h % 8 != 0 || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const Drop d{thr, s0, s1, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_f32) return (int)fwd<float>(c, p, y, n * h / 4, h, d, st);
  return (int)fwd<__nv_bfloat16>(c, p, y, n * h / 8, h, d, st);
}

// g, c, dc and dp (null: no skip): [n, h] of one type; h % 8 == 0.
extern "C" int epilogue_bwd(const void* g, const void* c, void* dc, void* dp,
                            long long n, int h, int is_f32, uint32_t thr,
                            uint32_t s0, uint32_t s1, float scale,
                            void* stream) {
  if (h <= 0 || h % 8 != 0 || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const Drop d{thr, s0, s1, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_f32) return (int)bwd<float>(g, c, dc, dp, n * h / 4, h, d, st);
  return (int)bwd<__nv_bfloat16>(g, c, dc, dp, n * h / 8, h, d, st);
}
