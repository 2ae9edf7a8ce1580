// The FFMA pieces that the float32 / any-width kernel variants share
// (sage_simple.cu: #1-#4; ea_simple.cu: #5, #6): element access in float32
// or bf16, the dropout words' row pass helpers and the product tile.
//
// gemm_kernel: C = A0 @ op(B0) (+ A1 @ op(B1)), then an epilogue, in full
// float32 FFMA (no TF32: wgmma takes tf32 operands K-major only, and one
// pass of TF32 keeps three digits) on 64 x 128 tiles, 256 threads of 4 x 8
// sums, 16-deep slices in shared memory with the next slice's loads in
// flight in registers. The epilogue is a type: `Store` (bias in the
// element type, an f32 add, a store in f32 or the element type, split-K
// partials by blockIdx.z) or a caller's own, which gets the thread's sums
// and the freed shared slice for block reductions. Rows of A and C past
// ``rows`` read as zeros and are not stored, and a split-K chunk's depth
// past the product's end reads as zeros, so M and the slot-row depths of
// A^T @ B need not be whole tiles; the other depths and N are.
// atb: dW = A^T @ B over a row range in chunks (blockIdx.z) into f32
// partials that sum_parts adds in chunk order. No float atomics: two runs
// give the same bits.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sage_common.cuh"

namespace simple {

typedef __nv_bfloat16 bf16;

// ---- element access: 4 or 8 neighbouring values as f32 ------------------

__device__ __forceinline__ float bf_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t w) {
  return __uint_as_float(w & 0xFFFF0000u);
}
__device__ __forceinline__ uint32_t pack2(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);  // a low, b high
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void ld4(const float* p, float (&o)[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void ld4(const bf16* p, float (&o)[4]) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  o[0] = bf_lo(v.x); o[1] = bf_hi(v.x); o[2] = bf_lo(v.y); o[3] = bf_hi(v.y);
}
__device__ __forceinline__ void ld8(const float* p, float (&o)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p + 4));
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
__device__ __forceinline__ void ld8(const bf16* p, float (&o)[8]) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  o[0] = bf_lo(v.x); o[1] = bf_hi(v.x); o[2] = bf_lo(v.y); o[3] = bf_hi(v.y);
  o[4] = bf_lo(v.z); o[5] = bf_hi(v.z); o[6] = bf_lo(v.w); o[7] = bf_hi(v.w);
}
// plain (coherent) loads, for tensors a kernel of the same call wrote
__device__ __forceinline__ void ld4c(const float* p, float (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void st4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void st4(bf16* p, const float (&v)[4]) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack2(v[0], v[1]),
                                            pack2(v[2], v[3]));
}

// ---- row passes ---------------------------------------------------------

constexpr int ROW_WARPS = 8;  // rows of a row-pass block, one warp each

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
  return v;
}

struct Drop {
  int on;
  uint32_t thr, s0, s1;
  float scale;
};

// ---- the products -------------------------------------------------------

constexpr int GBM = 64, GBN = 128, GBK = 16, GTHREADS = 256;

// C = A0 @ op(B0) (+ A1 @ op(B1)) then the epilogue; op(A)[m][k] = TA ?
// A[k][m] : A[m][k], op(B)[k][n] = TB ? B[n][k] : B[k][n]. M % 64 and N %
// 128 are 0, and so are the depths % 16 but product 0's of A^T (TA), whose
// chunk tail reads zeros. ``rows`` (0: M) ends the rows of A (not TA) and
// C. Split-K: block z sums product 0 over depths [z * kchunk, (z + 1) *
// kchunk) into C + z * zstride (f32).
struct Gemm {
  const void *a0, *b0, *a1, *b1;
  int lda0, ldb0, lda1, ldb1;
  int k0, k1, kchunk;
  int m, n;
  const void* bias;  // [N] in T, or null
  const float* add;  // [M, N] (ldc), or null
  void* c;
  int ldc, c_f32;
  size_t zstride;
  int rows;
};

// The plain epilogue: (+ bias) (+ add), stored in f32 (split-K partials
// by blockIdx.z) or T. ``Tag`` names the caller's pass in the kernel's
// name (profiles).
template <class Tag = void>
struct Store {
  template <typename T>
  __device__ __forceinline__ void operator()(const Gemm& g,
                                             float (&acc)[4][8], int m0,
                                             int n0, int ty, int tx,
                                             float (*)[GBN]) const {
    const int mv = g.rows ? g.rows : g.m;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + ty * 4 + i;
      if (row >= mv) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int col = n0 + half * 64 + tx * 4;
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = acc[i][half * 4 + j];
        if (g.bias) {
          float bv[4];
          ld4(static_cast<const T*>(g.bias) + col, bv);
#pragma unroll
          for (int j = 0; j < 4; ++j) v[j] += bv[j];
        }
        if (g.add) {
          float av[4];
          ld4c(g.add + (size_t)row * g.ldc + col, av);
#pragma unroll
          for (int j = 0; j < 4; ++j) v[j] += av[j];
        }
        if (g.c_f32) {
          st4(static_cast<float*>(g.c) + blockIdx.z * g.zstride +
                  (size_t)row * g.ldc + col, v);
        } else {
          st4(static_cast<T*>(g.c) + (size_t)row * g.ldc + col, v);
        }
      }
    }
  }
};

template <typename T, bool TA, bool TB, class Epi>
__global__ void __launch_bounds__(GTHREADS) gemm_kernel(Gemm g, Epi epi) {
  __shared__ __align__(16) float as[GBK][GBM];
  __shared__ __align__(16) float bs[GBK][GBN];
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int m0 = blockIdx.x * GBM, n0 = blockIdx.y * GBN;
  const int mv = g.rows ? g.rows : g.m;
  const int kb = blockIdx.z * g.kchunk;
  const int ke = min(g.k0, kb + g.kchunk);
  const int nt0 = ke > kb ? (ke - kb + GBK - 1) / GBK : 0;
  const int nt = nt0 + g.k1 / GBK;
  float ra[4], rb[8];

  auto load = [&](int kt) {
    const T* a;
    const T* b;
    int lda, ldb, k, kend;
    if (kt < nt0) {
      a = static_cast<const T*>(g.a0);
      b = static_cast<const T*>(g.b0);
      lda = g.lda0;
      ldb = g.ldb0;
      k = kb + kt * GBK;
      kend = ke;
    } else {
      a = static_cast<const T*>(g.a1);
      b = static_cast<const T*>(g.b1);
      lda = g.lda1;
      ldb = g.ldb1;
      k = (kt - nt0) * GBK;
      kend = g.k1;
    }
    // the depth row a thread reads of A^T and of B (not TB)
    const bool kin = k + (tid >> 4) < kend;
    if (TA) {
      if (kin) {
        ld4(a + (size_t)(k + (tid >> 4)) * lda + m0 + (tid & 15) * 4, ra);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) ra[i] = 0.f;
      }
    } else if (m0 + (tid >> 2) < mv) {
      ld4(a + (size_t)(m0 + (tid >> 2)) * lda + k + (tid & 3) * 4, ra);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) ra[i] = 0.f;
    }
    if (TB) {
      ld8(b + (size_t)(n0 + (tid >> 1)) * ldb + k + (tid & 1) * 8, rb);
    } else if (kin) {
      ld8(b + (size_t)(k + (tid >> 4)) * ldb + n0 + (tid & 15) * 8, rb);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) rb[i] = 0.f;
    }
  };
  auto store = [&]() {
    if (TA) {
      *reinterpret_cast<float4*>(&as[tid >> 4][(tid & 15) * 4]) =
          make_float4(ra[0], ra[1], ra[2], ra[3]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) as[(tid & 3) * 4 + i][tid >> 2] = ra[i];
    }
    if (TB) {
#pragma unroll
      for (int i = 0; i < 8; ++i) bs[(tid & 1) * 8 + i][tid >> 1] = rb[i];
    } else {
      float* d = &bs[tid >> 4][(tid & 15) * 8];
      *reinterpret_cast<float4*>(d) = make_float4(rb[0], rb[1], rb[2], rb[3]);
      *reinterpret_cast<float4*>(d + 4) =
          make_float4(rb[4], rb[5], rb[6], rb[7]);
    }
  };

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  if (nt > 0) load(0);
  for (int kt = 0; kt < nt; ++kt) {
    store();
    __syncthreads();
    if (kt + 1 < nt) load(kt + 1);
#pragma unroll
    for (int kk = 0; kk < GBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&bs[kk][64 + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  epi.template operator()<T>(g, acc, m0, n0, ty, tx, bs);
}

template <typename T, bool TA, bool TB, class Epi = Store<>>
cudaError_t gemm(const Gemm& g, int nz, cudaStream_t st, Epi epi = Epi()) {
  const int mv = g.rows ? g.rows : g.m;
  dim3 grid((mv + GBM - 1) / GBM, g.n / GBN, nz);
  gemm_kernel<T, TA, TB, Epi><<<grid, GTHREADS, 0, st>>>(g, epi);
  return cudaGetLastError();
}

// out[i] = sum over z of part[z * count + i], in z order
template <class Tag = void>
__global__ void sum_parts_kernel(const float* part, float* out, int nz,
                                 size_t count) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float s = 0.f;
  for (int z = 0; z < nz; ++z) s += part[(size_t)z * count + i];
  out[i] = s;
}

// dw [m, n] = a^T @ b over ``rows`` rows (a [rows, m] lda, b [rows, n]
// ldb): chunks of kchunk rows, then their partials in chunk order
template <typename T, class Tag = void>
cudaError_t atb_rows(const T* a, int lda, int m, const T* b, int ldb, int n,
                     int rows, int kchunk, float* part, float* dw,
                     cudaStream_t st) {
  const int nz = (rows + kchunk - 1) / kchunk;
  Gemm g = {};
  g.a0 = a;
  g.b0 = b;
  g.lda0 = lda;
  g.ldb0 = ldb;
  g.k0 = rows;
  g.kchunk = kchunk;
  g.m = m;
  g.n = n;
  g.c = part;
  g.ldc = n;
  g.c_f32 = 1;
  g.zstride = (size_t)m * n;
  cudaError_t e = gemm<T, true, false, Store<Tag>>(g, nz, st);
  if (e != cudaSuccess) return e;
  const size_t count = (size_t)m * n;
  sum_parts_kernel<Tag><<<(unsigned)((count + 255) / 256), 256, 0, st>>>(
      part, dw, nz, count);
  return cudaGetLastError();
}

// dw [H, H] = a^T @ b over n rows in ksplit chunks (whole 64-row blocks)
template <typename T>
cudaError_t atb(const T* a, const T* b, float* part, float* dw, int n, int h,
                int ksplit, cudaStream_t st) {
  int kchunk = (n + ksplit - 1) / ksplit;
  kchunk = (kchunk + GBM - 1) / GBM * GBM;
  return atb_rows<T>(a, h, h, b, h, h, n, kchunk, part, dw, st);
}

}  // namespace simple
