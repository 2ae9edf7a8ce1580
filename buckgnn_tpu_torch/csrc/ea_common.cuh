// Pieces shared by the fused EA block's forward and backward kernels
// (ea_block_fwd.cu, ea_block_bwd.cu).
//
// A block of 8 warps owns BM rows and the full output width; warp w owns
// the output columns [w * OUT/8, (w + 1) * OUT/8) and keeps their
// accumulators as wmma 16x16x16 bf16 fragments with f32 sums. A is
// row-major bf16 in shared or global memory; B is a weight in global
// memory (the [in, out] layout, read row-major) or its transpose (B(k, n)
// = W[n, k], read as a column-major fragment). Accumulators go to an f32
// staging tile in shared memory, where a warp per row applies the
// epilogue: a lane holds the column pairs q * 64 + 2 * lane.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "sage_common.cuh"

namespace ea {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;

constexpr int NWARP = 8;
constexpr int NTHREADS = NWARP * 32;
constexpr int ENC_IN = 8;     // raw edge-feature lanes (zero-padded)
constexpr int ENC_HID = 128;  // the edge encoder's padded hidden width

__host__ __device__ constexpr int lda_of(int w) { return w + 8; }  // bf16
__host__ __device__ constexpr int ldf_of(int w) { return w + 4; }  // f32

template <int MF, int NF>
__device__ __forceinline__ void zero(Acc (&acc)[MF][NF]) {
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[i][j], 0.f);
}

// acc[MF][NF] += A[MF*16, K] @ B[K, n0 : n0 + NF*16]. BT: B(k, n) =
// b[n * ldb + k] (a weight read transposed), else B(k, n) = b[k * ldb + n].
template <int MF, int NF, bool BT>
__device__ __forceinline__ void mma(Acc (&acc)[MF][NF], const bf16* a,
                                    int lda, const bf16* b, int ldb, int K,
                                    int n0) {
  for (int k0 = 0; k0 < K; k0 += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[MF];
#pragma unroll
    for (int i = 0; i < MF; ++i)
      wmma::load_matrix_sync(fa[i], a + (size_t)i * 16 * lda + k0, lda);
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      const int n = n0 + j * 16;
      if constexpr (BT) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fb, b + (size_t)n * ldb + k0, ldb);
#pragma unroll
        for (int i = 0; i < MF; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
      } else {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, b + (size_t)k0 * ldb + n, ldb);
#pragma unroll
        for (int i = 0; i < MF; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
      }
    }
  }
}

template <int MF, int NF>
__device__ __forceinline__ void store(Acc (&acc)[MF][NF], float* sf, int ldf,
                                      int n0) {
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j)
      wmma::store_matrix_sync(sf + (size_t)i * 16 * ldf + n0 + j * 16,
                              acc[i][j], ldf, wmma::mem_row_major);
}

// sf[BM, OUT] = A[BM, K] @ B (the whole block; ends synchronised)
template <int BM, int OUT, bool BT>
__device__ __forceinline__ void product(float* sf, const bf16* a, int lda,
                                        const bf16* b, int ldb, int K) {
  constexpr int NF = OUT / NWARP / 16;
  Acc acc[BM / 16][NF];
  zero(acc);
  const int n0 = (threadIdx.x / 32) * (OUT / NWARP);
  mma<BM / 16, NF, BT>(acc, a, lda, b, ldb, K, n0);
  store(acc, sf, ldf_of(OUT), n0);
  __syncthreads();
}

// sf[BM, OUT] = A1 @ B1 + A2 @ B2 in one accumulator chain
template <int BM, int OUT, bool BT>
__device__ __forceinline__ void product2(float* sf, const bf16* a1, int lda1,
                                         const bf16* b1, int ldb1, int K1,
                                         const bf16* a2, int lda2,
                                         const bf16* b2, int ldb2, int K2) {
  constexpr int NF = OUT / NWARP / 16;
  Acc acc[BM / 16][NF];
  zero(acc);
  const int n0 = (threadIdx.x / 32) * (OUT / NWARP);
  mma<BM / 16, NF, BT>(acc, a1, lda1, b1, ldb1, K1, n0);
  mma<BM / 16, NF, BT>(acc, a2, lda2, b2, ldb2, K2, n0);
  store(acc, sf, ldf_of(OUT), n0);
  __syncthreads();
}

__device__ __forceinline__ float2 ld2(const bf16* p) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
  return make_float2(__bfloat162float(v.x), __bfloat162float(v.y));
}

__device__ __forceinline__ void st2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// the bf16 rounding of v, as a float
__device__ __forceinline__ float rbf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

struct Drop {
  int on;
  uint32_t thr, s0, s1;
  float scale;
  // v of element (row, col) after the keep mask
  __device__ __forceinline__ float apply(float v, uint32_t rk, int col) const {
    return sage::dropout_bits(rk, s1, (uint32_t)col) < thr ? v * scale : 0.f;
  }
  __device__ __forceinline__ uint32_t key(uint32_t row) const {
    return sage::row_key(s0, row);
  }
};

// out[c] = sum over rows r < BM of sf[r, c] (times w[r] if w), in row
// order, for c < cols; zero for cols <= c < H
template <int BM>
__device__ __forceinline__ void colsum(const float* sf, int ldf, int cols,
                                       int H, const float* w, float* out) {
  for (int c = threadIdx.x; c < H; c += NTHREADS) {
    float s = 0.f;
    if (c < cols) {
      for (int r = 0; r < BM; ++r)
        s += w ? w[r] * sf[(size_t)r * ldf + c] : sf[(size_t)r * ldf + c];
    }
    out[c] = s;
  }
}

// dst[r, :H] = bf16 rows of src (global, ld = H) for rows < nvalid, zero
// rows after; 16-byte copies
template <int BM, int H>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          int nvalid) {
  constexpr int V = H / 8;
  for (int i = threadIdx.x; i < BM * V; i += NTHREADS) {
    const int r = i / V;
    const int c = (i % V) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < nvalid) v = *reinterpret_cast<const uint4*>(src + (size_t)r * H + c);
    *reinterpret_cast<uint4*>(dst + (size_t)r * lda_of(H) + c) = v;
  }
}

// the edge encoder's first two layers from the raw [BM, 8] window rows:
// h1 = bf16(relu(raw @ wen0 + b8)), h2 = bf16(relu(h1 @ wen1 + b9)), into
// sh1, sh2 [BM, lda_of(128)]; uses sf as staging. The first layer (K = 8)
// is f32 FMAs in k order.
template <int BM>
__device__ __forceinline__ void encoder_hidden(const bf16* raw, int f0, int e,
                                               const bf16* wen0,
                                               const bf16* wen1,
                                               const float* b8,
                                               const float* b9, bf16* sh1,
                                               bf16* sh2, float* sf) {
  constexpr int LD = lda_of(ENC_HID);
  for (int i = threadIdx.x; i < BM * ENC_HID; i += NTHREADS) {
    const int r = i / ENC_HID;
    const int c = i % ENC_HID;
    float s = 0.f;
    if (f0 + r < e) {
      const bf16* rr = raw + (size_t)(f0 + r) * ENC_IN;
#pragma unroll
      for (int k = 0; k < ENC_IN; ++k)
        s += __bfloat162float(rr[k]) * __bfloat162float(wen0[k * ENC_HID + c]);
    }
    s += b8[c];
    sh1[r * LD + c] = __float2bfloat16_rn(fmaxf(s, 0.f));
  }
  __syncthreads();
  product<BM, ENC_HID, false>(sf, sh1, LD, wen1, ENC_HID, ENC_HID);
  for (int i = threadIdx.x; i < BM * ENC_HID; i += NTHREADS) {
    const int r = i / ENC_HID;
    const int c = i % ENC_HID;
    sh2[r * LD + c] = __float2bfloat16_rn(
        fmaxf(sf[r * ldf_of(ENC_HID) + c] + b9[c], 0.f));
  }
  __syncthreads();
}

}  // namespace ea
