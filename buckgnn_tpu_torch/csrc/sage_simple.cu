// The float32 and any-width variants of the SAGE kernels for Hopper (sm_90a):
// the banded SpMM (#4), the fused layer's forward (#1), its merged backward
// (#2) and the split backward's tile kernel (#3), in float32 or bf16 at any
// H % 128 == 0, with f32 accumulation.
//
// Replace, for every (dtype, H) that the product engine does not take
// (ops/banded_matmul.py::kernel_variant: the engine takes bf16 at H in
// {128, 256, 512}), the TPU kernels
//   #4 buckgnn_tpu/ops/pallas_banded.py::_kernel (band_simple),
//   #1 buckgnn_tpu/ops/pallas_sage_layer.py::_fwd_kernel (sage_fwd_simple),
//   #2 buckgnn_tpu/ops/pallas_sage_layer.py::_bwd_merged_kernel
//      (sage_bwd_simple),
//   #3 buckgnn_tpu/ops/pallas_sage_layer.py::_bwd_kernel (sage_bwd_simple
//      without a band),
// which take any float x_dtype and any H % 128 == 0 with f32 accumulation
// (pallas_banded.py:84, 123-127; pallas_sage_layer.py:242, 604, 711). The
// engine kernels (sage_layer_fwd.cu, sage_layer_bwd.cu, banded_matmul.cu)
// stream bf16 x slabs and weights MN-major into wgmma, which takes tf32
// operands K-major only, so they cannot be templated to float32; these
// kernels are written for plain FFMA instead, in full float32 (no TF32).
//
// What each computes is what the engine kernel computes (their headers say
// it in full), with the same slab start s_t = clip(t*T - W/2, 0, N - (T+W)),
// spill window start (sage_common.cuh::spill_window_start), dropout words
// (sage_common.cuh::dropout_bits: keep when the word < thr, scale by
// `scale`, after relu and the skip) and star-table codes. Each TPU kernel
// becomes a few launches of four pieces:
//  - band_kernel: acc = band_t @ x[s_t : s_t+T+W] + the row's spill run
//    [lo, hi) of its message window + table[code] + acc_in, cast once to
//    the output type. One warp per row, lanes across 4-column groups: the
//    warp finds the row's nonzero band counts by ballot and adds count *
//    x[s_t + k] for those alone (the int8 counts are exact in either type),
//    so it does the data's multiply-adds, not the dense [T, T+W] product.
//    Sums run in the plain version's order of terms: band, spill, table,
//    acc. #4 alone; #1's phase 1 (agg = x_dtype(acc)); #2's band pass (dx =
//    x_dtype(band @ dagg slab + dxp)).
//  - gemm_kernel: C = A0 @ op(B0) (+ A1 @ op(B1)) (+ bias) (+ add), f32
//    FFMA on 64 x 128 tiles, 256 threads of 4 x 8 sums, 16-deep slices in
//    shared memory with the next slice's loads in flight in registers.
//    #1's out = agg @ W_l + x @ W_r + b_l (f32); the backward's dagg =
//    dout @ W_l^T and dxp = dout @ W_r^T (+ dz_eff); dW = [agg | x]^T @
//    dout split over row chunks (blockIdx.z) into f32 partials that
//    sum_parts adds in chunk order.
//  - row passes, one warp per row, looping over the row's columns, so any
//    H fits: #1's epilogue (sum of squares, inv, y, relu, skip, dropout,
//    z) and the backward's norm backward (dz_eff with the next layer's
//    star and the dropout mask, dy, s = rowsum(dy * y), dout). The row-wide
//    norm is split from the products because a row of H = 1024 f32 sums
//    does not fit one block's registers beside a product tile.
//  - code_sums: per 64-row block, the sums of a [N, H] tensor's rows by
//    code (each code's rows in row order), the partials that
//    sage_common.cuh::table_reduce_kernel adds in block order: #1's emitted
//    table (of z), #2's own table (of dagg), #3's (of dagg, global codes).
//    colsum_* adds db = colsum(dout) the same way, in two fixed-order
//    passes.
// No float atomics: two runs give the same bits.
//
// What bounds them on an H100: at the flagship shape (N = 103,424, H = 512,
// T + W = 320) #1 is 4 N H^2 = 108 GFLOP of f32 products (1.6 ms at the
// 67 TFLOP/s FFMA peak) beside the band's few nonzeros a row, and the
// backward twice that, so they are bound by operations; the band kernel
// alone is bound by bytes (x, the band, acc and out). This first version
// is simple: its product tile reaches a fraction of the FFMA peak (PERF.md
// has the times), and it is first in line for a redesign (3xTF32 on the
// tensor cores, or the engine's persistent ring).

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

// the table row that a row's code selects, or -1: with window bases
// (``gwin``) codes [0, gw) select rows wb.., [gw, 2gw) rows t0 + wb..;
// without, the code is the row and tg selects nothing
__device__ __forceinline__ int table_row(int code, const int* gwin, int t,
                                         int gw, int t0, int tg) {
  if (gwin == nullptr) return (code >= 0 && code < tg) ? code : -1;
  const int wb = gwin[t];
  if (code >= 0 && code < gw) return wb + code;
  if (code >= gw && code < 2 * gw) return t0 + wb + code - gw;
  return -1;
}

// ---- the band product (#4) ----------------------------------------------

constexpr int ROW_WARPS = 8;  // rows of a row-pass block, one warp each
constexpr int GROUP = 8;      // 128-column chunks a warp sums at once

struct BandP {
  const void* x;       // [N, H]
  const int8_t* band;  // [N, T+W]
  const void* msgs;    // [Es, H] spill messages, or null
  const int* off;      // [N/T + 1] spill offsets
  const int* lo;       // [N] first window column of each row
  const int* hi;       // [N] end window column of each row
  const int* code;     // [N] table codes, or null
  const int* gwin;     // [N/T] window bases, or null (code = table row)
  const void* table;   // [tg, H]
  const void* acc;     // [N, H] added last, or null
  void* out;           // [N, H]
  int n, h, tile, width, n_spill, tg, gw, t0;
};

template <typename T, typename O>
__global__ void __launch_bounds__(ROW_WARPS * 32) band_kernel(BandP p) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * ROW_WARPS + (threadIdx.x >> 5);
  if (r >= p.n) return;
  const int s_len = p.tile + p.width;
  const int t = r / p.tile;
  const int hi_start = p.n - s_len > 0 ? p.n - s_len : 0;
  const int start = min(max(t * p.tile - p.width / 2, 0), hi_start);
  const T* x = static_cast<const T*>(p.x);
  const int8_t* brow = p.band + (size_t)r * s_len;
  int ws = 0, mlo = 0, mhi = 0;
  if (p.msgs) {
    ws = sage::spill_window_start(p.off[t], p.n_spill);
    mlo = p.lo[r];
    mhi = p.hi[r];
  }
  const int trow = p.code ? table_row(p.code[r], p.gwin, t, p.gw, p.t0, p.tg)
                          : -1;
  for (int c0 = 0; c0 < p.h; c0 += GROUP * 128) {
    const int nch = min(GROUP, (p.h - c0) / 128);
    const int col = c0 + lane * 4;
    float acc[GROUP][4];
#pragma unroll
    for (int q = 0; q < GROUP; ++q)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[q][i] = 0.f;
    for (int k0 = 0; k0 < s_len; k0 += 32) {
      const int k = k0 + lane;
      const int v = k < s_len ? (int)brow[k] : 0;
      unsigned m = __ballot_sync(0xFFFFFFFFu, v != 0);
      while (m) {
        const int j = __ffs(m) - 1;
        m &= m - 1;
        const float cnt = (float)__shfl_sync(0xFFFFFFFFu, v, j);
        const T* xr = x + (size_t)(start + k0 + j) * p.h + col;
#pragma unroll
        for (int q = 0; q < GROUP; ++q) {
          if (q < nch) {
            float xv[4];
            ld4(xr + q * 128, xv);
#pragma unroll
            for (int i = 0; i < 4; ++i)
              acc[q][i] = fmaf(cnt, xv[i], acc[q][i]);
          }
        }
      }
    }
    if (mhi > mlo) {
      // the row's spill run, summed on its own in message order
      const T* msgs = static_cast<const T*>(p.msgs);
      float sp[GROUP][4];
#pragma unroll
      for (int q = 0; q < GROUP; ++q)
#pragma unroll
        for (int i = 0; i < 4; ++i) sp[q][i] = 0.f;
      for (int mm = mlo; mm < mhi; ++mm) {
        const T* mr = msgs + (size_t)(ws + mm) * p.h + col;
#pragma unroll
        for (int q = 0; q < GROUP; ++q) {
          if (q < nch) {
            float mv[4];
            ld4(mr + q * 128, mv);
#pragma unroll
            for (int i = 0; i < 4; ++i) sp[q][i] += mv[i];
          }
        }
      }
#pragma unroll
      for (int q = 0; q < GROUP; ++q)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[q][i] += sp[q][i];
    }
    O* out = static_cast<O*>(p.out) + (size_t)r * p.h + col;
#pragma unroll
    for (int q = 0; q < GROUP; ++q) {
      if (q < nch) {
        float v[4];
        if (trow >= 0) {
          ld4(static_cast<const T*>(p.table) + (size_t)trow * p.h + col +
                  q * 128, v);
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[q][i] += v[i];
        }
        if (p.acc) {
          ld4(static_cast<const T*>(p.acc) + (size_t)r * p.h + col + q * 128,
              v);
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[q][i] += v[i];
        }
        st4(out + q * 128, acc[q]);
      }
    }
  }
}

template <typename T, typename O>
cudaError_t launch_band(const BandP& p, cudaStream_t st) {
  band_kernel<T, O><<<(p.n + ROW_WARPS - 1) / ROW_WARPS, ROW_WARPS * 32, 0,
                      st>>>(p);
  return cudaGetLastError();
}

cudaError_t band(const BandP& p, bool bf, bool out_f32, cudaStream_t st) {
  if (bf) {
    return out_f32 ? launch_band<bf16, float>(p, st)
                   : launch_band<bf16, bf16>(p, st);
  }
  return out_f32 ? launch_band<float, float>(p, st)
                 : launch_band<float, bf16>(p, st);
}

// ---- the products -------------------------------------------------------

constexpr int GBM = 64, GBN = 128, GBK = 16, GTHREADS = 256;

// C = A0 @ op(B0) (+ A1 @ op(B1)) (+ bias) (+ add); op(A)[m][k] = TA ?
// A[k][m] : A[m][k], op(B)[k][n] = TB ? B[n][k] : B[k][n]. M % 64, N % 128
// and the depths % 16 are 0. Split-K: block z sums product 0 over depths
// [z * kchunk, (z + 1) * kchunk) into C + z * zstride (f32).
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
};

template <typename T, bool TA, bool TB>
__global__ void __launch_bounds__(GTHREADS) gemm_kernel(Gemm g) {
  __shared__ __align__(16) float as[GBK][GBM];
  __shared__ __align__(16) float bs[GBK][GBN];
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int m0 = blockIdx.x * GBM, n0 = blockIdx.y * GBN;
  const int kb = blockIdx.z * g.kchunk;
  const int ke = min(g.k0, kb + g.kchunk);
  const int nt0 = ke > kb ? (ke - kb) / GBK : 0;
  const int nt = nt0 + g.k1 / GBK;
  float ra[4], rb[8];

  auto load = [&](int kt) {
    const T* a;
    const T* b;
    int lda, ldb, k;
    if (kt < nt0) {
      a = static_cast<const T*>(g.a0);
      b = static_cast<const T*>(g.b0);
      lda = g.lda0;
      ldb = g.ldb0;
      k = kb + kt * GBK;
    } else {
      a = static_cast<const T*>(g.a1);
      b = static_cast<const T*>(g.b1);
      lda = g.lda1;
      ldb = g.ldb1;
      k = (kt - nt0) * GBK;
    }
    if (TA) {
      ld4(a + (size_t)(k + (tid >> 4)) * lda + m0 + (tid & 15) * 4, ra);
    } else {
      ld4(a + (size_t)(m0 + (tid >> 2)) * lda + k + (tid & 3) * 4, ra);
    }
    if (TB) {
      ld8(b + (size_t)(n0 + (tid >> 1)) * ldb + k + (tid & 1) * 8, rb);
    } else {
      ld8(b + (size_t)(k + (tid >> 4)) * ldb + n0 + (tid & 15) * 8, rb);
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

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
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

template <typename T, bool TA, bool TB>
cudaError_t gemm(const Gemm& g, int nz, cudaStream_t st) {
  dim3 grid(g.m / GBM, g.n / GBN, nz);
  gemm_kernel<T, TA, TB><<<grid, GTHREADS, 0, st>>>(g);
  return cudaGetLastError();
}

// out[i] = sum over z of part[z * count + i], in z order
__global__ void sum_parts_kernel(const float* part, float* out, int nz,
                                 size_t count) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float s = 0.f;
  for (int z = 0; z < nz; ++z) s += part[(size_t)z * count + i];
  out[i] = s;
}

// dw [H, H] = a^T @ b over n rows: nz chunks of kchunk rows, then their
// partials in chunk order
template <typename T>
cudaError_t atb(const T* a, const T* b, float* part, float* dw, int n, int h,
                int ksplit, cudaStream_t st) {
  int kchunk = (n + ksplit - 1) / ksplit;
  kchunk = (kchunk + GBM - 1) / GBM * GBM;
  const int nz = (n + kchunk - 1) / kchunk;
  Gemm g = {};
  g.a0 = a;
  g.b0 = b;
  g.lda0 = h;
  g.ldb0 = h;
  g.k0 = n;
  g.kchunk = kchunk;
  g.m = h;
  g.n = h;
  g.c = part;
  g.ldc = h;
  g.c_f32 = 1;
  g.zstride = (size_t)h * h;
  cudaError_t e = gemm<T, true, false>(g, nz, st);
  if (e != cudaSuccess) return e;
  const size_t count = (size_t)h * h;
  sum_parts_kernel<<<(unsigned)((count + 255) / 256), 256, 0, st>>>(
      part, dw, nz, count);
  return cudaGetLastError();
}

// ---- row passes ---------------------------------------------------------

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

// #1's epilogue on out = agg @ W_l + x @ W_r + b_l (f32): y = out * inv,
// inv = rsqrt(max(sum(out^2), 1e-24)), z = T(dropout(relu(y) (+ x))), and
// with save_res y in T and inv
template <typename T>
__global__ void __launch_bounds__(ROW_WARPS * 32) fwd_rows_kernel(
    const float* out, const T* x, T* z, T* y_out, float* inv_out, int n,
    int h, int skip, Drop d) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * ROW_WARPS + (threadIdx.x >> 5);
  if (r >= n) return;
  const float* o = out + (size_t)r * h;
  float ss = 0.f;
  for (int c = lane * 4; c < h; c += 128) {
    float v[4];
    ld4c(o + c, v);
#pragma unroll
    for (int i = 0; i < 4; ++i) ss = fmaf(v[i], v[i], ss);
  }
  ss = warp_sum(ss);
  const float inv = rsqrtf(fmaxf(ss, 1e-24f));
  const uint32_t rk = sage::row_key(d.s0, (uint32_t)r);
  for (int c = lane * 4; c < h; c += 128) {
    float v[4], yv[4], zv[4];
    ld4c(o + c, v);
    float xv[4] = {0.f, 0.f, 0.f, 0.f};
    if (skip) ld4(x + (size_t)r * h + c, xv);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      yv[i] = v[i] * inv;
      float q = yv[i] > 0.f ? yv[i] : 0.f;
      if (skip) q += xv[i];
      if (d.on) {
        q = sage::dropout_bits(rk, d.s1, (uint32_t)(c + i)) < d.thr
                ? q * d.scale : 0.f;
      }
      zv[i] = q;
    }
    st4(z + (size_t)r * h + c, zv);
    if (y_out) st4(y_out + (size_t)r * h + c, yv);
  }
  if (inv_out && lane == 0) inv_out[r] = inv;
}

// the backward's norm backward: dz_eff = dropout(dz (+ table_prev[code])),
// dy = dz_eff where y > 0, dout = (dy - y * rowsum(dy * y)) * inv; writes
// dout in T, in f32 (dout32, for db, when T is not f32) and dz_eff (skip)
template <typename T>
__global__ void __launch_bounds__(ROW_WARPS * 32) bwd_rows_kernel(
    const T* dz, const T* y, const float* inv, const T* table_prev,
    const int* code, const int* gwin, int tile, int gw, int t0, int tg,
    T* dout, float* dout32, float* dzeff, int n, int h, Drop d) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * ROW_WARPS + (threadIdx.x >> 5);
  if (r >= n) return;
  const int trow =
      table_prev ? table_row(code[r], gwin, r / tile, gw, t0, tg) : -1;
  const uint32_t rk = sage::row_key(d.s0, (uint32_t)r);
  auto dz_eff = [&](int c, float (&e)[4]) {
    ld4(dz + (size_t)r * h + c, e);
    if (trow >= 0) {
      float tv[4];
      ld4(table_prev + (size_t)trow * h + c, tv);
#pragma unroll
      for (int i = 0; i < 4; ++i) e[i] += tv[i];
    }
    if (d.on) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        e[i] = sage::dropout_bits(rk, d.s1, (uint32_t)(c + i)) < d.thr
                   ? e[i] * d.scale : 0.f;
    }
  };
  float s = 0.f;
  for (int c = lane * 4; c < h; c += 128) {
    float e[4], yv[4];
    dz_eff(c, e);
    ld4(y + (size_t)r * h + c, yv);
#pragma unroll
    for (int i = 0; i < 4; ++i) s = fmaf(yv[i] > 0.f ? e[i] : 0.f, yv[i], s);
  }
  s = warp_sum(s);
  const float iv = inv[r];
  for (int c = lane * 4; c < h; c += 128) {
    float e[4], yv[4], o[4];
    dz_eff(c, e);
    ld4(y + (size_t)r * h + c, yv);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float dy = yv[i] > 0.f ? e[i] : 0.f;
      o[i] = (dy - yv[i] * s) * iv;
    }
    st4(dout + (size_t)r * h + c, o);
    if (dout32) st4(dout32 + (size_t)r * h + c, o);
    if (dzeff) st4(dzeff + (size_t)r * h + c, e);
  }
}

// ---- sums by code and by column -----------------------------------------

constexpr int CB = 64;  // rows of a code-sum block (table_reduce's blocks)

// part[b, c, col] = sum over rows r of block b with codes[r] == c of v[r,
// col], in row order, for c in [0, ncode)
template <typename T>
__global__ void __launch_bounds__(128) code_sums_kernel(
    const T* v, const int* codes, float* part, int ncode, int h) {
  __shared__ int sc[CB];
  const int b = blockIdx.x;
  const int col = blockIdx.y * 128 + threadIdx.x;
  if (threadIdx.x < CB) sc[threadIdx.x] = codes[b * CB + threadIdx.x];
  __syncthreads();
  float* out = part + (size_t)b * ncode * h + col;
  const T* vb = v + (size_t)b * CB * h + col;
  for (int c = 0; c < ncode; ++c) {
    float s = 0.f;
    for (int r = 0; r < CB; ++r) {
      if (sc[r] == c) s += to_f(vb[(size_t)r * h]);
    }
    out[(size_t)c * h] = s;
  }
}

// the table of a code sum: partials by block, then table_reduce's fixed
// order over the tiles whose window holds each table row
template <typename T>
cudaError_t table_sum(const T* v, const int* codes, const int* gwin,
                      float* part, float* table, int n, int h, int tile,
                      int gw, int t0, int tg, int ncode, cudaStream_t st) {
  code_sums_kernel<T><<<dim3(n / CB, h / 128), 128, 0, st>>>(v, codes, part,
                                                             ncode, h);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dim3 grid((h + 255) / 256, tg);
  sage::table_reduce_kernel<<<grid, 256, 0, st>>>(part, gwin, table,
                                                  n / tile, tile / CB, gw,
                                                  t0, h);
  return cudaGetLastError();
}

constexpr int COL_ROWS = 256;  // rows of a column-sum chunk

__global__ void colsum_part_kernel(const float* v, float* part, int n,
                                   int h) {
  const int col = blockIdx.y * 128 + threadIdx.x;
  const int r0 = blockIdx.x * COL_ROWS;
  const int r1 = min(n, r0 + COL_ROWS);
  float s = 0.f;
  for (int r = r0; r < r1; ++r) s += v[(size_t)r * h + col];
  part[(size_t)blockIdx.x * h + col] = s;
}

// db [H] = sum over rows of v [N, H] f32: chunk sums, then in chunk order
cudaError_t colsum(const float* v, float* part, float* out, int n, int h,
                   cudaStream_t st) {
  const int nc = (n + COL_ROWS - 1) / COL_ROWS;
  colsum_part_kernel<<<dim3(nc, h / 128), 128, 0, st>>>(v, part, n, h);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  sum_parts_kernel<<<(h + 255) / 256, 256, 0, st>>>(part, out, nc,
                                                    (size_t)h);
  return cudaGetLastError();
}

// ---- the layer ----------------------------------------------------------

struct FwdArgs {
  const void *x, *w_l, *w_r, *b_l, *table, *msgs;
  const int8_t* band;
  const int *code, *gwin, *acc_code, *off, *lo, *hi;
  void *agg, *z, *y, *ftab;
  float *out32, *inv, *partial;
  int n, h, tile, width, gw, t0, tg, n_spill, has_super, has_spill, skip,
      emit;
  Drop d;
};

template <typename T>
cudaError_t fwd(const FwdArgs& a, cudaStream_t st) {
  BandP p = {};
  p.x = a.x;
  p.band = a.band;
  if (a.has_spill) {
    p.msgs = a.msgs;
    p.off = a.off;
    p.lo = a.lo;
    p.hi = a.hi;
  }
  if (a.has_super) {
    p.code = a.code;
    p.gwin = a.gwin;
    p.table = a.table;
  }
  p.out = a.agg;
  p.n = a.n;
  p.h = a.h;
  p.tile = a.tile;
  p.width = a.width;
  p.n_spill = a.n_spill;
  p.tg = a.tg;
  p.gw = a.gw;
  p.t0 = a.t0;
  cudaError_t e = launch_band<T, T>(p, st);
  if (e != cudaSuccess) return e;
  Gemm g = {};
  g.a0 = a.agg;
  g.b0 = a.w_l;
  g.a1 = a.x;
  g.b1 = a.w_r;
  g.lda0 = g.ldb0 = g.lda1 = g.ldb1 = a.h;
  g.k0 = g.k1 = g.kchunk = a.h;
  g.m = a.n;
  g.n = a.h;
  g.bias = a.b_l;
  g.c = a.out32;
  g.ldc = a.h;
  g.c_f32 = 1;
  e = gemm<T, false, false>(g, 1, st);
  if (e != cudaSuccess) return e;
  fwd_rows_kernel<T><<<(a.n + ROW_WARPS - 1) / ROW_WARPS, ROW_WARPS * 32, 0,
                       st>>>(a.out32, static_cast<const T*>(a.x),
                             static_cast<T*>(a.z), static_cast<T*>(a.y),
                             a.inv, a.n, a.h, a.skip, a.d);
  e = cudaGetLastError();
  if (e != cudaSuccess || !a.emit) return e;
  return table_sum<T>(static_cast<const T*>(a.z), a.acc_code, a.gwin,
                      a.partial, static_cast<float*>(a.ftab), a.n, a.h,
                      a.tile, a.gw, a.t0, a.tg, 2 * a.gw, st);
}

struct BwdArgs {
  const void *dz, *y, *agg, *x, *w_l, *w_r, *table_prev;
  const float* inv;
  const int8_t* band;  // merged: the band pass; null: the tile kernel
  const int *code, *gwin, *acc_code;
  void *dout, *dagg, *dxp, *dx;
  float *dout32, *dzeff, *dw_part, *dwl, *dwr, *db_part, *dbl, *t_part,
      *town;
  int n, h, tile, width, gw, t0, tg, has_super, skip, ksplit;
  Drop d;
};

template <typename T>
cudaError_t bwd(const BwdArgs& a, cudaStream_t st) {
  const int n = a.n, h = a.h;
  const bool merged = a.band != nullptr;
  bwd_rows_kernel<T><<<(n + ROW_WARPS - 1) / ROW_WARPS, ROW_WARPS * 32, 0,
                       st>>>(
      static_cast<const T*>(a.dz), static_cast<const T*>(a.y), a.inv,
      static_cast<const T*>(a.table_prev), a.code, a.gwin, a.tile, a.gw, a.t0,
      a.tg, static_cast<T*>(a.dout), a.dout32, a.skip ? a.dzeff : nullptr, n,
      h, a.d);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  // dagg = dout @ W_l^T, dxp = dout @ W_r^T (+ dz_eff)
  Gemm g = {};
  g.a0 = a.dout;
  g.lda0 = g.ldb0 = h;
  g.k0 = g.kchunk = h;
  g.m = n;
  g.n = h;
  g.ldc = h;
  g.b0 = a.w_l;
  g.c = a.dagg;
  e = gemm<T, false, true>(g, 1, st);
  if (e != cudaSuccess) return e;
  g.b0 = a.w_r;
  g.add = a.skip ? a.dzeff : nullptr;
  g.c = a.dxp;
  e = gemm<T, false, true>(g, 1, st);
  if (e != cudaSuccess) return e;
  // dW_l = agg^T @ dout, dW_r = x^T @ dout, db = colsum(dout) in f32
  const T* dout = static_cast<const T*>(a.dout);
  e = atb<T>(static_cast<const T*>(a.agg), dout, a.dw_part, a.dwl, n, h,
             a.ksplit, st);
  if (e != cudaSuccess) return e;
  e = atb<T>(static_cast<const T*>(a.x), dout, a.dw_part, a.dwr, n, h,
             a.ksplit, st);
  if (e != cudaSuccess) return e;
  const float* d32 = a.dout32 ? a.dout32 : static_cast<const float*>(a.dout);
  e = colsum(d32, a.db_part, a.dbl, n, h, st);
  if (e != cudaSuccess) return e;
  if (a.has_super) {
    // the own table of dagg: the local windows (merged) or the whole table
    // by global codes (the tile kernel)
    e = merged ? table_sum<T>(static_cast<const T*>(a.dagg), a.acc_code,
                              a.gwin, a.t_part, a.town, n, h, a.tile, a.gw,
                              a.t0, a.tg, 2 * a.gw, st)
               : table_sum<T>(static_cast<const T*>(a.dagg), a.acc_code,
                              nullptr, a.t_part, a.town, n, h, a.tile,
                              a.tg / 2, a.tg / 2, a.tg, a.tg, st);
    if (e != cudaSuccess) return e;
  }
  if (!merged) return cudaSuccess;
  // dx = T(band @ dagg slab + dxp)
  BandP p = {};
  p.x = a.dagg;
  p.band = a.band;
  p.acc = a.dxp;
  p.out = a.dx;
  p.n = n;
  p.h = h;
  p.tile = a.tile;
  p.width = a.width;
  return launch_band<T, T>(p, st);
}

}  // namespace simple

extern "C" int band_simple(const void* x, const void* band, const void* msgs,
                           const void* off, const void* lo, const void* hi,
                           const void* code, const void* gwin,
                           const void* table, const void* acc, void* out,
                           int n, int h, int tile, int width, int n_spill,
                           int tg, int gw, int t0, int bf16_in, int out_f32,
                           void* stream) {
  simple::BandP p = {};
  p.x = x;
  p.band = static_cast<const int8_t*>(band);
  p.msgs = msgs;
  p.off = static_cast<const int*>(off);
  p.lo = static_cast<const int*>(lo);
  p.hi = static_cast<const int*>(hi);
  p.code = static_cast<const int*>(code);
  p.gwin = static_cast<const int*>(gwin);
  p.table = table;
  p.acc = acc;
  p.out = out;
  p.n = n;
  p.h = h;
  p.tile = tile;
  p.width = width;
  p.n_spill = n_spill;
  p.tg = tg;
  p.gw = gw;
  p.t0 = t0;
  return (int)simple::band(p, bf16_in != 0, out_f32 != 0,
                           static_cast<cudaStream_t>(stream));
}

extern "C" int sage_fwd_simple(
    const void* x, const void* band, const void* w_l, const void* w_r,
    const void* b_l, const void* table, const void* code, const void* gwin,
    const void* acc_code, const void* msgs, const void* spill_off,
    const void* spill_lo, const void* spill_hi, void* agg, void* out32,
    void* z, void* y, void* inv, void* partial, void* ftab, int n, int h,
    int tile, int width, int gw, int t0, int tg, int has_super, int skip,
    int emit, int n_spill, int has_spill, int dropout, unsigned int thr,
    unsigned int s0, unsigned int s1, float scale, int bf16_in,
    void* stream) {
  simple::FwdArgs a = {};
  a.x = x;
  a.band = static_cast<const int8_t*>(band);
  a.w_l = w_l;
  a.w_r = w_r;
  a.b_l = b_l;
  a.table = table;
  a.code = static_cast<const int*>(code);
  a.gwin = static_cast<const int*>(gwin);
  a.acc_code = static_cast<const int*>(acc_code);
  a.msgs = msgs;
  a.off = static_cast<const int*>(spill_off);
  a.lo = static_cast<const int*>(spill_lo);
  a.hi = static_cast<const int*>(spill_hi);
  a.agg = agg;
  a.out32 = static_cast<float*>(out32);
  a.z = z;
  a.y = y;
  a.inv = static_cast<float*>(inv);
  a.partial = static_cast<float*>(partial);
  a.ftab = ftab;
  a.n = n;
  a.h = h;
  a.tile = tile;
  a.width = width;
  a.gw = gw;
  a.t0 = t0;
  a.tg = tg;
  a.n_spill = n_spill;
  a.has_super = has_super;
  a.has_spill = has_spill;
  a.skip = skip;
  a.emit = emit;
  a.d = {dropout, thr, s0, s1, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(bf16_in ? simple::fwd<simple::bf16>(a, st)
                       : simple::fwd<float>(a, st));
}

// #2's variant, the merged backward ending in the band pass for dx; with
// ``band`` null #3's, the split backward's tile kernel (no band pass, no
// next layer's table: the caller folds it into dz), its own table over
// the whole [tg, H] table by global codes
extern "C" int sage_bwd_simple(
    const void* dz, const void* y, const void* inv, const void* agg,
    const void* x, const void* w_l, const void* w_r, const void* band,
    const void* table_prev, const void* code, const void* gwin,
    const void* acc_code, void* dout, void* dout32, void* dzeff, void* dagg,
    void* dxp, void* dx, void* dw_part, void* dwl, void* dwr, void* db_part,
    void* dbl, void* t_part, void* town, int n, int h, int tile, int width,
    int gw, int t0, int tg, int has_super, int skip, int ksplit, int dropout,
    unsigned int thr, unsigned int s0, unsigned int s1, float scale,
    int bf16_in, void* stream) {
  simple::BwdArgs a = {};
  a.dz = dz;
  a.y = y;
  a.inv = static_cast<const float*>(inv);
  a.agg = agg;
  a.x = x;
  a.w_l = w_l;
  a.w_r = w_r;
  a.band = static_cast<const int8_t*>(band);
  a.table_prev = table_prev;
  a.code = static_cast<const int*>(code);
  a.gwin = static_cast<const int*>(gwin);
  a.acc_code = static_cast<const int*>(acc_code);
  a.dout = dout;
  a.dout32 = static_cast<float*>(dout32);
  a.dzeff = static_cast<float*>(dzeff);
  a.dagg = dagg;
  a.dxp = dxp;
  a.dx = dx;
  a.dw_part = static_cast<float*>(dw_part);
  a.dwl = static_cast<float*>(dwl);
  a.dwr = static_cast<float*>(dwr);
  a.db_part = static_cast<float*>(db_part);
  a.dbl = static_cast<float*>(dbl);
  a.t_part = static_cast<float*>(t_part);
  a.town = static_cast<float*>(town);
  a.n = n;
  a.h = h;
  a.tile = tile;
  a.width = width;
  a.gw = gw;
  a.t0 = t0;
  a.tg = tg;
  a.has_super = has_super;
  a.skip = skip;
  a.ksplit = ksplit;
  a.d = {dropout, thr, s0, s1, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(bf16_in ? simple::bwd<simple::bf16>(a, st)
                       : simple::bwd<float>(a, st));
}

