// The pieces that the float32 / any-width kernel variants share
// (sage_simple.cu: #1-#4; ea_simple.cu: #5, #6): element access in float32
// or bf16, the dropout words' row pass helpers and the product tile.
//
// Which tile takes which product: wtile.cuh's weight tile every product
// of the SAGE variants (#1's [agg | x] @ [W_l; W_r], #2s's and #3s's
// dagg | dxp = dout @ [W_l^T | W_r^T] and their weight pass [agg | x]^T
// @ dout) and every product of #5 and #6 whose B is a weight, as stored
// (#5's, #6's recomputed forward chain) or transposed (#6's dz @ W^T),
// from B pre-split once a call; this file's gemm_kernel #6's weight
// passes (A^T @ B, `atb_rows`).
//
// gemm_kernel: C = A0 @ op(B0) (+ A1 @ op(B1)), then an epilogue, on the
// tensor cores in 3xTF32. One pass of TF32 keeps about 2^-11 of each
// operand, too little for the float32 gate (ops/banded_matmul.py::
// SIMPLE_F32_TOL); so each float32 operand x is split once, as it is
// loaded, into hi = tf32(x) and lo = tf32(x - hi) (cvt.rna), which keep
// about 2^-22 of it together, and the wgmma products lo.hi + hi.lo +
// hi.hi go into the sums (lo.lo, about 2^-22 of the product, is left
// out). A bf16 value is a tf32 value (lo = 0): bf16 operands take the
// hi.hi pass alone. wgmma takes tf32 only K-major: the split writes both
// parts K-major in the 128-byte swizzle (hopper.cuh::sw128), so A^T (the
// weight pass's A) and B [K, N] (not TB) are transposed on the way in, a
// thread a row. A block of three warpgroups owns a 128 x 128 tile of C in
// 32-deep slices through a ring of 3 (float32) or 4 (bf16) stages:
//  - the producer warpgroup loads B's slices two ahead into registers and
//    splits each into a stage once both consumers have freed it (mbarriers
//    full and empty);
//  - consumer warpgroup c owns rows 64 c.. of the tile: it loads its rows
//    of A's next slice, issues the slice's 12 wgmma m64n128k8 (bf16: 4)
//    into a slice sum, splits the next slice's A rows into the next stage
//    while they run, then adds the slice sum into its float32 sums with a
//    round-to-nearest add. The tensor cores' own sums are not rounded to
//    nearest: over the hundreds of products of a deep sum their error
//    grows with the depth, past the gate for a 2,048-row chunk of dW; a
//    slice's 12 stay inside it.
// Then both consumers stage their sums in the ring, and the epilogue, a
// type, reads them a row at a time (`Rows`: a warp a row, 4 columns a
// lane), BATCH rows' loads in flight at once: `Store` (bias in the element
// type, an f32 add, a store in f32 or the element type, split-K partials
// by chunk, `Rows::z`: here blockIdx.z) or a caller's own, which sums columns over its 64 rows
// with `half_colsum`. Rows of A and C past ``rows`` read as zeros and are
// not stored, and a split-K chunk's depth past the product's end reads as
// zeros, so M and the slot-row depths of A^T @ B need not be whole tiles;
// the other depths (32) and N (128) are. What bounds it on an H100: the
// shared-memory pipe before the tensor cores. Each slice's 24 wgmma read
// 144 KB of operands, the splits write 64 KB and the loads pass 32 KB
// through L1, against the tensor cores' 3 tf32 products for each float32
// one at 495 TFLOP/s (165 TFLOP/s of float32 products); PERF.md has the
// rates.
// atb_rows: dW = A^T @ B over a row range in chunks (blockIdx.z) into f32
// partials that sum_parts adds in chunk order. No float atomics: two runs
// give the same bits.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "sage_common.cuh"

namespace simple {

typedef __nv_bfloat16 bf16;

// ---- element access: 2 or 4 neighbouring values as f32 ------------------

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

constexpr int GBM = 128, GBN = 128;  // a block's tile of C
constexpr int GBK = 32;              // depth of a ring slice
constexpr int HALF = 64;    // rows of a consumer warpgroup (a column-sum block)
constexpr int GTHREADS = 384;  // the producer warpgroup, then two consumers
constexpr int SLICE = GBM * GBK * 4;  // bytes of one tf32 part of an operand
constexpr int STG = GBN + 8;  // row stride (floats) of the staged sums
constexpr int BATCH = 4;      // rows whose loads an epilogue issues together

// the ring of element type T: STAGES slices, each A's tf32 parts (hi, and
// lo for float32; rows 64 c.. are consumer c's) then B's, [128, 32] each
// in the 128-byte swizzle; then the barriers. Once both consumers are done
// with the ring it holds their staged sums and column-sum scratch.
template <typename T>
struct Ring {
  static constexpr int PARTS = sizeof(T) == 4 ? 2 : 1;
  static constexpr int STAGES = sizeof(T) == 4 ? 3 : 4;
  static constexpr int STAGE = 2 * PARTS * SLICE;
  static constexpr int EPI = 2 * HALF * STG * 4 + 2 * 4 * GBN * 4;
  static constexpr int SMEM = 1024 + STAGES * STAGE + 2 * STAGES * 8;
  static_assert(STAGES * STAGE >= EPI, "the staged sums fit the ring");
  static_assert(SMEM <= 232448, "a block's shared memory on an H100");
};

// C = A0 @ op(B0) (+ A1 @ op(B1)) then the epilogue; op(A)[m][k] = TA ?
// A[k][m] : A[m][k], op(B)[k][n] = TB ? B[n][k] : B[k][n]. N % 128 is 0,
// and so are the depths % 32 but product 0's of A^T (TA), whose chunk tail
// reads zeros. ``rows`` (0: M) ends the rows of A (not TA) and C. Split-K:
// block z sums product 0 over depths [z * kchunk, (z + 1) * kchunk) into C
// + z * zstride (f32).
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

// A consumer warpgroup's 64 x 128 sums as its epilogue reads them, staged
// in shared memory: warp w of the group takes rows w, w + 4, ..., w + 60,
// lane l the columns 4 l .. 4 l + 3 (a row's 512 bytes a warp)
struct Rows {
  const float* stg;  // [64, STG] f32 sums
  int base;          // the warpgroup's first row: a 64-row column-sum block
  int n0;            // the tile's first column
  int w, lane;
  float* red;        // the warpgroup's [4, 128] f32 scratch
  int bar;           // its named barrier (128 threads)
  int z;             // the split-K chunk whose partial these sums are
  __device__ __forceinline__ int row(int i) const { return base + w + 4 * i; }
  __device__ __forceinline__ int col() const { return n0 + 4 * lane; }
  __device__ __forceinline__ void sums(int i, float (&v)[4]) const {
    const float4 s =
        *reinterpret_cast<const float4*>(stg + (w + 4 * i) * STG + 4 * lane);
    v[0] = s.x; v[1] = s.y; v[2] = s.z; v[3] = s.w;
  }
};

// out[c] = the column sums over the warpgroup's 64 rows, from each lane's
// sums of its 4 columns over its warp's 16 rows, the 4 warps in order.
// Every thread of the warpgroup calls it. A fixed order: two runs give the
// same bits.
__device__ __forceinline__ void half_colsum(const float (&cs)[4],
                                            const Rows& f, float* out) {
  *reinterpret_cast<float4*>(f.red + f.w * GBN + 4 * f.lane) =
      make_float4(cs[0], cs[1], cs[2], cs[3]);
  hop::named_sync(f.bar, 128);
  const int t = threadIdx.x % 128;
  out[t] = ((f.red[t] + f.red[GBN + t]) + f.red[2 * GBN + t]) +
           f.red[3 * GBN + t];
}

// The plain epilogue: (+ bias) (+ add), stored in f32 (split-K partials
// by chunk, `Rows::z`) or T. ``Tag`` names the caller's pass in the
// kernel's name (profiles).
template <class Tag = void>
struct Store {
  template <typename T>
  __device__ __forceinline__ void operator()(const Gemm& g,
                                             const Rows& f) const {
    const int mv = g.rows ? g.rows : g.m;
    const int col = f.col();
    float b[4] = {0.f, 0.f, 0.f, 0.f};
    if (g.bias) ld4(static_cast<const T*>(g.bias) + col, b);
#pragma unroll
    for (int i0 = 0; i0 < HALF / 4; i0 += BATCH) {
      float v[BATCH][4], a[BATCH][4];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        f.sums(i0 + u, v[u]);
        const int row = f.row(i0 + u);
        if (g.add && row < mv) ld4c(g.add + (size_t)row * g.ldc + col, a[u]);
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int row = f.row(i0 + u);
        if (row >= mv) continue;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          v[u][q] += b[q];
          if (g.add) v[u][q] += a[u][q];
        }
        if (g.c_f32) {
          st4(static_cast<float*>(g.c) + f.z * g.zstride +
                  (size_t)row * g.ldc + col, v[u]);
        } else {
          st4(static_cast<T*>(g.c) + (size_t)row * g.ldc + col, v[u]);
        }
      }
    }
  }
};

// hi (and for float32 lo) of four neighbouring depths into the 16-byte
// chunk at ``off`` of a slice's parts
template <typename T>
__device__ __forceinline__ void put4(unsigned char* part, uint32_t off,
                                     const float* v) {
  if constexpr (sizeof(T) == 2) {  // bf16: a tf32 value already
    *reinterpret_cast<float4*>(part + off) =
        make_float4(v[0], v[1], v[2], v[3]);
  } else {
    float hi[4], lo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      hi[i] = hop::tf32_rna(v[i]);
      lo[i] = hop::tf32_rna(v[i] - hi[i]);
    }
    *reinterpret_cast<float4*>(part + off) =
        make_float4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<float4*>(part + SLICE + off) =
        make_float4(lo[0], lo[1], lo[2], lo[3]);
  }
}

// ``R`` rows' share of one operand's slice for thread t of 128 (R * 32 / 128
// values), into registers: rows r0.. of a [rows, K] operand read along K
// (kcont: A, or B with TB), four depths a load, 128 / 8 rows apart; or R
// rows r0.. of an operand stored [K, rows] (A^T, or B [K, N]), a depth a
// load, 32 R / 128 depths a thread, a warp's loads 32 neighbouring values.
// Rows from rv and depths from kend read zeros.
template <int R, bool kcont, typename T>
__device__ __forceinline__ void load_rows(const T* p, int ld, int r0, int rv,
                                          int k, int kend, int t,
                                          float (&v)[R / 4]) {
  if constexpr (kcont) {
#pragma unroll
    for (int i = 0; i < R / 16; ++i) {
      const int r = r0 + 16 * i + (t >> 3);
      const int kc = k + 4 * (t & 7);
      float o[4] = {0.f, 0.f, 0.f, 0.f};
      if (r < rv && kc < kend) ld4(p + (size_t)r * ld + kc, o);
#pragma unroll
      for (int q = 0; q < 4; ++q) v[4 * i + q] = o[q];
    }
  } else {
    constexpr int D = GBK * R / 128;  // depths a thread
    const int r = r0 + t % R, k0 = k + D * (t / R);
#pragma unroll
    for (int j = 0; j < D; ++j)
      v[j] = k0 + j < kend ? to_f(__ldg(p + (size_t)(k0 + j) * ld + r)) : 0.f;
  }
}

// the same values split into the slice's tf32 parts at ``part`` (rows
// 0..R-1 of it), K-major: a quarter warp writes 8 distinct 16-byte banks
template <int R, bool kcont, typename T>
__device__ __forceinline__ void split_rows(unsigned char* part, int t,
                                           const float (&v)[R / 4]) {
  if constexpr (kcont) {
#pragma unroll
    for (int i = 0; i < R / 16; ++i)
      put4<T>(part, hop::sw128(16 * i + (t >> 3), t & 7), v + 4 * i);
  } else {
    constexpr int D = GBK * R / 128;
#pragma unroll
    for (int c = 0; c < D / 4; ++c)
      put4<T>(part, hop::sw128(t % R, (D / 4) * (t / R) + c), v + 4 * c);
  }
}

// The tile. Producer warpgroup: B's slices, loaded two ahead into
// registers, split into the ring as the consumers free each stage. Consumer
// warpgroup c: loads its 64 rows of A's next slice while its products run,
// splits them into the next stage itself (its rows of a stage are its own),
// then the slice's 12 (bf16: 4) wgmma into a slice sum, added to the f32
// sums once they are done.
template <typename T, bool TA, bool TB, class Epi>
__global__ void __launch_bounds__(GTHREADS, 1) gemm_kernel(Gemm g, Epi epi) {
  using R = Ring<T>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + R::STAGES * R::STAGE);
  uint64_t* empty = full + R::STAGES;
  const int m0 = blockIdx.x * GBM, n0 = blockIdx.y * GBN;
  const int mv = g.rows ? g.rows : g.m;
  const int kb = blockIdx.z * g.kchunk;
  const int ke = min(g.k0, kb + g.kchunk);
  const int nt0 = ke > kb ? (ke - kb + GBK - 1) / GBK : 0;
  const int nt = nt0 + g.k1 / GBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < R::STAGES; ++s) {
      hop::mbar_init(&full[s], 128);
      hop::mbar_init(&empty[s], 8);
    }
    hop::fence_barrier_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  // slice kt: product 0 over depths [kb, ke), then product 1 over [0, k1)
  auto depth = [&](int kt, int& k, int& kend) {
    const bool p0 = kt < nt0;
    k = p0 ? kb + kt * GBK : (kt - nt0) * GBK;
    kend = p0 ? ke : g.k1;
    return p0;
  };
  int stage = 0;
  uint32_t phase = 0;
  auto advance = [&]() {
    if (++stage == R::STAGES) {
      stage = 0;
      phase ^= 1;
    }
  };

  if (wg == 0) {
    float v[2][32];
    auto load = [&](int kt, float (&r)[32]) {
      int k, kend;
      const bool p0 = depth(kt, k, kend);
      load_rows<GBN, TB>(static_cast<const T*>(p0 ? g.b0 : g.b1),
                         p0 ? g.ldb0 : g.ldb1, n0, g.n, k, kend, t, r);
    };
#pragma unroll
    for (int u = 0; u < 2; ++u)
      if (u < nt) load(u, v[u]);
    for (int kt = 0; kt < nt; kt += 2) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (kt + u < nt) {
          hop::mbar_wait(&empty[stage], phase ^ 1);
          split_rows<GBN, TB, T>(smem + stage * R::STAGE + R::PARTS * SLICE,
                                 t, v[u]);
          if (kt + u + 2 < nt) load(kt + u + 2, v[u]);
          hop::fence_async_smem();
          hop::mbar_arrive(&full[stage]);
          advance();
        }
      }
    }
    return;
  }

  const int c = wg - 1;
  const int bar = 1 + c;
  float va[16];
  auto load_a = [&](int kt) {
    int k, kend;
    const bool p0 = depth(kt, k, kend);
    load_rows<HALF, !TA>(static_cast<const T*>(p0 ? g.a0 : g.a1),
                         p0 ? g.lda0 : g.lda1, m0 + c * HALF, mv, k, kend,
                         t, va);
  };
  auto split_a = [&](int s) {
    split_rows<HALF, !TA, T>(smem + s * R::STAGE + c * HALF * 128, t, va);
    hop::fence_async_smem();
    hop::named_sync(bar, 128);
  };
  float acc[64], sl[64];
#pragma unroll
  for (int q = 0; q < 64; ++q) acc[q] = sl[q] = 0.f;
  if (nt > 0) {
    load_a(0);
    split_a(0);
  }
  for (int kt = 0; kt < nt; ++kt) {
    if (kt + 1 < nt) load_a(kt + 1);
    hop::mbar_wait(&full[stage], phase);
    const uint32_t s = hop::smem_u32(smem + stage * R::STAGE);
    const uint32_t a = s + c * HALF * 128, b = s + R::PARTS * SLICE;
    hop::wg_fence();
#pragma unroll
    for (int kk = 0; kk < GBK / 8; ++kk) {
      const uint64_t ah = hop::desc_k128(a, kk), bh = hop::desc_k128(b, kk);
      if constexpr (R::PARTS == 2) {
        hop::wgmma_tf32_n128(sl, hop::desc_k128(a + SLICE, kk), bh, kk > 0);
        hop::wgmma_tf32_n128(sl, ah, hop::desc_k128(b + SLICE, kk), 1);
      }
      hop::wgmma_tf32_n128(sl, ah, bh, R::PARTS == 2 || kk > 0);
    }
    hop::wg_commit();
    // the next slice's rows of A, split while the products run
    if (kt + 1 < nt) split_a(stage + 1 == R::STAGES ? 0 : stage + 1);
    hop::wg_wait<0>();
    hop::fence_regs(sl);
    if (t % 32 == 0) hop::mbar_arrive(&empty[stage]);
#pragma unroll
    for (int q = 0; q < 64; ++q) acc[q] += sl[q];
    advance();
  }
  // both consumers done with the ring: stage the sums in it, in wgmma's
  // layout (row 16 warp + lane / 4 (+ 8), columns 8 j + 2 (lane % 4) + 0..1)
  hop::named_sync(4, 256);
  float* stg = reinterpret_cast<float*>(smem) + c * HALF * STG;
  const int lane = t % 32, w = t / 32;
  const int r = 16 * w + lane / 4, q2 = 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < GBN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(stg + (r + 8 * h) * STG + 8 * j + q2) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  hop::named_sync(bar, 128);
  const Rows f = {stg, m0 + c * HALF, n0, w, lane,
                  reinterpret_cast<float*>(smem) + 2 * HALF * STG +
                      c * 4 * GBN,
                  bar, (int)blockIdx.z};
  epi.template operator()<T>(g, f);
}

template <typename T, bool TA, bool TB, class Epi = Store<>>
cudaError_t gemm(const Gemm& g, int nz, cudaStream_t st, Epi epi = Epi()) {
  auto kernel = gemm_kernel<T, TA, TB, Epi>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Ring<T>::SMEM);
  if (e != cudaSuccess) return e;
  const int mv = g.rows ? g.rows : g.m;
  dim3 grid((mv + GBM - 1) / GBM, g.n / GBN, nz);
  kernel<<<grid, GTHREADS, Ring<T>::SMEM, st>>>(g, epi);
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

}  // namespace simple
