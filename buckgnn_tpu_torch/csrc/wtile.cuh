// The weight tile of the float32 / any-width variants: C = A0 @ B0 (+ A1
// @ B1) then an epilogue, with B pre-split once a call. It takes
//  - every product whose B is a weight as stored, [K, N] (sage_simple.cu:
//    #1's [agg | x] @ [W_l; W_r]; ea_simple.cu: every product of #5 and of
//    #6's recomputed forward chain);
//  - every product whose B is a transposed weight, B = W^T pre-split from
//    W's rows (`add_wtjob`): the SAGE backward's (#2s, #3s) dagg | dxp =
//    dout @ [W_l^T | W_r^T] in one launch, N = 2H, the epilogue storing
//    C's halves to dagg and to dxp (+ dz_eff); #6s's dz @ W^T, its dx from
//    B = [W_er^T; W_sp^T] stacked in depth;
//  - the SAGE backward's weight pass [dW_l; dW_r] = [agg | x]^T @ dout
//    (`wgemm_at`): A read transposed out of row-major boxes
//    (`at_fragment`), B = dout pre-split over its N rows (`asplit`), the
//    depth split into row chunks whose f32 partials sum_parts adds in
//    chunk order.
// #6s's weight pass stays on simple.cuh's gemm_kernel.
//
// Arithmetic: as gemm_kernel's, 3xTF32 (lo.hi + hi.lo + hi.hi of the tf32
// parts hi = tf32(x), lo = tf32(x - hi), cvt.rna; bf16 in one pass, a bf16
// value being a tf32 value), each 32-deep slice's tensor-core sum added to
// the float32 sums with a round-to-nearest add, no float atomics: two runs
// give the same bits.
//
// Where the operands come from:
//  - wsplit_kernel (asplit_kernel for dout), once a call, splits B into
//    its tf32 parts, K-major (as wgmma takes tf32), into the caller's
//    scratch: [parts, N, K] f32 (parts 2 in float32, 1 in bf16), each
//    32-deep slice's depths in the order `wdepth` (the weight pass:
//    `tdepth`). A TMA box of [128 n, 32 k] in the 128-byte swizzle lands
//    as hopper.cuh::sw128 lays out a slice: no thread of the tile loads,
//    splits or writes B;
//  - A's [128 rows, 32] slice comes by TMA into the same ring stage (rows
//    past ``rows`` read as zeros), and each consumer warpgroup reads its
//    fragment (rows 16 w + l / 4 and + 8 of its 64; depths 4 q..4 q + 3
//    and 16 + 4 q.., q = l % 4: two 16-byte loads a row, bank-conflict
//    free), splits hi and lo in registers and issues wgmma .tf32 with A
//    from registers (RS mode). The slice's depth order matches the
//    pre-split B's, so the sums are the product's. (A loaded into
//    registers straight from device memory, two slices ahead, held 32 more
//    registers through the loop, which then spilled.)
//  - A^T (the weight pass): the slice of A [depth, M] as stored comes as
//    row-major boxes of [32 depths, 128 bytes] in the 128-byte swizzle, and
//    a thread reads its 16 fragment values one 4-byte (bf16: 2-byte) load
//    each, transposed; the order `tdepth` puts a quarter warp's four depths
//    on four swizzle phases, so the reads are free of bank conflicts.
// One producer thread keeps TMA loads in flight (setmaxnreg gives its
// warpgroup 24 registers, each consumer thread 240). Blocks are persistent
// (one an SM), each walking work items (a 128 x 128 tile of C, or a tile
// and a row chunk of the weight pass, chunk-major so that the blocks in
// flight share a chunk's A and B in L2) with both consumers on one tile
// (64 rows each), so each B slice read from L2 serves 128 rows. The
// producer runs ahead into the next item while the consumers stage their
// sums outside the ring and run the epilogue: the next item's loads
// overlap the epilogue, the tensor cores do not (both consumers are in
// it). The epilogue is simple.cuh's: a type read row by row through `Rows`
// (Store, sage_simple.cu's DaggDxp and DwParts, ea_simple.cu's Epi), rows
// past ``rows`` not stored.
// What bounds it on an H100: per 32-deep slice of a tile the 24 wgmma read
// 96 KB of B from shared memory, TMA writes 48 KB and the fragments read 16
// KB, against 3 tf32 products for each float32 one at 495 TFLOP/s (165
// TFLOP/s of float32 products); B (32 KB a slice) and A come from L2; the
// epilogue adds its own time to every item (the weight pass: 51 chunks'
// f32 partials of 64 KB a tile at the flagship's N); dout's pre-split moves
// 0.6 GB at the flagship's N (bytes). PERF.md has the rates.

#pragma once

#include "simple.cuh"

namespace simple {

// the depth of position p (8 kk + j: wgmma step kk, column j) of a 32-deep
// slice
__host__ __device__ constexpr int wdepth(int p) {
  return 4 * (p % 4) + 16 * ((p % 8) / 4) + p / 8;
}

// the same for a product whose A is read transposed (the weight pass):
// column j of step kk holds depth 8 kk + 2 (j % 4) + j / 4, so the four
// depths a quarter warp reads at once lie in four k-rows whose swizzle
// phases (k & 7) differ in bits 1-2 (`at_fragment`)
__host__ __device__ constexpr int tdepth(int p) {
  return 8 * (p / 8) + 2 * (p % 4) + (p % 8) / 4;
}

// ---- the pre-split ------------------------------------------------------

// one weight: W0 [k0, n] (row stride ldb0) and, below it, W1 [k1, n] as
// stored; or, with ``trans``, B = W0^T and, below it, W1^T for W0 [n, k0]
// and W1 [n, k1] as stored (the backward's transposed weights). Into out
// [parts, n, k0 + k1] (parts ``pstride`` floats apart, 0: n * (k0 + k1)),
// each slice in `wdepth` order.
struct WJob {
  const void *b0, *b1;
  int ldb0, ldb1, k0, k1, n;
  int trans;
  size_t pstride;
  float* out;
};

__host__ __device__ constexpr int kpad32(int k) { return (k + 31) / 32 * 32; }

constexpr int WMAX_JOBS = 12;

struct WJobs {
  WJob j[WMAX_JOBS];
  int count;
  int tiles;  // the most 32 x 32 tiles of any job
};

template <typename T>
__host__ __device__ constexpr int wparts() {
  return sizeof(T) == 4 ? 2 : 1;
}

// floats of a pre-split [k, n] B in T
template <typename T>
inline size_t wsplit_floats(int k, int n) {
  return (size_t)wparts<T>() * kpad32(k) * n;
}

// job blockIdx.y, its 32 x 32 tile blockIdx.x: read along n (``trans``:
// along k), written along k in the slice's positions
template <typename T, class Tag>
__global__ void __launch_bounds__(256) wsplit_kernel(
    const __grid_constant__ WJobs js) {
  const WJob& jb = js.j[blockIdx.y];
  const int k = jb.k0 + jb.k1;
  const int tn = jb.n / 32;
  if ((int)blockIdx.x >= k / 32 * tn) return;
  const int ks = blockIdx.x / tn * 32, n0 = blockIdx.x % tn * 32;
  __shared__ float s[32][33];  // [depth, n]
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  if (jb.trans) {
    const bool p1 = ks >= jb.k0;  // k0 % 32 == 0: a slice is in one weight
    const T* src = static_cast<const T*>(p1 ? jb.b1 : jb.b0) +
                   (p1 ? ks - jb.k0 : ks) + tx;
    const int ld = p1 ? jb.ldb1 : jb.ldb0;
    for (int c = ty; c < 32; c += 8)
      s[tx][c] = to_f(src[(size_t)(n0 + c) * ld]);
  } else {
    for (int r = ty; r < 32; r += 8) {
      const int d = ks + r;
      const T* src =
          d < jb.k0
              ? static_cast<const T*>(jb.b0) + (size_t)d * jb.ldb0
              : static_cast<const T*>(jb.b1) + (size_t)(d - jb.k0) * jb.ldb1;
      s[r][tx] = to_f(src[n0 + tx]);
    }
  }
  __syncthreads();
  const size_t ps = jb.pstride ? jb.pstride : (size_t)jb.n * k;
  for (int c = ty; c < 32; c += 8) {
    const float v = s[wdepth(tx)][c];
    float* o = jb.out + (size_t)(n0 + c) * k + ks + tx;
    if constexpr (wparts<T>() == 2) {
      const float hi = hop::tf32_rna(v);
      o[0] = hi;
      o[ps] = hop::tf32_rna(v - hi);
    } else {
      o[0] = v;
    }
  }
}

// the weight pass's B, b [rows, n] (row stride n; dout), pre-split into out
// [parts, n, kpad] (kpad: rows rounded up to 32, depths past the rows
// zero), each slice in `tdepth` order. Block (32 rows, 128 columns): the
// rows come into shared memory by 16-byte loads, then lane l writes
// position l of the slice for 4 columns at a time (four 128-byte stores a
// part), reading the 4 columns of depth tdepth(l) as one 16-byte load
// (a warp's 512 bytes in the fewest wavefronts).
template <typename T>
__global__ void __launch_bounds__(256) asplit_kernel(const T* b, int rows,
                                                     int n, float* out) {
  __shared__ __align__(16) float s[32][128 + 4];  // [depth, column]
  const int r0 = blockIdx.x * 32, n0 = blockIdx.y * 128;
  const int kp = kpad32(rows);
  {
    const int r = threadIdx.x / 8, c = threadIdx.x % 8 * 16;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (r0 + r < rows) ld4(b + (size_t)(r0 + r) * n + n0 + c + 4 * q, v);
      *reinterpret_cast<float4*>(&s[r][c + 4 * q]) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  }
  __syncthreads();
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const size_t ps = (size_t)n * kp;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int c = w * 16 + 4 * q;
    const float4 v4 = *reinterpret_cast<const float4*>(&s[tdepth(lane)][c]);
    const float v[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float* o = out + (size_t)(n0 + c + i) * kp + r0 + lane;
      if constexpr (wparts<T>() == 2) {
        const float hi = hop::tf32_rna(v[i]);
        o[0] = hi;
        o[ps] = hop::tf32_rna(v[i] - hi);
      } else {
        o[0] = v[i];
      }
    }
  }
}

template <typename T>
cudaError_t asplit(const T* b, int rows, int n, float* out,
                   cudaStream_t st) {
  if (rows == 0) return cudaSuccess;
  asplit_kernel<T><<<dim3(kpad32(rows) / 32, n / 128), 256, 0, st>>>(
      b, rows, n, out);
  return cudaGetLastError();
}

template <typename T, class Tag = void>
cudaError_t wsplit(const WJobs& js, cudaStream_t st) {
  if (js.count == 0) return cudaSuccess;
  wsplit_kernel<T, Tag><<<dim3(js.tiles, js.count), 256, 0, st>>>(js);
  return cudaGetLastError();
}

inline void add_job(WJobs* js, const WJob& jb) {
  js->j[js->count++] = jb;
  const int tiles = (jb.k0 + jb.k1) / 32 * (jb.n / 32);
  if (tiles > js->tiles) js->tiles = tiles;
}

// add a job: W0 (and W1 below it) into out
template <typename T>
void add_wjob(WJobs* js, const T* b0, int ldb0, int k0, const T* b1,
              int ldb1, int k1, int n, float* out) {
  add_job(js, {b0, b1, ldb0, ldb1, k0, k1, n, 0, 0, out});
}

// add a job: B = W^T for W [n, k] as stored (and below it W1^T for W1 [n,
// k1]), into rows of an out whose parts are ``pstride`` floats apart (0: n
// * (k + k1); two such jobs side by side make [W0^T | W1^T])
template <typename T>
void add_wtjob(WJobs* js, const T* w, int n, int k, float* out,
               size_t pstride, const T* w1 = nullptr, int k1 = 0) {
  add_job(js, {w, w1, k, k1, k, k1, n, 1, pstride, out});
}

// ---- the tile ---------------------------------------------------------------

constexpr int WCONS_REGS = 240;  // a consumer thread's registers
constexpr int WPROD_REGS = 24;   // a producer-warpgroup thread's
static_assert(2 * 128 * WCONS_REGS + 128 * WPROD_REGS <=
                  GTHREADS * (65536 / GTHREADS / 8 * 8),
              "the register split exceeds the block's allocation");

// shared memory of element type T: STAGES slices, each B's parts ([128 n,
// 32 k] tf32 each, 16 KB, in the 128-byte swizzle) and A's [128 rows, 32
// k] in T (float32 in the 128-byte swizzle, bf16 in the 64-byte one; rows
// 64 c.. are consumer c's) or, for A^T, the same bytes as ABOXES boxes of
// [32 k, ABOXM m] (128-byte k-rows, the 128-byte swizzle; box b holds C's
// rows ABOXM b..); the two consumers' staged sums [64, STG] and column-sum
// scratch [4, 128]; then the barriers
template <typename T>
struct WRing {
  static constexpr int PARTS = wparts<T>();
  static constexpr int STAGES = PARTS == 2 ? 3 : 6;
  static constexpr int PART = GBN * GBK * 4;
  static constexpr int AROW = GBK * (int)sizeof(T);  // bytes of an A row
  static constexpr int STAGE = PARTS * PART + GBM * AROW;
  static constexpr int ABOXM = 128 / (int)sizeof(T);  // m of an A^T box
  static constexpr int ABOXES = GBM / ABOXM;
  static constexpr int STG_OFF = STAGES * STAGE;
  static constexpr int RED_OFF = STG_OFF + 2 * HALF * STG * 4;
  static constexpr int BAR_OFF = RED_OFF + 2 * 4 * GBN * 4;
  static constexpr int SMEM = 1024 + BAR_OFF + 2 * STAGES * 8;
  static_assert(SMEM <= 232448, "a block's shared memory on an H100");
};

// the Gemm (a0, lda0, k0, a1, lda1, k1, m, n, rows and the epilogue's
// fields; b0, b1 and kchunk unused), the pre-split B's map ([parts * n,
// kpad] f32), A0's and A1's and the work: items z * tiles_mn + tile (tile
// m-major) of ``cslices`` slices each (chunk z of the depth), over ``nt``
// slices in all. A as stored: [rows, k] in T, [128, 32] boxes, rows past
// ``rows`` read as zeros, A0 for slices < k0 / 32, A1 after. A^T (AT):
// A0 [depth, msplit] for C's rows < msplit, A1 [depth, m - msplit] for the
// rest, in [32, 128-byte] boxes, depths past the end read as zeros.
struct WGemm {
  Gemm g;
  CUtensorMap map, a0, a1;
  int tiles_n, tiles_mn, items, nt, cslices, msplit;
};

// rows fr and fr + 8 of a consumer's A slice at ``as`` (its 64 rows) at
// depths 4 q..4 q + 3 and 16 + 4 q.. (v[8 h..8 h + 3], v[8 h + 4..]). The
// two loads of a row go in the order that keeps a quarter (float32) or
// half (bf16) warp on distinct banks: rows whose swizzle phase shares the
// first load's banks take the other chunk first.
template <typename T>
__device__ __forceinline__ void a_fragment(const unsigned char* as, int fr,
                                           int q, float (&v)[16]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = fr + 8 * h;
    float lo4[4], hi4[4];
    if constexpr (sizeof(T) == 4) {
      // 128-byte rows, 16-byte chunk c at (c ^ (r % 8)) * 16
      const unsigned char* row = as + r * 128;
      const bool swap = r & 1;
      const float4 u = *reinterpret_cast<const float4*>(
          row + (((swap ? 4 + q : q) ^ (r & 7)) << 4));
      const float4 w = *reinterpret_cast<const float4*>(
          row + (((swap ? q : 4 + q) ^ (r & 7)) << 4));
      const float4 a = swap ? w : u, b = swap ? u : w;
      lo4[0] = a.x; lo4[1] = a.y; lo4[2] = a.z; lo4[3] = a.w;
      hi4[0] = b.x; hi4[1] = b.y; hi4[2] = b.z; hi4[3] = b.w;
    } else {
      // 64-byte rows, 16-byte chunk c at (c ^ ((r / 2) % 4)) * 16; depths
      // 4 q.. are 8 bytes of chunk q / 2, 16 + 4 q.. of chunk 2 + q / 2
      const unsigned char* row = as + r * 64 + (q % 2) * 8;
      const int ph = (r >> 1) & 3;
      const bool swap = ph & 1;
      const uint2 u = *reinterpret_cast<const uint2*>(
          row + (((swap ? 2 + q / 2 : q / 2) ^ ph) << 4));
      const uint2 w = *reinterpret_cast<const uint2*>(
          row + (((swap ? q / 2 : 2 + q / 2) ^ ph) << 4));
      const uint2 a = swap ? w : u, b = swap ? u : w;
      lo4[0] = bf_lo(a.x); lo4[1] = bf_hi(a.x);
      lo4[2] = bf_lo(a.y); lo4[3] = bf_hi(a.y);
      hi4[0] = bf_lo(b.x); hi4[1] = bf_hi(b.x);
      hi4[2] = bf_lo(b.y); hi4[3] = bf_hi(b.y);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[8 * h + i] = lo4[i];
      v[8 * h + 4 + i] = hi4[i];
    }
  }
}

// A^T's fragment: rows (of C) fr and fr + 8 of a consumer's 64, at
// ``as`` (its boxes), at the slice's positions 8 kk + q (v[8 h + kk]) and 8
// kk + q + 4 (v[8 h + 4 + kk]), whose depths (`tdepth`) are k = 8 kk + 2 q
// and 8 kk + 2 q + 1: one 4-byte (bf16: 2-byte) load each from k-row k.
// For a fixed (h, kk, column) a quarter warp's 8 rows span two 16-byte
// chunks (float32; bf16: one) and its 4 depths four swizzle phases, so a
// warp's 32 loads fall on 32 distinct banks (bf16: 16 words, 2 lanes
// each): no bank conflicts.
template <typename T>
__device__ __forceinline__ void at_fragment(const unsigned char* as, int fr,
                                            int q, float (&v)[16]) {
  using R = WRing<T>;
  const unsigned char* box = as + fr / R::ABOXM * 4096;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = fr % R::ABOXM + 8 * h;
    const int cb = m * (int)sizeof(T);  // byte of m in an unswizzled row
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int k = 8 * kk + 2 * q + j;
        const unsigned char* e =
            box + k * 128 + ((((cb >> 4) ^ (k & 7)) << 4) | (cb & 15));
        float x;
        if constexpr (sizeof(T) == 4)
          x = *reinterpret_cast<const float*>(e);
        else
          x = __uint_as_float(
              (uint32_t)*reinterpret_cast<const unsigned short*>(e) << 16);
        v[8 * h + 4 * j + kk] = x;
      }
  }
}

// The tile: work item it (chunk z, 128 x 128 tile of C) sums its slices
// [z cslices, min(nt, (z + 1) cslices)) (A^T: A read transposed, `AT`)
template <typename T, bool AT, class Epi>
__global__ void __launch_bounds__(GTHREADS, 1) wtile_kernel(
    const __grid_constant__ WGemm p, Epi epi) {
  using R = WRing<T>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + R::BAR_OFF);
  uint64_t* empty = full + R::STAGES;
  const Gemm& g = p.g;
  const int nt0 = AT ? p.nt : g.k0 / GBK;  // slices of product 0
  if (threadIdx.x == 0) {
    for (int s = 0; s < R::STAGES; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], 8);
    }
    hop::fence_barrier_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  int stage = 0;
  uint32_t phase = 0;
  auto advance = [&]() {
    if (++stage == R::STAGES) {
      stage = 0;
      phase ^= 1;
    }
  };
  // item it: its tile's first row and column, chunk and slices [kb, ke)
  auto item = [&](int it, int& m0, int& n0, int& z, int& kb, int& ke) {
    z = it / p.tiles_mn;
    const int tile = it % p.tiles_mn;
    m0 = tile / p.tiles_n * GBM;
    n0 = tile % p.tiles_n * GBN;
    kb = z * p.cslices;
    ke = min(p.nt, kb + p.cslices);
  };

  if (wg == 0) {
    // the producer: B's parts and A's rows of every slice of every item of
    // this block, in order
    hop::reg_dealloc<WPROD_REGS>();
    if (t == 0) {
      for (int it = blockIdx.x; it < p.items; it += gridDim.x) {
        int m0, n0, z, kb, ke;
        item(it, m0, n0, z, kb, ke);
        const bool lo = m0 < p.msplit;  // A^T: C's rows from A0
        for (int kt = kb; kt < ke; ++kt) {
          hop::mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* dst = smem + stage * R::STAGE;
          hop::mbar_expect_tx(&full[stage], R::STAGE);
          hop::tma_load(dst, &p.map, &full[stage], kt * GBK, n0);
          if constexpr (R::PARTS == 2)
            hop::tma_load(dst + R::PART, &p.map, &full[stage], kt * GBK,
                          g.n + n0);
          unsigned char* ad = dst + R::PARTS * R::PART;
          if constexpr (AT) {
            for (int b = 0; b < R::ABOXES; ++b)
              hop::tma_load(ad + b * 4096, lo ? &p.a0 : &p.a1, &full[stage],
                            (lo ? m0 : m0 - p.msplit) + b * R::ABOXM,
                            kt * GBK);
          } else {
            const bool p0 = kt < nt0;
            hop::tma_load(ad, p0 ? &p.a0 : &p.a1, &full[stage],
                          (p0 ? kt : kt - nt0) * GBK, m0);
          }
          advance();
        }
      }
    }
  } else {
    hop::reg_alloc<WCONS_REGS>();
    const int c = wg - 1, bar = 1 + c;
    const int lane = t % 32, w = t / 32;
    const int fr = 16 * w + lane / 4, q = lane % 4;  // fragment row, group
    float* stg = reinterpret_cast<float*>(smem + R::STG_OFF) + c * HALF * STG;
    float* red = reinterpret_cast<float*>(smem + R::RED_OFF) + c * 4 * GBN;
    float acc[64], sl[64];
    uint32_t ah[16], al[16];  // the slice's fragments: hi (and lo)
    for (int it = blockIdx.x; it < p.items; it += gridDim.x) {
      int m0, n0, z, kb, ke;
      item(it, m0, n0, z, kb, ke);
      // sl zeroed too: the first product overwrites it, but as an operand
      // of the asm its last item's values would stay live, in registers,
      // through the epilogue
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = sl[i] = 0.f;
      for (int kt = kb; kt < ke; ++kt) {
        hop::mbar_wait(&full[stage], phase);
        const unsigned char* st = smem + stage * R::STAGE;
        const unsigned char* as = st + R::PARTS * R::PART + c * HALF * R::AROW;
        float va[16];
        if constexpr (AT)
          at_fragment<T>(as, fr, q, va);
        else
          a_fragment<T>(as, fr, q, va);
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          if constexpr (R::PARTS == 2) {
            const float hi = hop::tf32_rna(va[i]);
            ah[i] = __float_as_uint(hi);
            al[i] = __float_as_uint(hop::tf32_rna(va[i] - hi));
          } else {
            ah[i] = __float_as_uint(va[i]);
          }
        }
        const uint32_t b = hop::smem_u32(st);
        hop::wg_fence();
#pragma unroll
        for (int kk = 0; kk < GBK / 8; ++kk) {
          // step kk: rows fr, fr + 8 at columns q (ah[kk], ah[8 + kk]) and
          // q + 4 (ah[4 + kk], ah[12 + kk])
          const uint32_t fh[4] = {ah[kk], ah[8 + kk], ah[4 + kk],
                                  ah[12 + kk]};
          const uint64_t bh = hop::desc_k128(b, kk);
          if constexpr (R::PARTS == 2) {
            const uint32_t fl[4] = {al[kk], al[8 + kk], al[4 + kk],
                                    al[12 + kk]};
            hop::wgmma_tf32_rs_n128(sl, fl, bh, kk > 0);
            hop::wgmma_tf32_rs_n128(sl, fh, hop::desc_k128(b + R::PART, kk),
                                    1);
          }
          hop::wgmma_tf32_rs_n128(sl, fh, bh, R::PARTS == 2 || kk > 0);
        }
        hop::wg_commit();
        hop::wg_wait<0>();
        hop::fence_regs(sl);
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] += sl[i];
        hop::fence_regs(ah);
        if constexpr (R::PARTS == 2) hop::fence_regs(al);
        if (lane == 0) hop::mbar_arrive(&empty[stage]);
        advance();
      }
      // the sums staged in wgmma's layout (row 16 w + lane / 4 (+ 8),
      // columns 8 j + 2 (lane % 4) + 0..1), once the warpgroup is done
      // with the previous item's; the producer's loads of the next item
      // are in flight through the epilogue
      hop::named_sync(bar, 128);
      const int q2 = 2 * q;
#pragma unroll
      for (int j = 0; j < GBN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(stg + (fr + 8 * h) * STG + 8 * j + q2) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      hop::named_sync(bar, 128);
      const Rows f = {stg, m0 + c * HALF, n0, w, lane, red, bar, z};
      epi.template operator()<T>(g, f);
      // the warp converged again: without it the compiler cannot prove the
      // next item's stage and descriptors warp-uniform, computes them per
      // thread, and the products spill
      __syncwarp();
    }
  }
}

inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

template <typename T, bool AT, class Epi>
cudaError_t wlaunch(const WGemm& p, cudaStream_t st, Epi epi) {
  using R = WRing<T>;
  if (p.items == 0) return cudaSuccess;
  auto kernel = wtile_kernel<T, AT, Epi>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, R::SMEM);
  if (e != cudaSuccess) return e;
  const int grid = p.items < sm_count() ? p.items : sm_count();
  kernel<<<grid, GTHREADS, R::SMEM, st>>>(p, epi);
  return cudaGetLastError();
}

// the map of A's rows (``outer`` of them, ``inner`` wide, row stride ld)
// for the tile: boxes of [128 rows, 32] (A as stored) or [32 rows, 128
// bytes] (A^T)
template <typename T>
bool a_map(CUtensorMap* m, const void* a, int inner, int outer, int ld,
           bool at) {
  if (sizeof(T) == 4)
    return hop::make_map_f32(m, static_cast<const float*>(a), inner, outer,
                             ld, at ? GBK : GBM);
  return at ? hop::make_map(m, a, inner, outer, ld, 64, GBK)
            : hop::make_map(m, a, inner, outer, ld, GBK, GBM);
}

// C = the epilogue of A0 @ W0 (+ A1 @ W1), ``w`` the pre-split [W0; W1]
// (wsplit), over ``rows`` rows (0: M); N % 128 and the depths % 32 are 0
template <typename T, class Epi = Store<>>
cudaError_t wgemm(const Gemm& g, const float* w, cudaStream_t st,
                  Epi epi = Epi()) {
  using R = WRing<T>;
  WGemm p;
  p.g = g;
  const int mv = g.rows ? g.rows : g.m;
  p.tiles_n = g.n / GBN;
  p.tiles_mn = p.items = (mv + GBM - 1) / GBM * p.tiles_n;
  p.nt = p.cslices = (g.k0 + g.k1) / GBK;
  p.msplit = 0;
  if (p.items == 0) return cudaSuccess;
  if (!hop::make_map_f32(&p.map, w, g.k0 + g.k1, R::PARTS * g.n,
                         g.k0 + g.k1, GBN) ||
      !a_map<T>(&p.a0, g.a0, g.k0, mv, g.lda0, false) ||
      (g.k1 > 0 && !a_map<T>(&p.a1, g.a1, g.k1, mv, g.lda1, false)))
    return cudaErrorInvalidValue;
  return wlaunch<T, false>(p, st, epi);
}

// The weight pass: C = [A0 | A1]^T @ B over ``depth`` rows, A0 [depth,
// msplit] (row stride lda0) giving C's rows [0, msplit), A1 [depth, m -
// msplit] (lda1) the rest (msplit % 128 == 0), ``b`` B [depth, n]'s
// pre-split in `tdepth` order (asplit), in chunks of kchunk rows (a
// multiple of 32), chunk z's sums through the epilogue as Rows::z (Store:
// f32 partials at c + z * zstride). Returns the chunk count in *nz.
template <typename T, class Epi = Store<>>
cudaError_t wgemm_at(const Gemm& g, int msplit, int depth, int kchunk,
                     const float* b, cudaStream_t st, Epi epi, int* nz) {
  using R = WRing<T>;
  WGemm p;
  p.g = g;
  const int kp = kpad32(depth);
  p.tiles_n = g.n / GBN;
  p.tiles_mn = g.m / GBM * p.tiles_n;
  p.nt = kp / GBK;
  p.cslices = kchunk / GBK;
  *nz = (p.nt + p.cslices - 1) / p.cslices;
  p.items = *nz * p.tiles_mn;
  p.msplit = msplit;
  if (p.items == 0) return cudaSuccess;
  if (!hop::make_map_f32(&p.map, b, kp, R::PARTS * g.n, kp, GBN) ||
      !a_map<T>(&p.a0, g.a0, msplit, depth, g.lda0, true) ||
      (g.m > msplit &&
       !a_map<T>(&p.a1, g.a1, g.m - msplit, depth, g.lda1, true)))
    return cudaErrorInvalidValue;
  return wlaunch<T, true>(p, st, epi);
}

}  // namespace simple
