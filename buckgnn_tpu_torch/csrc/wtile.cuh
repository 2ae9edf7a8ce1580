// The weight tile of the float32 / any-width variants (sage_simple.cu: #1's
// product; ea_simple.cu: every product of #5 and of #6's recomputed forward
// chain): C = A0 @ W0 (+ A1 @ W1) then an epilogue, for products whose B is
// a weight as stored, [K, N]. The products whose B is transposed and the
// weight passes stay on simple.cuh's gemm_kernel.
//
// Arithmetic: as gemm_kernel's, 3xTF32 (lo.hi + hi.lo + hi.hi of the tf32
// parts hi = tf32(x), lo = tf32(x - hi), cvt.rna; bf16 in one pass, a bf16
// value being a tf32 value), each 32-deep slice's tensor-core sum added to
// the float32 sums with a round-to-nearest add, no float atomics: two runs
// give the same bits.
//
// Where the operands come from:
//  - wsplit_kernel, once a call, splits each weight into its tf32 parts,
//    transposed to [N, K] (K-major, as wgmma takes tf32), into the
//    caller's scratch: [parts, N, K] f32 (parts 2 in float32, 1 in bf16),
//    each 32-deep slice's depths in the order `wdepth`. A TMA box of [128
//    n, 32 k] in the 128-byte swizzle lands as hopper.cuh::sw128 lays out
//    a slice: no thread loads, splits or writes B;
//  - A's [128 rows, 32] slice comes by TMA into the same ring stage (rows
//    past ``rows`` read as zeros), and each consumer warpgroup reads its
//    fragment (rows 16 w + l / 4 and + 8 of its 64; depths 4 q..4 q + 3
//    and 16 + 4 q.., q = l % 4: two 16-byte loads a row, bank-conflict
//    free), splits hi and lo in registers and issues wgmma .tf32 with A
//    from registers (RS mode). The slice's depth order matches the
//    pre-split weight's, so the sums are the product's. (A loaded into
//    registers straight from device memory, two slices ahead, held 32 more
//    registers through the loop, which then spilled.)
// One producer thread keeps TMA loads in flight (setmaxnreg gives its
// warpgroup 24 registers, each consumer thread 240). Blocks are persistent
// (one an SM), each walking 128 x 128 tiles of C with both consumers on
// one tile (64 rows each), so each B slice read from L2 serves 128 rows.
// The producer runs ahead into the next tile while the consumers stage
// their sums outside the ring and run the epilogue: the next tile's loads
// overlap the epilogue, the tensor cores do not (both consumers are in
// it). The epilogue is simple.cuh's: a type read row by row through `Rows`
// (Store, ea_simple.cu's Epi), rows past ``rows`` not stored.
// What bounds it on an H100: per 32-deep slice of a tile the 24 wgmma read
// 96 KB of B from shared memory, TMA writes 48 KB and the fragments read 16
// KB (gemm_kernel: 240 KB of reads, split writes and L1 passes), against 3
// tf32 products for each float32 one at 495 TFLOP/s (165 TFLOP/s of
// float32 products); B (32 KB a slice, twice gemm_kernel's 16 KB of
// float32 weight) and A come from L2; the epilogue adds its own time to
// every tile. PERF.md has the rates.

#pragma once

#include "simple.cuh"

namespace simple {

// the depth of position p (8 kk + j: wgmma step kk, column j) of a 32-deep
// slice
__host__ __device__ constexpr int wdepth(int p) {
  return 4 * (p % 4) + 16 * ((p % 8) / 4) + p / 8;
}

// ---- the pre-split ------------------------------------------------------

// one weight: W0 [k0, n] (row stride ldb0) and, below it, W1 [k1, n], into
// out [parts, n, k0 + k1]
struct WJob {
  const void *b0, *b1;
  int ldb0, ldb1, k0, k1, n;
  float* out;
};

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

// floats of a pre-split [k, n] weight in T
template <typename T>
inline size_t wsplit_floats(int k, int n) {
  return (size_t)wparts<T>() * k * n;
}

// job blockIdx.y, its 32 x 32 tile blockIdx.x: read along n, written along
// k in the slice's positions
template <typename T, class Tag>
__global__ void __launch_bounds__(256) wsplit_kernel(
    const __grid_constant__ WJobs js) {
  const WJob& jb = js.j[blockIdx.y];
  const int k = jb.k0 + jb.k1;
  const int tn = jb.n / 32;
  if ((int)blockIdx.x >= k / 32 * tn) return;
  const int ks = blockIdx.x / tn * 32, n0 = blockIdx.x % tn * 32;
  __shared__ float s[32][33];
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  for (int r = ty; r < 32; r += 8) {
    const int d = ks + r;
    const T* src =
        d < jb.k0
            ? static_cast<const T*>(jb.b0) + (size_t)d * jb.ldb0
            : static_cast<const T*>(jb.b1) + (size_t)(d - jb.k0) * jb.ldb1;
    s[r][tx] = to_f(src[n0 + tx]);
  }
  __syncthreads();
  for (int c = ty; c < 32; c += 8) {
    const float v = s[wdepth(tx)][c];
    float* o = jb.out + (size_t)(n0 + c) * k + ks + tx;
    if constexpr (wparts<T>() == 2) {
      const float hi = hop::tf32_rna(v);
      o[0] = hi;
      o[(size_t)jb.n * k] = hop::tf32_rna(v - hi);
    } else {
      o[0] = v;
    }
  }
}

template <typename T, class Tag = void>
cudaError_t wsplit(const WJobs& js, cudaStream_t st) {
  if (js.count == 0) return cudaSuccess;
  wsplit_kernel<T, Tag><<<dim3(js.tiles, js.count), 256, 0, st>>>(js);
  return cudaGetLastError();
}

// add a job: W0 (and W1 below it) into out
template <typename T>
void add_wjob(WJobs* js, const T* b0, int ldb0, int k0, const T* b1,
              int ldb1, int k1, int n, float* out) {
  WJob& jb = js->j[js->count++];
  jb = {b0, b1, ldb0, ldb1, k0, k1, n, out};
  const int tiles = (k0 + k1) / 32 * (n / 32);
  if (tiles > js->tiles) js->tiles = tiles;
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
// 64 c.. are consumer c's); the two consumers' staged sums [64, STG] and
// column-sum scratch [4, 128]; then the barriers
template <typename T>
struct WRing {
  static constexpr int PARTS = wparts<T>();
  static constexpr int STAGES = PARTS == 2 ? 3 : 6;
  static constexpr int PART = GBN * GBK * 4;
  static constexpr int AROW = GBK * (int)sizeof(T);  // bytes of an A row
  static constexpr int STAGE = PARTS * PART + GBM * AROW;
  static constexpr int STG_OFF = STAGES * STAGE;
  static constexpr int RED_OFF = STG_OFF + 2 * HALF * STG * 4;
  static constexpr int BAR_OFF = RED_OFF + 2 * 4 * GBN * 4;
  static constexpr int SMEM = 1024 + BAR_OFF + 2 * STAGES * 8;
  static_assert(SMEM <= 232448, "a block's shared memory on an H100");
};

// the Gemm (a0, lda0, k0, a1, lda1, k1, m, n, rows and the epilogue's
// fields; b0, b1, kchunk and zstride unused), the pre-split weight's map
// ([parts * n, k0 + k1] f32), A0's and A1's ([rows, k] in T, [128, 32]
// boxes, rows past ``rows`` read as zeros) and the tiles
struct WGemm {
  Gemm g;
  CUtensorMap map, a0, a1;
  int tiles_n, tiles;
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

template <typename T, class Epi>
__global__ void __launch_bounds__(GTHREADS, 1) wtile_kernel(
    const __grid_constant__ WGemm p, Epi epi) {
  using R = WRing<T>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + R::BAR_OFF);
  uint64_t* empty = full + R::STAGES;
  const Gemm& g = p.g;
  const int nt0 = g.k0 / GBK, nt = nt0 + g.k1 / GBK;  // slices a tile
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

  if (wg == 0) {
    // the producer: B's parts and A's rows of every slice of every tile of
    // this block, in order
    hop::reg_dealloc<WPROD_REGS>();
    if (t == 0) {
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        const int m0 = tile / p.tiles_n * GBM, n0 = tile % p.tiles_n * GBN;
        for (int kt = 0; kt < nt; ++kt) {
          hop::mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* dst = smem + stage * R::STAGE;
          hop::mbar_expect_tx(&full[stage], R::STAGE);
          hop::tma_load(dst, &p.map, &full[stage], kt * GBK, n0);
          if constexpr (R::PARTS == 2)
            hop::tma_load(dst + R::PART, &p.map, &full[stage], kt * GBK,
                          g.n + n0);
          const bool p0 = kt < nt0;
          hop::tma_load(dst + R::PARTS * R::PART, p0 ? &p.a0 : &p.a1,
                        &full[stage], (p0 ? kt : kt - nt0) * GBK, m0);
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
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const int m0 = tile / p.tiles_n * GBM, n0 = tile % p.tiles_n * GBN;
      // sl zeroed too: the first product overwrites it, but as an operand
      // of the asm its last tile's values would stay live, in registers,
      // through the epilogue
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = sl[i] = 0.f;
      for (int kt = 0; kt < nt; ++kt) {
        hop::mbar_wait(&full[stage], phase);
        const unsigned char* st = smem + stage * R::STAGE;
        float va[16];
        a_fragment<T>(st + R::PARTS * R::PART + c * HALF * R::AROW, fr, q,
                      va);
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
      // with the previous tile's; the producer's loads of the next tile
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
      const Rows f = {stg, m0 + c * HALF, n0, w, lane, red, bar};
      epi.template operator()<T>(g, f);
      // the warp converged again: without it the compiler cannot prove the
      // next tile's stage and descriptors warp-uniform, computes them per
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
  p.tiles = (mv + GBM - 1) / GBM * p.tiles_n;
  if (p.tiles == 0) return cudaSuccess;
  auto a_map = [&](CUtensorMap* m, const void* a, int k, int lda) {
    if (sizeof(T) == 4)
      return hop::make_map_f32(m, static_cast<const float*>(a), k, mv, lda,
                               GBM);
    return hop::make_map(m, a, k, mv, lda, GBK, GBM);
  };
  if (!hop::make_map_f32(&p.map, w, g.k0 + g.k1, R::PARTS * g.n,
                         g.k0 + g.k1, GBN) ||
      !a_map(&p.a0, g.a0, g.k0, g.lda0) ||
      (g.k1 > 0 && !a_map(&p.a1, g.a1, g.k1, g.lda1)))
    return cudaErrorInvalidValue;
  auto kernel = wtile_kernel<T, Epi>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, R::SMEM);
  if (e != cudaSuccess) return e;
  const int grid = p.tiles < sm_count() ? p.tiles : sm_count();
  kernel<<<grid, GTHREADS, R::SMEM, st>>>(p, epi);
  return cudaGetLastError();
}

}  // namespace simple
