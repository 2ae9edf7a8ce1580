// The product engine of the port's Hopper kernels (the fused EA block's
// forward and backward, ea_block_fwd.cu and ea_block_bwd.cu; the fused SAGE
// layer's forward and the backward's tile pass, sage_layer_fwd.cu and
// sage_layer_bwd.cu; the band kernel of banded.cuh, which runs on
// persistent clusters), and the epilogue pieces they share.
//
// A block owns BM = 64 rows and the whole output width N of every product
// in its chain (N = H, or the EA encoder's 128). It has four consumer
// warpgroups and a producer warpgroup of which one thread works (640
// threads; setmaxnreg gives the consumers 112 registers, the producer 24;
// `roles` splits them):
//  - the producer streams each weight, in slices 32 deep along K, through
//    a ring of STAGES slices in shared memory (TMA, hopper.cuh's layouts,
//    one "full" and one "empty" mbarrier per slice). W [in, out] is read
//    MN-major for x @ W and K-major, from the same tensor, for x @ W^T: the
//    descriptor's major-ness transposes, not a copy. Operands that come
//    whole from device memory (x, e_in, e1) are loaded by TMA too, either
//    once into the row tile or slice by slice beside the weight;
//  - blocks run in clusters of two (64 rows each, neighbours): each block's
//    producer loads half of every weight slice and multicasts it to both,
//    so each weight byte read from L2 serves 128 rows. A slice is refilled
//    when all 32 consumer warps of the cluster have released it;
//  - consumer warpgroup j of four issues wgmma m64nNWk16 (NW = N / 4, bf16
//    in, f32 sums in registers) for output columns [j NW, (j + 1) NW): A is
//    the row tile in shared memory (K-major, written by the previous
//    epilogue in the swizzled layout wgmma reads) or a streamed slice, B the
//    ring slice. At H = 512 a thread holds 64 f32 sums: four warpgroups
//    rather than two halve each thread's epilogue and registers and double
//    the warps that hide its loads.
// Epilogues run on the accumulator registers: thread (warp w of its
// warpgroup, lane l) holds, for each q < NW / 8, the column pair
// j NW + 8 q + 2 (l % 4) + {0, 1} of rows 16 w + l / 4 (sums 4q, 4q + 1)
// and 16 w + l / 4 + 8 (4q + 2, 4q + 3). Bias, relu, relu masks (kept as
// bits in registers where the mask's owner thread is the same), the keep
// mask, casts and the skip are applied there; the next product's A is
// written back into the row tile in place after every warpgroup is done
// reading it, and outputs leave from a tile in 16-byte rows. An
// epilogue's inputs are read-only loads issued ahead of its stores, from
// two row pointers a thread. Column sums (bias gradients) reduce a
// thread's two rows, then lanes by a fixed shuffle tree, then the four
// warps in order through shared memory: the same bits every run.
//
// Shared memory (H = 512): row tile 64 x 512 bf16 = 64 KB; a ring slice is
// 32 x 512 bf16 = 32 KB (36 KB with a streamed A slice of 64 x 32).
// Registers: 112 a consumer thread, of which 64 hold the sums (one block
// per SM).

#pragma once

#include "hopper.cuh"
#include "sage_common.cuh"

namespace eng {
using hop::bf16;

constexpr int BM = 64;            // rows per block
constexpr int NWG = 4;            // consumer warpgroups
constexpr int NCONS = NWG * 128;  // consumer threads
constexpr int NTHREADS = NCONS + 128;  // and the producer's warpgroup
constexpr int CONS_REGS = 112;    // registers of a consumer thread
constexpr int PROD_REGS = 24;     // of a producer-warpgroup thread
// setmaxnreg only moves registers within the block's launch allocation
// (65536 / NTHREADS a thread, in steps of 8): a larger split would wait
// forever in setmaxnreg.inc
static_assert(NCONS * CONS_REGS + 128 * PROD_REGS <=
                  NTHREADS * (65536 / NTHREADS / 8 * 8),
              "the register split exceeds the block's allocation");
constexpr int CLUSTER = 2;        // blocks sharing each weight slice
constexpr int BK = 32;            // slice depth along K
constexpr int PANEL = BM * BK * 2;  // bytes of a [64, 32] K-major slice
constexpr int BAR_ALL = 1;    // named barrier of all consumers
constexpr int BAR_WG = 2;     // named barriers 2-5: one warpgroup each
constexpr int RED_WARPS = NWG * 4;  // rows of a column-sum buffer

// bytes of a [64, w] K-major tile in 32-deep panels
__host__ __device__ constexpr int tile_bytes(int w) { return w / BK * PANEL; }

// one ring slice: B [32, n] and, when streamed, an A slice [64, 32]
__host__ __device__ constexpr int slice_bytes(int n, bool a) {
  return n * BK * 2 + (a ? PANEL : 0);
}

// the ring and mbarriers at the front of dynamic shared memory, then the
// caller's tiles (1024-byte aligned)
struct Smem {
  uint64_t full[8], empty[8], abar;
};

__host__ __device__ constexpr int ring_offset() { return 1024; }

// dynamic shared memory of a kernel: 1024 bytes of slack to align the
// base, the barriers, the ring and the kernel's own tiles
__host__ __device__ constexpr int smem_bytes(int stages, int slice,
                                             int tiles_after) {
  return 1024 + ring_offset() + stages * slice + tiles_after;
}

// the 1024-byte aligned base of dynamic shared memory (the swizzles are
// functions of the address)
__device__ __forceinline__ unsigned char* align_smem(unsigned char* p) {
  return p + ((1024 - (hop::smem_u32(p) & 1023)) & 1023);
}

// the consumer thread's place in the accumulator layout
struct Thr {
  int wg, wl, lane, r0, c0;
  __device__ __forceinline__ Thr() {
    const int t = threadIdx.x;
    wg = t / 128;
    wl = (t / 32) % 4;
    lane = t % 32;
    r0 = 16 * wl + lane / 4;
    c0 = 2 * (lane % 4);
  }
};

// calls f(i, row, col) for each even sum index i of a warpgroup of width
// NW: sums i and i + 1 are columns col, col + 1 of row (block-relative)
template <int NW, typename F>
__device__ __forceinline__ void pairs(const Thr& t, F f) {
#pragma unroll
  for (int q = 0; q < NW / 8; ++q)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      f(4 * q + 2 * h, t.r0 + 8 * h, t.wg * NW + 8 * q + t.c0);
}

// as pairs, in chunks of 16 pairs separated by compiler memory barriers:
// an epilogue's loads overlap within a chunk but are not all hoisted ahead
// of the sums they feed, which bounds the registers they hold
template <int NW, typename F>
__device__ __forceinline__ void pairs_chunked(const Thr& t, F f) {
  constexpr int CH = 8;  // column groups (two pairs each) per chunk
#pragma unroll
  for (int q0 = 0; q0 < NW / 8; q0 += CH) {
#pragma unroll
    for (int q = q0; q < q0 + CH && q < NW / 8; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        f(4 * q + 2 * h, t.r0 + 8 * h, t.wg * NW + 8 * q + t.c0);
    asm volatile("" ::: "memory");
  }
}

// ---- the producer (one thread) -------------------------------------------
struct Producer {
  hop::Ring ring;
  uint32_t rank;

  // nk weight slices of an N-wide product, from k0 (W's K coordinate) and
  // n0 (its N coordinate): MN reads W [k, n] in [32 k, 64 n] boxes, else W
  // [n, k] (the product takes W^T) in [N / 2 n, 32 k] boxes; with ``a``
  // also the [64, 32] slices of a streamed A from (a_k0, a_row). ``mc``
  // false (MN only): the block loads every box of its slices itself, for
  // a B operand that differs between the cluster's blocks (the ring's
  // barriers still pair both blocks slice by slice)
  template <bool MN>
  __device__ void b(const CUtensorMap* w, int n, int k0, int n0, int nk,
                    const CUtensorMap* a = nullptr, int a_k0 = 0,
                    int a_row = 0, bool mc = true) {
    for (int s = 0; s < nk; ++s) {
      hop::mbar_wait(&ring.empty[ring.stage], ring.phase ^ 1);
      uint64_t* full = &ring.full[ring.stage];
      hop::mbar_expect_tx(full, slice_bytes(n, a != nullptr));
      unsigned char* slot = ring.slot();
      const int k = k0 + s * BK;
      const uint16_t all = (1 << CLUSTER) - 1;
      if constexpr (MN) {
        const int per = mc ? n / 64 / CLUSTER : n / 64;
        const int i0 = mc ? rank * per : 0;
        for (int i = i0; i < i0 + per; ++i)
          if (mc && CLUSTER > 1)
            hop::tma_load_mc(slot + i * 4096, w, full, n0 + 64 * i, k, all);
          else
            hop::tma_load(slot + i * 4096, w, full, n0 + 64 * i, k);
      } else {
        // two boxes of n / 2 rows of W, shared among the cluster's blocks
        for (int i = rank * 2 / CLUSTER; i < (int)(rank + 1) * 2 / CLUSTER;
             ++i) {
          if (CLUSTER > 1)
            hop::tma_load_mc(slot + i * (n / 2) * 64, w, full, k,
                             n0 + i * (n / 2), all);
          else
            hop::tma_load(slot + i * (n / 2) * 64, w, full, k,
                          n0 + i * (n / 2));
        }
      }
      if (a) hop::tma_load(slot + n * BK * 2, a, full, a_k0 + s * BK, a_row);
      ring.advance();
    }
  }

  // the [64, k] row tile from rows row0.. and columns k0.. of ``a``
  __device__ void tile(unsigned char* dst, uint64_t* bar, const CUtensorMap* a,
                       int k, int row0, int k0 = 0) {
    hop::mbar_expect_tx(bar, k * BM * 2);
    for (int p = 0; p < k / BK; ++p)
      hop::tma_load(dst + p * PANEL, a, bar, k0 + p * BK, row0);
  }
};

// ---- the consumers -------------------------------------------------------
__device__ __forceinline__ void release(hop::Ring& ring, int stage,
                                        const Thr& t) {
  if (t.lane == 0)
    for (uint32_t c = 0; c < CLUSTER; ++c)
      hop::mbar_arrive_cluster(&ring.empty[stage], c);
}

// acc (+)= A @ B over the next nk slices of the ring, N = NWG NW wide. A is
// the row tile at shared address a_tile (its panels in K order) or, with
// a_tile 0, the streamed slice after B. accumulate: add to acc instead of
// overwriting it. MN: B is MN-major in the ring.
template <int NW, bool MN>
__device__ __forceinline__ void gemm(float (&acc)[NW / 2], hop::Ring& ring,
                                     uint32_t a_tile, int nk, bool accumulate,
                                     const Thr& t) {
  int prev = -1;
  hop::fence_regs(acc);
  for (int s = 0; s < nk; ++s) {
    hop::mbar_wait(&ring.full[ring.stage], ring.phase);
    const uint32_t slot = hop::smem_u32(ring.slot());
    const uint32_t a = a_tile ? a_tile + s * PANEL : slot + NWG * NW * BK * 2;
    const uint32_t b = slot + (MN ? hop::mn_col(t.wg * NW) : t.wg * NW * 64);
    hop::wg_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      hop::wgmma<0, MN ? 1 : 0>(
          acc, hop::desc_k(a, kk),
          MN ? hop::desc_mn(b, kk) : hop::desc_k(b, kk),
          (accumulate || s > 0 || kk > 0) ? 1 : 0);
    hop::wg_commit();
    if (prev >= 0) {
      hop::wg_wait<1>();
      release(ring, prev, t);
    }
    prev = ring.stage;
    ring.advance();
  }
  hop::wg_wait<0>();
  hop::fence_regs(acc);
  release(ring, prev, t);
}

// ---- tiles in shared memory (K-major, 32-deep panels) ----------------------
__device__ __forceinline__ uint32_t tile_off(int row, int col) {
  return (col / BK) * PANEL + hop::sw64(row, col % BK);
}

__device__ __forceinline__ void st_pair(unsigned char* tile, int row, int col,
                                        float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(tile + tile_off(row, col)) =
      __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float2 ld_pair(const unsigned char* tile, int row,
                                          int col) {
  const __nv_bfloat162 v =
      *reinterpret_cast<const __nv_bfloat162*>(tile + tile_off(row, col));
  return make_float2(__bfloat162float(v.x), __bfloat162float(v.y));
}

// the sums (after the epilogue) as the next product's A: wait for both
// warpgroups to finish reading the tile, write it, make it visible to wgmma
template <int NW>
__device__ __forceinline__ void to_tile(const float (&v)[NW / 2],
                                        unsigned char* tile, const Thr& t) {
  hop::named_sync(BAR_ALL, NCONS);
  pairs<NW>(t, [&](int i, int r, int c) { st_pair(tile, r, c, v[i], v[i + 1]); });
  hop::fence_async_smem();
  hop::named_sync(BAR_ALL, NCONS);
}

// global inputs of a kernel are read-only for its lifetime: the
// non-coherent path lets the compiler issue every load of an epilogue
// ahead of its stores
__device__ __forceinline__ float2 unpack(uint32_t v) {
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&v);
  return make_float2(__bfloat162float(b.x), __bfloat162float(b.y));
}

// rows r < nvalid of a [64, W] tile to rows row0 + r of a global bf16
// [., ld] operand at column col0, in 16-byte copies, consecutive threads on
// consecutive columns of a row. After to_tile (which ends in a barrier);
// the next to_tile's barrier orders it before the tile is rewritten.
template <int W>
__device__ __forceinline__ void flush(const unsigned char* tile, bf16* g,
                                      int ld, int col0, int row0,
                                      int nvalid) {
  constexpr int NC = W / 8;
  for (int i = threadIdx.x; i < BM * NC; i += NCONS) {
    const int r = i / NC, ch = i % NC;
    if (r < nvalid)
      *reinterpret_cast<uint4*>(g + (size_t)(row0 + r) * ld + col0 + ch * 8) =
          *reinterpret_cast<const uint4*>(tile + tile_off(r, ch * 8));
  }
}

// the sums to the tile (the next product's A, or a free tile) and from it to
// a global operand
template <int NW>
__device__ __forceinline__ void emit(const float (&v)[NW / 2],
                                     unsigned char* tile, bf16* g, int ld,
                                     int row0, int nvalid, const Thr& t) {
  to_tile<NW>(v, tile, t);
  flush<NWG * NW>(tile, g, ld, 0, row0, nvalid);
}

__device__ __forceinline__ float2 ld2(const bf16* p) {
  return unpack(__ldg(reinterpret_cast<const unsigned int*>(p)));
}

__device__ __forceinline__ float ldf(const float* p) { return __ldg(p); }

__device__ __forceinline__ void st2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// the bf16 rounding of v, as a float
__device__ __forceinline__ float rbf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// the sums to a global [rows, ld] bf16 operand at column offset col0, rows
// < nvalid
template <int NW>
__device__ __forceinline__ void to_global(const float (&v)[NW / 2], bf16* g,
                                          int ld, int col0, int row0,
                                          int nvalid, const Thr& t) {
  pairs<NW>(t, [&](int i, int r, int c) {
    if (r < nvalid) st2(g + (size_t)(row0 + r) * ld + col0 + c, v[i], v[i + 1]);
  });
}

// bias rows [r0, r0 + n) of the stack (h floats each) into shared memory,
// for a pass whose epilogues read them (ordered by a later barrier)
__device__ __forceinline__ void stage_bias(float* dst, const float* bias,
                                           int r0, int n, int h) {
  for (int i = threadIdx.x; i < n * h; i += NCONS) dst[i] = bias[r0 * h + i];
}

// ahead of a product: its epilogue's bias row (h floats) into L1, and
// rows row0.. (up to nvalid, ld elements of ``bytes_per`` bytes each) of an
// input it reads into L2
__device__ __forceinline__ void prefetch_bias(const float* b, int h) {
  hop::prefetch_l1(b, h * 4, threadIdx.x, NCONS);
}

__device__ __forceinline__ void prefetch_rows(const void* g, size_t row_bytes,
                                              int row0, int nvalid) {
  if (nvalid > 0)
    hop::prefetch_l2(static_cast<const char*>(g) + row0 * row_bytes,
                     row_bytes * nvalid, threadIdx.x, NCONS);
}

// row row0 + r of a per-row input when r < nvalid, else row 0 (whose value
// the caller drops): an empty or partial block forms no address past the
// input's end, even for a load the compiler hoists above its condition
__device__ __forceinline__ int row_or0(int row0, int r, int nvalid) {
  return r < nvalid ? row0 + r : 0;
}

// the thread's two rows of a global bf16 [., ld] input and whether each is
// used: an unused row reads row 0 and is zeroed, so that every load of an
// epilogue is issued unconditionally, at a constant offset from one of two
// pointers. Rows row0 + r0 and row0 + r0 + 8 below nvalid, or two given
// rows (a row gathered by code)
struct Rows {
  const bf16* base[2];
  bool ok[2];
  int col0;
  __device__ __forceinline__ Rows(const bf16* g, int ld, int row0, int nvalid,
                                  int nw, const Thr& t) {
    const int row[2] = {row0 + t.r0, row0 + t.r0 + 8};
    const bool use[2] = {t.r0 < nvalid, t.r0 + 8 < nvalid};
    init(g, ld, row, use, nw, t);
  }
  __device__ __forceinline__ Rows(const bf16* g, int ld, const int (&row)[2],
                                  const bool (&use)[2], int nw, const Thr& t) {
    init(g, ld, row, use, nw, t);
  }
  __device__ __forceinline__ void init(const bf16* g, int ld,
                                       const int (&row)[2],
                                       const bool (&use)[2], int nw,
                                       const Thr& t) {
    col0 = t.wg * nw + t.c0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      ok[h] = use[h];
      base[h] = g + (size_t)(ok[h] ? row[h] : 0) * ld + col0;
    }
  }
  // the pair of sum index i (column c)
  __device__ __forceinline__ float2 at(int i, int c) const {
    const int h = (i / 2) % 2;
    const float2 v = ld2(base[h] + (c - col0));
    return ok[h] ? v : make_float2(0.f, 0.f);
  }
};

// acc += the pairs of the thread's two rows of ``rows``
template <int NW>
__device__ __forceinline__ void add_rows(float (&acc)[NW / 2],
                                         const Rows& rows, const Thr& t) {
  pairs_chunked<NW>(t, [&](int i, int r, int c) {
    const float2 d = rows.at(i, c);
    acc[i] += d.x;
    acc[i + 1] += d.y;
  });
}

// acc += the pairs of rows row0 + r (r < nvalid) of a global bf16 [., ld]
// input
template <int NW>
__device__ __forceinline__ void add_pairs(float (&acc)[NW / 2], const bf16* g,
                                          int ld, int row0, int nvalid,
                                          const Thr& t) {
  add_rows<NW>(acc, Rows(g, ld, row0, nvalid, NW, t), t);
}

// relu masks of the sums (of their bf16 values, as the plain version
// tests them), one bit per sum, for the same thread's later use
template <int NW>
__device__ __forceinline__ void mask_bits(const float (&v)[NW / 2],
                                          uint32_t (&m)[(NW / 2 + 31) / 32]) {
#pragma unroll
  for (int w = 0; w < (NW / 2 + 31) / 32; ++w) m[w] = 0;
#pragma unroll
  for (int i = 0; i < NW / 2; ++i)
    if (rbf(v[i]) > 0.f) m[i / 32] |= 1u << (i % 32);
}

template <int NW>
__device__ __forceinline__ void apply_mask(float (&v)[NW / 2],
                                           const uint32_t (&m)[(NW / 2 + 31) / 32]) {
#pragma unroll
  for (int i = 0; i < NW / 2; ++i)
    if (!((m[i / 32] >> (i % 32)) & 1)) v[i] = 0.f;
}

// column sums over the block's 64 rows (each row times w[row] if w) of the
// warpgroup's NW columns into out[col] (global): rows, lanes, then warps in
// a fixed order. red: shared [NWG][4][NW] floats. Columns [2 NW, h) of out
// (the encoder's padding) are zeroed by warpgroup 0. out null: no output
// (a block past the last row), the barriers still taken.
template <int NW>
__device__ __forceinline__ void colsum(const float (&v)[NW / 2], const Thr& t,
                                       float* red, float* out,
                                       const float* w = nullptr,
                                       int h = NWG * NW) {
  float* rw = red + (t.wg * 4 + t.wl) * NW;
  const float w0 = w ? w[t.r0] : 1.f, w1 = w ? w[t.r0 + 8] : 1.f;
#pragma unroll
  for (int q = 0; q < NW / 8; ++q) {
    float s0 = v[4 * q] * w0 + v[4 * q + 2] * w1;
    float s1 = v[4 * q + 1] * w0 + v[4 * q + 3] * w1;
#pragma unroll
    for (int o = 4; o < 32; o *= 2) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, o);
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    }
    if (t.lane < 4) {
      rw[8 * q + t.c0] = s0;
      rw[8 * q + t.c0 + 1] = s1;
    }
  }
  hop::named_sync(BAR_WG + t.wg, 128);
  const float* rg = red + t.wg * 4 * NW;
  if (out) {
    for (int c = threadIdx.x % 128; c < NW; c += 128)
      out[t.wg * NW + c] =
          ((rg[c] + rg[NW + c]) + rg[2 * NW + c]) + rg[3 * NW + c];
    if (t.wg == 0)
      for (int c = NWG * NW + threadIdx.x % 128; c < h; c += 128) out[c] = 0.f;
  }
  hop::named_sync(BAR_WG + t.wg, 128);
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

// the keep mask of row keys key0 + row applied to the sums in place
template <int NW>
__device__ __forceinline__ void dropout(float (&acc)[NW / 2], const Drop& d,
                                        uint32_t key0, const Thr& t) {
  if (!d.on) return;
  const uint32_t rk[2] = {d.key(key0 + t.r0), d.key(key0 + t.r0 + 8)};
  pairs<NW>(t, [&](int i, int r, int c) {
    const uint32_t k = rk[(i / 2) % 2];
    acc[i] = d.apply(acc[i], k, c);
    acc[i + 1] = d.apply(acc[i + 1], k, c + 1);
  });
}

// acc += a global bf16 cotangent's pairs after its keep mask (row keys
// key0 + row; rows r >= nvalid add nothing)
template <int NW>
__device__ __forceinline__ void add_dropped(float (&acc)[NW / 2],
                                            const bf16* g, int ld, int row0,
                                            int nvalid, const Drop& d,
                                            uint32_t key0, const Thr& t) {
  const Rows rows(g, ld, row0, nvalid, NW, t);
  uint32_t rk[2] = {0, 0};
  if (d.on) rk[0] = d.key(key0 + t.r0), rk[1] = d.key(key0 + t.r0 + 8);
  pairs_chunked<NW>(t, [&](int i, int r, int c) {
    float2 x = rows.at(i, c);
    if (d.on) {
      const uint32_t k = rk[(i / 2) % 2];
      x.x = d.apply(x.x, k, c);
      x.y = d.apply(x.y, k, c + 1);
    }
    acc[i] += x.x;
    acc[i + 1] += x.y;
  });
}

// acc[pair] += b[col] (a bias row, f32, in shared or global memory)
template <int NW>
__device__ __forceinline__ void add_bias(float (&acc)[NW / 2], const float* b,
                                         const Thr& t) {
  pairs_chunked<NW>(t, [&](int i, int r, int c) {
    const float2 v = *reinterpret_cast<const float2*>(b + c);
    acc[i] += v.x;
    acc[i + 1] += v.y;
  });
}

template <int NW>
__device__ __forceinline__ void relu(float (&acc)[NW / 2]) {
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) acc[i] = fmaxf(acc[i], 0.f);
}

// dst[s * H + c] (global f32, s < ncode) = the sum, over the tile's rows r
// in order with code[r] == s, of the tile's bf16 value (r, c): a run of
// equal codes is summed in a register, then added (codes >= ncode add
// nothing). A thread per column; after an emit (whose barrier orders it).
template <int H>
__device__ __forceinline__ void code_sums(const unsigned char* tile,
                                          const int* code, int ncode,
                                          float* dst) {
  for (int c = threadIdx.x; c < H; c += NCONS) {
    for (int s = 0; s < ncode; ++s) dst[(size_t)s * H + c] = 0.f;
    float a = 0.f;
    int cur = ncode;
    for (int r = 0; r < BM; ++r) {
      const int k = code[r];
      if (k != cur) {
        if (cur < ncode) dst[(size_t)cur * H + c] += a;
        a = 0.f;
        cur = k;
      }
      if (k < ncode)
        a += __bfloat162float(
            *reinterpret_cast<const bf16*>(tile + tile_off(r, c)));
    }
    if (cur < ncode) dst[(size_t)cur * H + c] += a;
  }
}

// kernel prologue: barriers of the ring (full: the producer's expect_tx;
// empty: one arrival per consumer warp of every block in the cluster) and
// the tile barrier, made visible to the cluster
__device__ __forceinline__ void init_barriers(Smem* sm, int stages) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      hop::mbar_init(&sm->full[s], 1);
      hop::mbar_init(&sm->empty[s], (NCONS / 32) * CLUSTER);
    }
    hop::mbar_init(&sm->abar, 1);
    hop::fence_barrier_init();
  }
  __syncthreads();
  hop::cluster_sync();
}

__device__ __forceinline__ hop::Ring make_ring(Smem* sm, unsigned char* smem,
                                               int stages, int slice) {
  hop::Ring r;
  r.full = sm->full;
  r.empty = sm->empty;
  r.base = smem + ring_offset();
  r.stride = slice;
  r.stages = stages;
  return r;
}

// the role split of a kernel on the engine: the producer warpgroup's first
// thread runs ``produce`` (Producer&, the tile barrier), the consumers
// ``consume`` (the ring, the tile barrier); both walk the same products in
// the same order. Each role ends in its own cluster barrier: the roles
// never reconverge, so that setmaxnreg holds
template <typename P, typename C>
__device__ __forceinline__ void roles(unsigned char* smem, int stages,
                                      int slice, P produce, C consume) {
  Smem* sm = reinterpret_cast<Smem*>(smem);
  init_barriers(sm, stages);
  hop::Ring ring = make_ring(sm, smem, stages, slice);
  if (threadIdx.x >= NCONS) {
    hop::reg_dealloc<PROD_REGS>();
    if (threadIdx.x == NCONS) {
      Producer pr{ring, hop::cluster_rank()};
      produce(pr, &sm->abar);
    }
    __syncwarp();
    hop::cluster_sync();
  } else {
    hop::reg_alloc<CONS_REGS>();
    consume(ring, &sm->abar);
    hop::cluster_sync();
  }
}

// ---- host --------------------------------------------------------------------
// tensor maps: W [k, n] read MN-major ([32 k, 64 n] boxes); W [n, k] read
// K-major for a product of width n_prod ([n_prod / 2 n, 32 k] boxes); a
// [rows, k] A operand ([64, 32] boxes)
inline bool map_mn(CUtensorMap* m, const void* w, int k, int n) {
  return hop::make_map(m, w, n, k, n, 64, 32);
}

inline bool map_k(CUtensorMap* m, const void* w, int n, int k, int n_prod) {
  return hop::make_map(m, w, k, n, k, 32, n_prod / 2);
}

inline bool map_a(CUtensorMap* m, const void* a, int rows, int k, int ld) {
  return hop::make_map(m, a, k, rows, ld, 32, BM);
}

// blocks of 64 rows for ``rows`` rows, a whole number of clusters
inline int grid_blocks(int rows) {
  const int b = (rows + BM - 1) / BM;
  return (b + CLUSTER - 1) / CLUSTER * CLUSTER;
}

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace eng
