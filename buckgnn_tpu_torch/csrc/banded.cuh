// The band product on the product engine (engine.cuh): the phase-1 pieces
// that the fused SAGE layer's forward (sage_layer_fwd.cu) runs before its
// weight products, and the band kernel that runs them alone, which serves
// the banded SpMM (banded_matmul.cu, the TPU kernel buckgnn_tpu/ops/
// pallas_banded.py::_kernel), the merged backward's band pass
// (sage_layer_bwd.cu, dx = bf16(band @ dagg slab + dxp)) and, through
// banded_matmul, the split backward's dx. Per node tile t (T rows) with
// slab start s_t = clip(t*T - W/2, 0, max(N - (T+W), 0)) and, with spill,
// the window start w_t (sage_common.cuh::spill_window_start):
//
//   acc = band_t @ x[s_t : s_t+T+W]                              f32
//       + sum_{m in [lo_r, hi_r)} msgs[w_t + m]                  (spill)
//       + table[gcode_r]  (the sentinel code tg adds nothing)     (table)
//       + acc_in_r                                                (acc)
//   out = out_dtype(acc)
//
// The TPU kernel applies the spill window and the table as one-hot
// selection products ([T, 256] @ window, [T, tg] @ table). The band
// kernel keeps the spill product (each row of the one-hot selects one
// contiguous run [lo, hi) of window rows, the spill list being
// receiver-sorted) but on the block's own stretch of messages only, and
// adds the one table row a row selects directly: the same f32 sum without
// the zero products.
//
// Phase 1 (shared with #1): the consumers convert the block's int8 band rows
// to bf16 (counts <= 127 are exact) straight into the K-major
// 64-byte-swizzled A tile that wgmma reads (`build_a`), with one-hot
// selector columns after them. K is cut into runs (`Geo`: the slab; #1's
// star table window's one or two row runs; the band kernel's spill
// messages), each a whole number of 32-deep slices; A's columns past a
// run's rows are zero, so the extra B rows a slice carries add exact
// zeros. The slab's rows stream by TMA through the engine's ring as
// MN-major [32 k, 64 n] boxes, multicast to both blocks of a cluster when
// they lie in one node tile (T % 128 == 0), else each block loads its
// own. `add_spill` adds a thread's two rows' spill runs to #1's
// accumulator registers.
//
// What bounds the band kernel on an H100: at the virtual-edge shape
// (N = 103,424, T = 256, W = 64, H = 512, Es = 34,176) the band product is
// 34 GFLOP of bf16 products (0.034 ms at 989 TFLOP/s) against ~0.39 GB of
// compulsory traffic (x, acc and out 106 MB each, the band 33 MB, the
// messages 35 MB): 0.115 ms at 3.35 TB/s, so it is bound by bytes (0.105 ms
// as #2's band pass, without the messages). The design keeps every input
// on the asynchronous path and HBM busy:
//  - persistent clusters, as many as fit (one per SM pair), walk the
//    128-row tile pairs in a fixed stride (cluster c takes pairs c, c + C,
//    ...), so the clusters together sweep x in order through L2 and every
//    cluster's producer runs into the next pair while its consumers finish
//    the current epilogue;
//  - per pair, each block's ring carries, by TMA: its band rows (int8
//    [64, 64] boxes, converted from shared memory), the slab, the spill
//    messages that its rows' runs cover (as a one-hot selector run of the
//    product; both blocks walk the larger of their two counts) and its acc
//    rows ([64, 32] panels, added to the registers from shared memory);
//    so no load of the epilogue waits on device memory but the table row
//    by code;
//  - a bf16 output leaves through a staging tile in 16-byte rows; the
//    staging tile aliases the A tile (the product is done with it).
// Shared memory at H = 512, T + W = 320: 2 KB of slack and barriers, ring
// slices of 32 KB and the A / staging region of 64 KB: 5 slices, 226 KB of
// 227 (with spill the A tile may take 8 more panels, 72 KB, and 4 slices).
// One block writes each output row, without float atomics: two runs give
// the same bits.

#pragma once

#include <algorithm>

#include "engine.cuh"

namespace banded {

using eng::BK;
using eng::BM;
using eng::NCONS;
using eng::NTHREADS;
using eng::NWG;
using eng::PANEL;
using eng::Thr;
typedef __nv_bfloat16 bf16;

// ---- phase 1 ------------------------------------------------------------------
// what a run of phase 1's K multiplies: the slab of x (the band counts), a
// star table window (one-hot by code) or spill messages (one-hot by run)
enum Src { SLAB = 0, TABLE = 1, SPILL = 2 };

// one run of phase 1's K: rows [row, row + rows) of its source, in
// ceil(rows / 32) slices; a table run's A columns select codes [code0,
// code0 + rows), a spill run's the window columns [code0, code0 + rows)
struct Run {
  int src, row, rows, code0;
};

__host__ __device__ constexpr int slices(int rows) {
  return (rows + BK - 1) / BK;
}

// phase 1's K runs of a block in node tile t: the clamped slab, then any
// star table window (`add_table`) or spill messages (`add_messages`)
struct Geo {
  Run run[3];
  int nrun, nk1;
  __host__ __device__ Geo(int n, int tile, int width, int t) {
    const int s = tile + width;
    const int hi = n - s > 0 ? n - s : 0;
    const int want = t * tile - width / 2;
    const int start = want < 0 ? 0 : (want > hi ? hi : want);
    run[0] = {SLAB, start, s, 0};
    nrun = 1;
    nk1 = slices(s);
  }
  __host__ __device__ void add(const Run& r) {
    run[nrun++] = r;
    nk1 += slices(r.rows);
  }
  // the star selection: rows wb.. and t0 + wb.. of the table (gw each), or
  // with ``whole`` the whole table, 2 gw rows (GW == T0)
  __host__ __device__ void add_table(int gw, int t0, int wb, bool whole) {
    if (whole) {
      add({TABLE, 0, 2 * gw, 0});
    } else {
      add({TABLE, wb, gw, 0});
      add({TABLE, t0 + wb, gw, gw});
    }
  }
  // spill messages [row, row + rows), window columns from code0
  __host__ __device__ void add_messages(int row, int rows, int code0) {
    add({SPILL, row, rows, code0});
  }
};

// the phase-1 A tile [64, 32 nk1]: the slab's columns k < s from
// ``band(r, k)`` (the 8 int8 counts of block row r from column k) as bf16
// (counts <= 127 are exact), then each selector run's one-hot columns: a
// table run's select the row's code scode[r], a spill run's the row's
// message run [slo[r], shi[r]); zero past each run's rows
template <typename Band>
__device__ __forceinline__ void build_a(unsigned char* a, int s, const Geo& g,
                                        const int* scode, const int* slo,
                                        const int* shi, Band band) {
  const int per_row = g.nk1 * BK / 8;  // 8-column chunks of a row
  const int slab_cols = slices(s) * BK;
  for (int i = threadIdx.x; i < BM * per_row; i += NCONS) {
    const int r = i / per_row, k = (i % per_row) * 8;
    uint4 out;
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
    if (k < slab_cols) {
      const uint2 b = k < s ? band(r, k) : make_uint2(0u, 0u);
      const int8_t* v = reinterpret_cast<const int8_t*>(&b);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        o[j] = __floats2bfloat162_rn((float)v[2 * j], (float)v[2 * j + 1]);
    } else {
      int col = slab_cols, ri = 1;
      while (k >= col + slices(g.run[ri].rows) * BK)
        col += slices(g.run[ri++].rows) * BK;
      const Run& run = g.run[ri];
      const int kk = k - col;
      int lo, hi;  // the row's selected columns of the run
      if (run.src == TABLE) {
        lo = scode[r] - run.code0;
        hi = lo + 1;
      } else {
        lo = slo[r] - run.code0;
        hi = shi[r] - run.code0;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c0 = kk + 2 * j;
        o[j] = __floats2bfloat162_rn(
            c0 < run.rows && lo <= c0 && c0 < hi ? 1.f : 0.f,
            c0 + 1 < run.rows && lo <= c0 + 1 && c0 + 1 < hi ? 1.f : 0.f);
      }
    }
    *reinterpret_cast<uint4*>(a + eng::tile_off(r, k)) = out;
  }
  hop::fence_async_smem();
}

// acc += the f32 sums of the thread's two rows' message runs [lo, hi) of
// the window at ws, each run summed on its own first in message order,
// four column groups at a time
template <int NW, int H>
__device__ __forceinline__ void add_spill(float (&acc)[NW / 2],
                                          const bf16* msgs, int ws,
                                          const int (&lo)[2],
                                          const int (&hi)[2], const Thr& t) {
  constexpr int CQ = 4;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int q0 = 0; q0 < NW / 8; q0 += CQ) {
      float s[CQ][2] = {};
      for (int m = lo[h]; m < hi[h]; ++m) {
        const bf16* row = msgs + (size_t)(ws + m) * H + t.wg * NW + t.c0;
#pragma unroll
        for (int q = 0; q < CQ; ++q) {
          const float2 v = eng::ld2(row + 8 * (q0 + q));
          s[q][0] += v.x;
          s[q][1] += v.y;
        }
      }
#pragma unroll
      for (int q = 0; q < CQ; ++q) {
        acc[4 * (q0 + q) + 2 * h] += s[q][0];
        acc[4 * (q0 + q) + 2 * h + 1] += s[q][1];
      }
    }
}

// ---- the band kernel -----------------------------------------------------------
#define BAND_CLUSTER __cluster_dims__(2, 1, 1)
static_assert(eng::CLUSTER == 2, "BAND_CLUSTER names the cluster size");

constexpr int SMEM_MAX = 232448;  // dynamic shared memory of a block (H100)
constexpr int MAX_STAGES = 8;     // ring slices (eng::Smem has 8 barriers)
constexpr int PAIR = eng::CLUSTER * BM;  // rows of a cluster's tile pair
constexpr int BOX = 4096;         // a band box [64, 64] int8, an acc panel
constexpr int MAX_SPILL = 8;      // spill slices of a block (a 256-row window)

struct Params {
  CUtensorMap x_map;     // x [N, H] read MN-major
  CUtensorMap band_map;  // band [N, T+W] int8 in [64, 64] boxes
  CUtensorMap msgs_map;  // msgs [Es, H] read MN-major (spill)
  CUtensorMap acc_map;   // acc [N, H] in [64, 32] K-major panels (acc)
  const bf16* x;         // [N, H]
  const int8_t* band;    // [N, T+W] (tile t = rows t*T .. t*T+T)
  const bf16* msgs;      // [Es, H] receiver-sorted spill messages
  const int* off;        // [n_tiles + 1] spill offsets (spill)
  const int* lo;         // [N] first window column of each row (spill)
  const int* hi;         // [N] end window column of each row (spill)
  const int* gcode;      // [N] table row of each row, tg = none (table)
  const bf16* table;     // [tg, H] (table)
  const bf16* acc;       // [N, H] added before the cast (acc)
  void* out;             // [N, H] bf16 or f32
  int n, tile, width, n_spill, tg, has_spill, has_table, has_acc, out_f32;
  int stages;            // ring slices (set by `launch`)
};

// ring slots of an item of nbox 4 KB boxes (the band rows, the acc rows)
__host__ __device__ constexpr int item_slots(int nbox, int slice) {
  return (nbox + slice / BOX - 1) / (slice / BOX);
}

__host__ __device__ constexpr int band_boxes(int s) { return (s + 63) / 64; }

// the producer's share of an item: nbox boxes of ``map`` at columns
// i * w, rows from row0, SLICE / 4 KB of them a ring slot (a box past the
// tensor's end fills zeros)
__device__ __forceinline__ void load_item(eng::Producer& pr,
                                          const CUtensorMap* map, int nbox,
                                          int w, int row0, int slice) {
  hop::Ring& ring = pr.ring;
  const int per = slice / BOX;
  for (int b0 = 0; b0 < nbox; b0 += per) {
    hop::mbar_wait(&ring.empty[ring.stage], ring.phase ^ 1);
    const int k = min(per, nbox - b0);
    uint64_t* full = &ring.full[ring.stage];
    hop::mbar_expect_tx(full, k * BOX);
    for (int i = 0; i < k; ++i)
      hop::tma_load(ring.slot() + i * BOX, map, full, (b0 + i) * w, row0);
    ring.advance();
  }
}

// the spill messages of rows [row0, row0 + rows) of one node tile: the
// first message row, the window column of the first run and the slices
// that hold the runs (none past N). The spill list is receiver-sorted, so
// the rows' runs are one stretch [lo[row0], hi[row0 + rows - 1]) of the
// tile's window
struct Spill {
  int row, code0, nk;
  __device__ __forceinline__ Spill(const Params& p, int row0, int rows) {
    const bool valid = row0 < p.n;
    const int t = min(row0 / p.tile, p.n / p.tile - 1);
    const int first = eng::row_or0(row0, 0, valid ? rows : 0);
    const int last = eng::row_or0(row0, rows - 1, valid ? rows : 0);
    const int ws = sage::spill_window_start(p.off[t], p.n_spill);
    const int lo0 = p.lo[first], hi1 = p.hi[last];
    row = valid ? ws + lo0 : 0;
    code0 = valid ? lo0 : 0;
    nk = valid ? slices(hi1 - lo0) : 0;
  }
};

// the spill slices of tile pair q for block ``rank``: its own runs, as
// many slices as the larger of the two blocks' (both walk the same ring
// slices)
__device__ __forceinline__ Spill pair_spill(const Params& p, int q, int rank) {
  Spill own(p, q * PAIR + rank * BM, BM);
  const Spill peer(p, q * PAIR + (1 - rank) * BM, BM);
  own.nk = max(own.nk, peer.nk);
  return own;
}

template <int H>
__global__ void BAND_CLUSTER __launch_bounds__(NTHREADS, 1)
    band_kernel(const __grid_constant__ Params p) {
  constexpr int NW = H / NWG;
  constexpr int SLICE = eng::slice_bytes(H, false);
  constexpr int PER = SLICE / BOX;     // boxes or panels a ring slot
  constexpr int ACC_SLOTS = item_slots(H / BK, SLICE);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = eng::align_smem(smem_raw);
  int* slo = reinterpret_cast<int*>(smem + 512);  // the block's spill runs
  int* shi = slo + BM;
  // the A tile, and after each product the output staging tile
  unsigned char* tile = smem + eng::ring_offset() + p.stages * SLICE;
  const int s = p.tile + p.width;
  const int nbox = band_boxes(s);
  const int band_slots = item_slots(nbox, SLICE);
  const int n_tiles = p.n / p.tile;
  const int n_pairs = (p.n + PAIR - 1) / PAIR;
  const int cluster = blockIdx.x / eng::CLUSTER;
  const int n_clusters = gridDim.x / eng::CLUSTER;
  const int rank = blockIdx.x % eng::CLUSTER;
  // the two blocks of a pair lie in one node tile: one slab, multicast
  const bool mc = p.tile % PAIR == 0;
  // per pair, each block's ring walks the same slots: its band rows, the
  // slab, the spill slices (the pair's larger count) and its acc rows
  eng::roles(
      smem, p.stages, SLICE,
      [&](eng::Producer& pr, uint64_t*) {
        for (int q = cluster; q < n_pairs; q += n_clusters) {
          const int row0 = q * PAIR + rank * BM;
          // an empty block (N / 64 odd) loads the first rows and the last
          // tile's slab, and drops what it computes
          const int rowc = row0 < p.n ? row0 : 0;
          const int t = min(row0 / p.tile, n_tiles - 1);
          const Geo g(p.n, p.tile, p.width, t);
          load_item(pr, &p.band_map, nbox, 64, rowc, SLICE);
          pr.b<true>(&p.x_map, H, g.run[0].row, 0, g.nk1, nullptr, 0, 0, mc);
          if (p.has_spill) {
            const Spill sp = pair_spill(p, q, rank);
            pr.b<true>(&p.msgs_map, H, sp.row, 0, sp.nk, nullptr, 0, 0,
                       false);
          }
          if (p.has_acc) load_item(pr, &p.acc_map, H / BK, BK, rowc, SLICE);
        }
      },
      [&](hop::Ring& ring, uint64_t*) {
        Thr th;
        // the next n ring slots, once full (from stage st0 on, wrapping);
        // handed back by give once the warp has read them
        int st0 = 0;
        auto take = [&](int n) {
          st0 = ring.stage;
          for (int i = 0; i < n; ++i) {
            hop::mbar_wait(&ring.full[ring.stage], ring.phase);
            ring.advance();
          }
        };
        auto slot = [&](int i) {
          return ring.base + (size_t)((st0 + i) % ring.stages) * ring.stride;
        };
        auto give = [&](int n) {
          __syncwarp();
          for (int i = 0; i < n; ++i)
            eng::release(ring, (st0 + i) % ring.stages, th);
        };
        for (int q = cluster; q < n_pairs; q += n_clusters) {
          const int row0 = q * PAIR + rank * BM;
          const bool valid = row0 < p.n;
          const int nvalid = valid ? BM : 0;
          // an empty block reads the first rows' inputs (and drops them):
          // no address it forms lies past the end, even for a hoisted load
          const int rowc = valid ? row0 : 0;
          const int t = min(row0 / p.tile, n_tiles - 1);
          Geo g(p.n, p.tile, p.width, t);
          // every warpgroup is done with the last pair's tile (its product
          // and its flushed output) and its spill runs
          hop::named_sync(eng::BAR_ALL, NCONS);
          if (p.has_spill) {
            const Spill sp = pair_spill(p, q, rank);
            g.add_messages(sp.row, sp.nk * BK, sp.code0);
            if (threadIdx.x < BM) {
              const int r = rowc + threadIdx.x;
              const int lo = p.lo[r], hi = p.hi[r];
              slo[threadIdx.x] = valid ? lo : 0;
              shi[threadIdx.x] = valid ? hi : 0;
            }
            hop::named_sync(eng::BAR_ALL, NCONS);
          }
          // phase 1's A tile: the band rows from their ring slots
          take(band_slots);
          build_a(tile, s, g, nullptr, slo, shi, [&](int r, int k) {
            const int b = k / 64;
            return *reinterpret_cast<const uint2*>(
                slot(b / PER) + (b % PER) * BOX + r * 64 + k % 64);
          });
          give(band_slots);
          hop::named_sync(eng::BAR_ALL, NCONS);
          // acc = [band | sel] @ [x slab ; spill messages]
          float acc[NW / 2];
          eng::gemm<NW, true>(acc, ring, hop::smem_u32(tile), g.nk1, false,
                              th);
          if (p.has_table) {
            int code[2];
            bool use[2];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              code[h] = __ldg(p.gcode + rowc + th.r0 + 8 * h);
              use[h] = valid && code[h] < p.tg;
            }
            eng::add_rows<NW>(acc, eng::Rows(p.table, H, code, use, NW, th),
                              th);
          }
          if (p.has_acc) {  // the acc rows from their ring slots
            take(ACC_SLOTS);
            eng::pairs_chunked<NW>(th, [&](int i, int r, int c) {
              const int pn = c / BK;
              const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(
                  slot(pn / PER) + (pn % PER) * BOX + hop::sw64(r, c % BK));
              acc[i] += __bfloat162float(v.x);
              acc[i + 1] += __bfloat162float(v.y);
            });
            give(ACC_SLOTS);
          }
          if (p.out_f32) {
            float* out = static_cast<float*>(p.out);
            eng::pairs<NW>(th, [&](int i, int r, int c) {
              if (valid)
                *reinterpret_cast<float2*>(out + (size_t)(row0 + r) * H + c) =
                    make_float2(acc[i], acc[i + 1]);
            });
          } else {
            eng::emit<NW>(acc, tile, static_cast<bf16*>(p.out), H, row0,
                          nvalid, th);
          }
        }
      });
}

// persistent clusters of the launch: as many as can run at once (counted
// once per shared-memory size), at most one per tile pair
template <int H>
cudaError_t clusters(int smem, int n_pairs, int* out) {
  static int known_smem = -1, known = 0;
  if (smem != known_smem) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(eng::CLUSTER * n_pairs);
    cfg.blockDim = dim3(NTHREADS);
    cfg.dynamicSmemBytes = smem;
    int active = 0;
    cudaError_t e = cudaOccupancyMaxActiveClusters(
        &active, (const void*)band_kernel<H>, &cfg);
    if (e != cudaSuccess) return e;
    if (active < 1) return cudaErrorInvalidConfiguration;
    known_smem = smem;
    known = active;
  }
  *out = std::min(known, n_pairs);
  return cudaSuccess;
}

// the band kernel on p (its tensor maps and ring slices filled in here)
template <int H>
cudaError_t launch(Params p, cudaStream_t stream) {
  constexpr int SLICE = eng::slice_bytes(H, false);
  const int s = p.tile + p.width;
  bool ok = p.n % BM == 0 && eng::map_mn(&p.x_map, p.x, p.n, H) &&
            hop::make_map_bytes(&p.band_map, p.band, s, p.n, 64, BM);
  if (p.has_spill) ok = ok && eng::map_mn(&p.msgs_map, p.msgs, p.n_spill, H);
  if (p.has_acc) ok = ok && eng::map_a(&p.acc_map, p.acc, p.n, H, H);
  const int items = std::max(item_slots(band_boxes(s), SLICE),
                             item_slots(H / BK, SLICE));
  if (!ok) return cudaErrorInvalidValue;
  const int panels = slices(s) + (p.has_spill ? MAX_SPILL : 0);
  const int region = std::max(eng::tile_bytes(H), panels * PANEL);
  const int fixed = 1024 + eng::ring_offset() + region;
  p.stages = std::min(MAX_STAGES, (SMEM_MAX - fixed) / SLICE);
  if (p.stages < std::max(items, 2)) return cudaErrorInvalidValue;
  const int smem = fixed + p.stages * SLICE;
  cudaError_t e = eng::set_smem(band_kernel<H>, smem);
  if (e != cudaSuccess) return e;
  int n_clusters;
  e = clusters<H>(smem, (p.n + PAIR - 1) / PAIR, &n_clusters);
  if (e != cudaSuccess) return e;
  band_kernel<H><<<eng::CLUSTER * n_clusters, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace banded
