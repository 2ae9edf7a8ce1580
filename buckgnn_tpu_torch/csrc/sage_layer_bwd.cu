// Fused GraphSAGE layer backward for Hopper (sm_90a): the merged backward
// (batches without spill edges) and the split backward's tile kernel
// (batches with spill edges).
//
// sage_layer_bwd replaces the TPU kernel buckgnn_tpu/ops/
// pallas_sage_layer.py::_bwd_merged_kernel (launched by _call_bwd_merged).
// sage_layer_bwd_tile replaces _bwd_kernel (launched by _call_bwd_tile):
// passes 1, 3 and 4 below without apply_prev (the caller adds the next
// layer's table to dz) and without the band pass (the caller runs
// banded_matmul.cu on dagg, with the spill window, the own star and dxp);
// dagg and dxp are its outputs, and the own star table is summed by the
// global accumulate codes over the whole table (gw = T0, one window at
// base 0), from the bf16 dagg as on the TPU. From the forward's
// residuals y (bf16), inv (f32, one per row) and agg (bf16), for each row:
//
//   dz_eff = dz + bf16(table_prev)[code]          (apply_prev: the next
//            layer's deferred star table; the sentinel code adds nothing)
//   dz_eff = keep ? dz_eff * scale : 0            (dropout mask regenerated
//            from the seeds, sage_common.cuh::dropout_bits)
//   dy     = y > 0 ? dz_eff : 0
//   dout   = (dy - y * rowsum(dy * y)) * inv      f32
//   dagg   = bf16(bf16(dout) @ W_l^T)
//   dxp    = bf16(bf16(dout) @ W_r^T (+ dz_eff with the skip))
//   dx     = bf16(dxp + band_t @ dagg[s_t : s_t + T+W])    (the forward's
//            band and clamped slab starts: the adjacency is symmetric)
//   dW_l   = agg^T @ bf16(dout),  dW_r = x^T @ bf16(dout),  db_l = sum(dout)
//   town   = per-graph star table of dagg by accumulate code (f32)
//
// The TPU kernel leans on its sequential grid three times: a dagg ring with
// the band product one step behind, dW/db set at step 0 and added to after,
// and the star table accumulated in scratch. CUDA blocks run in parallel
// and in no order, so the work is split into passes on one stream:
//   1. tile pass, one block per 64 rows: dout, dagg and dxp to device
//      memory in bf16, plus per-block f32 partials of db_l and of the star
//      table;
//   2. band pass: dx = bf16(band @ dagg slab + dxp), the band kernel of
//      banded.cuh with its acc add (the banded SpMM's kernel: #1's phase 1
//      alone, from the shared phase-1 header, on persistent clusters);
//   3. weight pass: agg^T @ dout and x^T @ dout, each split over a fixed
//      number of row chunks (split-K), f32 partials per chunk
//      (atb.cuh::atb, the EA backward's weight pass too);
//   4. reductions of the dW, db and table partials, each in a fixed order.
// No float atomics: two runs give the same bits.
//
// What bounds it on an H100: at the flagship shape (N = 103,424, T = 256,
// W = 64, H = 512, 2GW = 32) a call does ~257 GFLOP of products against
// ~0.56 GB of compulsory traffic, so it is bound by operations (~0.26 ms at
// 989 TFLOP/s). This design also writes and reads dagg, dxp and dout
// (~318 MB each way) and the table partials, a known cost: the TPU kernel
// keeps dagg in VMEM. The split tile kernel at the virtual-edge shape (the
// same N, T, W and H, no supernodes) does ~217 GFLOP (0.22 ms at 989
// TFLOP/s) against ~0.64 GB of compulsory traffic (dz, y, agg, x read;
// dagg, dxp written: 0.19 ms at 3.35 TB/s), so it is bound by operations
// too; it also writes and reads dout.
//
// The tile pass runs on the product engine of engine.cuh: one block of
// four consumer warpgroups (H/4 columns each) and a producer warp per 64
// rows, in clusters of two neighbouring blocks. The producer first brings
// the block's y and dz rows by TMA into the row tile and the staging tile.
// The dout prologue works in the wgmma accumulator layout, on a thread's
// two rows and its column pairs: dz_eff (dz, the next layer's table row,
// the keep mask), the relu mask of y, s = sum(dy * y) over the thread's
// pairs, its quad, then the four warpgroups through shared memory in a
// fixed order, and dout. bf16
// dout goes into the swizzled row tile, the A of both products, and from
// there to device memory (the weight pass reads it); db_l's partial is a
// fixed-order column sum of the f32 dout. Then dxp = dout @ W_r^T (+ dz_eff
// with the skip) and dagg = bf16(dout @ W_l^T): the producer streams W_r's
// and then W_l's K-major slices of the same [in, out] tensors (the
// descriptor transposes), multicast to both blocks of the cluster, so the
// second product's slices arrive while the first epilogue runs. dxp leaves
// through a staging tile and dagg through the row tile, in 16-byte rows;
// the own-table partials are summed from the bf16 dagg in the tile by
// accumulate code, in row order (engine.cuh::code_sums). Shared memory at
// H = 512: 2 KB of slack, barriers and codes, 3 ring slices of 32 KB, the
// row tile (y, then the column sums, dout and dagg) and the staging tile
// (dz, then dxp), 64 KB each, and 1 KB of row sums: all 227 KB.

#include <algorithm>

#include "atb.cuh"
#include "banded.cuh"
#include "engine.cuh"

namespace {

using eng::BK;
using eng::BM;
using eng::NCONS;
using eng::NTHREADS;
using eng::NWG;
using eng::Thr;
using splitk::KSPLIT;  // row chunks of the weight pass

typedef __nv_bfloat16 bf16;

#define SAGE_CLUSTER __cluster_dims__(2, 1, 1)
static_assert(eng::CLUSTER == 2, "SAGE_CLUSTER names the cluster size");
static_assert(sizeof(eng::Smem) <= 512, "barriers before the codes");

constexpr int SMEM_MAX = 232448;  // dynamic shared memory of a block (H100)
constexpr int MAX_STAGES = 4;

struct Params {
  CUtensorMap w_l_t, w_r_t;  // W_l, W_r [H, H] read K-major (W^T)
  CUtensorMap y_t, dz_t;     // y, dz [N, H] in [64, 32] row-tile boxes
  const bf16* dz;        // [N, H]
  const bf16* y;         // [N, H]
  const float* inv;      // [N]
  const bf16* agg;       // [N, H]
  const bf16* x;         // [N, H]
  const bf16* w_l;       // [H, H] (in, out)
  const bf16* w_r;       // [H, H] (in, out)
  const int8_t* band;    // [N, T+W]
  const bf16* tprev;     // [tg, H] next layer's deferred table (apply_prev)
  const int* code;       // [N] selector codes (apply_prev), 2GW = none
  const int* gwin;       // [n_tiles] window bases, or null (wb = 0)
  const int* acc_code;   // [N] accumulate codes (has_super), 2GW = none
  bf16* dout;            // [N, H] scratch
  bf16* dagg;            // [N, H] scratch
  bf16* dxp;             // [N, H] scratch
  bf16* dx;              // [N, H]
  float* db_part;        // [N / BM, H]
  float* t_part;         // [N / BM, 2GW, H] (has_super)
  float* dw_part;        // [2, KSPLIT, H, H]
  int n, tile, width, gw, t0, apply_prev, has_super, skip, stages;
  eng::Drop drop;
};

// the table row that a selector code picks in tile t's window, or -1
__device__ __forceinline__ int table_row(const Params& p, int code, int wb) {
  if (!p.apply_prev || code >= 2 * p.gw) return -1;
  return code < p.gw ? wb + code : p.t0 + wb + (code - p.gw);
}

// ---- pass 1: the tile pass ------------------------------------------------
template <int H>
__global__ void SAGE_CLUSTER __launch_bounds__(NTHREADS, 1)
    bwd_tile_kernel(const __grid_constant__ Params p) {
  constexpr int NW = H / NWG, NK = H / BK;
  constexpr int SLICE = eng::slice_bytes(H, false);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = eng::align_smem(smem_raw);
  int* strow = reinterpret_cast<int*>(smem + 512);
  int* sacc = strow + BM;
  unsigned char* tile = smem + eng::ring_offset() + p.stages * SLICE;
  unsigned char* stage = tile + eng::tile_bytes(H);
  float* rowred = reinterpret_cast<float*>(stage + eng::tile_bytes(H));
  const int row0 = blockIdx.x * BM;
  const bool valid = row0 < p.n;  // the last cluster's second block may be empty
  const int nvalid = valid ? BM : 0;
  // an empty block reads the first rows' inputs (and drops them): no
  // address it forms lies past the end, even for a load the compiler hoists
  const int rowc = valid ? row0 : 0;
  const int g2 = 2 * p.gw;
  eng::roles(
      smem, p.stages, SLICE,
      [&](eng::Producer& pr, uint64_t* abar) {
        // y into the row tile and dz into the staging tile, then W_r's and
        // W_l's slices
        hop::mbar_expect_tx(abar, 2 * eng::tile_bytes(H));
        for (int q = 0; q < NK; ++q) {
          hop::tma_load(tile + q * eng::PANEL, &p.y_t, abar, q * BK, row0);
          hop::tma_load(stage + q * eng::PANEL, &p.dz_t, abar, q * BK, row0);
        }
        pr.b<false>(&p.w_r_t, H, 0, 0, NK);
        pr.b<false>(&p.w_l_t, H, 0, 0, NK);
      },
      [&](hop::Ring& ring, uint64_t* abar) {
        Thr th;
        if (threadIdx.x < BM) {
          const int r = rowc + threadIdx.x;
          const int wb = p.gwin ? p.gwin[r / p.tile] : 0;
          strow[threadIdx.x] =
              valid && p.apply_prev ? table_row(p, p.code[r], wb) : -1;
          sacc[threadIdx.x] = valid && p.has_super ? p.acc_code[r] : g2;
        }
        hop::named_sync(eng::BAR_ALL, NCONS);
        const bf16* tp[2];
        uint32_t rk[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int tr = strow[th.r0 + 8 * h];
          tp[h] = tr >= 0 ? p.tprev + (size_t)tr * H : nullptr;
          rk[h] = p.drop.on ? p.drop.key(row0 + th.r0 + 8 * h) : 0u;
        }
        // dz_eff of the pair at sum index i, (row r, column c) before the
        // relu mask: dz from the staging tile, the next layer's table row
        auto dz_eff = [&](int i, int r, int c) {
          const int h = (i / 2) % 2;
          float2 d = eng::ld_pair(stage, r, c);
          if (tp[h]) {
            const float2 v = eng::ld2(tp[h] + c);
            d.x += v.x;
            d.y += v.y;
          }
          if (p.drop.on) {
            d.x = p.drop.apply(d.x, rk[h], c);
            d.y = p.drop.apply(d.y, rk[h], c + 1);
          }
          return d;
        };
        hop::mbar_wait(abar, 0);  // y and dz have landed

        // dy = y > 0 ? dz_eff : 0; s = rowsum(dy * y): the thread's pairs,
        // its quad, then the warpgroups in a fixed order
        float acc[NW / 2];
        float s[2] = {0.f, 0.f};
        eng::pairs_chunked<NW>(th, [&](int i, int r, int c) {
          const float2 d = dz_eff(i, r, c);
          const float2 yv = eng::ld_pair(tile, r, c);
          acc[i] = yv.x > 0.f ? d.x : 0.f;
          acc[i + 1] = yv.y > 0.f ? d.y : 0.f;
          const int h = (i / 2) % 2;
          s[h] += acc[i] * yv.x;
          s[h] += acc[i + 1] * yv.y;
        });
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          s[h] += __shfl_xor_sync(0xffffffffu, s[h], 1);
          s[h] += __shfl_xor_sync(0xffffffffu, s[h], 2);
          if (th.lane % 4 == 0) rowred[th.wg * BM + th.r0 + 8 * h] = s[h];
        }
        hop::named_sync(eng::BAR_ALL, NCONS);
        float rs[2], iv[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = th.r0 + 8 * h;
          rs[h] = ((rowred[r] + rowred[BM + r]) + rowred[2 * BM + r]) +
                  rowred[3 * BM + r];
          const float v = eng::ldf(p.inv + rowc + r);
          iv[h] = valid ? v : 0.f;
        }
        // dout = (dy - y * s) * inv, f32
        eng::pairs_chunked<NW>(th, [&](int i, int r, int c) {
          const int h = (i / 2) % 2;
          const float2 yv = eng::ld_pair(tile, r, c);
          acc[i] = (acc[i] - yv.x * rs[h]) * iv[h];
          acc[i + 1] = (acc[i + 1] - yv.y * rs[h]) * iv[h];
        });
        // db_l partial: fixed-order column sums of the f32 dout, through
        // the row tile once every warpgroup has read its y
        hop::named_sync(eng::BAR_ALL, NCONS);
        eng::colsum<NW>(acc, th, reinterpret_cast<float*>(tile),
                        valid ? p.db_part + (size_t)blockIdx.x * H : nullptr);
        // bf16 dout: the row tile (both products' A) and the weight pass's
        eng::emit<NW>(acc, tile, p.dout, H, row0, nvalid, th);

        // dxp = bf16(dout @ W_r^T (+ dz_eff with the skip))
        eng::gemm<NW, false>(acc, ring, hop::smem_u32(tile), NK, false, th);
        if (p.skip)
          eng::pairs_chunked<NW>(th, [&](int i, int r, int c) {
            const float2 d = dz_eff(i, r, c);
            acc[i] += d.x;
            acc[i + 1] += d.y;
          });
        eng::emit<NW>(acc, stage, p.dxp, H, row0, nvalid, th);

        // dagg = bf16(dout @ W_l^T); the own table from the bf16 dagg
        eng::gemm<NW, false>(acc, ring, hop::smem_u32(tile), NK, false, th);
        eng::emit<NW>(acc, tile, p.dagg, H, row0, nvalid, th);
        if (p.has_super && valid)
          eng::code_sums<H>(tile, sacc, g2,
                            p.t_part + (size_t)blockIdx.x * g2 * H);
      });
}

template <int H>
cudaError_t launch_tile(Params p, cudaStream_t st) {
  constexpr int SLICE = eng::slice_bytes(H, false);
  constexpr int FIXED =
      1024 + eng::ring_offset() + 2 * eng::tile_bytes(H) + NWG * BM * 4;
  static_assert(NWG * 4 * (H / NWG) * 4 <= eng::tile_bytes(H),
                "the column sums fit the row tile");
  p.stages = std::min(MAX_STAGES, (SMEM_MAX - FIXED) / SLICE);
  const int smem = FIXED + p.stages * SLICE;
  if (!eng::map_k(&p.w_l_t, p.w_l, H, H, H) ||
      !eng::map_k(&p.w_r_t, p.w_r, H, H, H) ||
      !eng::map_a(&p.y_t, p.y, p.n, H, H) ||
      !eng::map_a(&p.dz_t, p.dz, p.n, H, H))
    return cudaErrorInvalidValue;
  cudaError_t e = eng::set_smem(bwd_tile_kernel<H>, smem);
  if (e != cudaSuccess) return e;
  bwd_tile_kernel<H><<<eng::grid_blocks(p.n), NTHREADS, smem, st>>>(p);
  return cudaGetLastError();
}

// passes 3 and 4: dW_l = agg^T @ dout and dW_r = x^T @ dout (atb.cuh, one
// launch, one half of dw_part each), db and (has_super) the own table from
// the partials
template <int H>
cudaError_t launch_weights(const Params& p, float* dwl, float* dwr,
                           float* db, float* town, int tg, cudaStream_t st) {
  cudaError_t e;
  splitk::Jobs jobs;
  jobs.add(p.agg, H, H, p.dout, H, H, p.n, dwl);
  jobs.add(p.x, H, H, p.dout, H, H, p.n, dwr);
  if ((e = splitk::atb(jobs, p.dw_part, st)) != cudaSuccess) return e;
  if ((e = splitk::bias_reduce(p.db_part, p.n / BM, 1, 1, {{0}}, H, db,
                               st)) != cudaSuccess)
    return e;
  if (p.has_super) {
    dim3 grid((H + 255) / 256, tg);
    sage::table_reduce_kernel<<<grid, 256, 0, st>>>(
        p.t_part, p.gwin, town, p.n / p.tile, p.tile / BM, p.gw, p.t0, H);
  }
  return cudaGetLastError();
}

template <int H>
cudaError_t launch(Params p, float* dwl, float* dwr, float* db, float* town,
                   int tg, cudaStream_t st) {
  cudaError_t e = launch_tile<H>(p, st);
  if (e != cudaSuccess) return e;
  banded::Params bp = {};  // pass 2: dx = bf16(band @ dagg slab + dxp)
  bp.x = p.dagg;
  bp.band = p.band;
  bp.acc = p.dxp;
  bp.out = p.dx;
  bp.n = p.n;
  bp.tile = p.tile;
  bp.width = p.width;
  bp.has_acc = 1;
  if ((e = banded::launch<H>(bp, st)) != cudaSuccess) return e;
  return launch_weights<H>(p, dwl, dwr, db, town, tg, st);
}

template <int H>
cudaError_t launch_split(Params p, float* dwl, float* dwr, float* db,
                         float* tbwd, int tg, cudaStream_t st) {
  cudaError_t e = launch_tile<H>(p, st);
  if (e != cudaSuccess) return e;
  return launch_weights<H>(p, dwl, dwr, db, tbwd, tg, st);
}

}  // namespace

extern "C" int sage_layer_bwd(
    const void* dz, const void* y, const void* inv, const void* agg,
    const void* x, const void* w_l, const void* w_r, const void* band,
    const void* tprev, const void* code, const void* gwin,
    const void* acc_code, void* dout, void* dagg, void* dxp, void* dx,
    void* db_part, void* t_part, void* dw_part, void* dwl, void* dwr,
    void* db, void* town, int n, int h, int tile, int width, int gw, int t0,
    int tg, int apply_prev, int has_super, int skip, int dropout,
    unsigned int thr, unsigned int s0, unsigned int s1, float scale,
    void* stream) {
  Params p = {};
  p.dz = static_cast<const bf16*>(dz);
  p.y = static_cast<const bf16*>(y);
  p.inv = static_cast<const float*>(inv);
  p.agg = static_cast<const bf16*>(agg);
  p.x = static_cast<const bf16*>(x);
  p.w_l = static_cast<const bf16*>(w_l);
  p.w_r = static_cast<const bf16*>(w_r);
  p.band = static_cast<const int8_t*>(band);
  p.tprev = static_cast<const bf16*>(tprev);
  p.code = static_cast<const int*>(code);
  p.gwin = static_cast<const int*>(gwin);
  p.acc_code = static_cast<const int*>(acc_code);
  p.dout = static_cast<bf16*>(dout);
  p.dagg = static_cast<bf16*>(dagg);
  p.dxp = static_cast<bf16*>(dxp);
  p.dx = static_cast<bf16*>(dx);
  p.db_part = static_cast<float*>(db_part);
  p.t_part = static_cast<float*>(t_part);
  p.dw_part = static_cast<float*>(dw_part);
  p.n = n;
  p.tile = tile;
  p.width = width;
  p.gw = gw;
  p.t0 = t0;
  p.apply_prev = apply_prev;
  p.has_super = has_super;
  p.skip = skip;
  p.drop = {dropout, thr, s0, s1, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* fl = static_cast<float*>(dwl);
  float* fr = static_cast<float*>(dwr);
  float* fb = static_cast<float*>(db);
  float* ft = static_cast<float*>(town);
  cudaError_t e;
  switch (h) {
    case 128: e = launch<128>(p, fl, fr, fb, ft, tg, st); break;
    case 256: e = launch<256>(p, fl, fr, fb, ft, tg, st); break;
    case 512: e = launch<512>(p, fl, fr, fb, ft, tg, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)e;
}

extern "C" int sage_layer_bwd_tile(
    const void* dz, const void* y, const void* inv, const void* agg,
    const void* x, const void* w_l, const void* w_r, const void* acc_code,
    void* dout, void* dagg, void* dxp, void* db_part, void* t_part,
    void* dw_part, void* dwl, void* dwr, void* db, void* tbwd, int n, int h,
    int tile, int tg, int has_super, int skip, int dropout, unsigned int thr,
    unsigned int s0, unsigned int s1, float scale, void* stream) {
  Params p = {};
  p.dz = static_cast<const bf16*>(dz);
  p.y = static_cast<const bf16*>(y);
  p.inv = static_cast<const float*>(inv);
  p.agg = static_cast<const bf16*>(agg);
  p.x = static_cast<const bf16*>(x);
  p.w_l = static_cast<const bf16*>(w_l);
  p.w_r = static_cast<const bf16*>(w_r);
  p.acc_code = static_cast<const int*>(acc_code);
  p.dout = static_cast<bf16*>(dout);
  p.dagg = static_cast<bf16*>(dagg);
  p.dxp = static_cast<bf16*>(dxp);
  p.db_part = static_cast<float*>(db_part);
  p.t_part = static_cast<float*>(t_part);
  p.dw_part = static_cast<float*>(dw_part);
  p.n = n;
  p.tile = tile;
  p.gw = tg / 2;  // global codes: the whole table is the one window
  p.t0 = tg / 2;
  p.apply_prev = 0;
  p.has_super = has_super;
  p.skip = skip;
  p.drop = {dropout, thr, s0, s1, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* fl = static_cast<float*>(dwl);
  float* fr = static_cast<float*>(dwr);
  float* fb = static_cast<float*>(db);
  float* ft = static_cast<float*>(tbwd);
  cudaError_t e;
  switch (h) {
    case 128: e = launch_split<128>(p, fl, fr, fb, ft, tg, st); break;
    case 256: e = launch_split<256>(p, fl, fr, fb, ft, tg, st); break;
    case 512: e = launch_split<512>(p, fl, fr, fb, ft, tg, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)e;
}
