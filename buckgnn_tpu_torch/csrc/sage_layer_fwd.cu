// Fused GraphSAGE layer forward for Hopper (sm_90a), bf16 in, f32 accumulate.
//
// Replaces the TPU kernel buckgnn_tpu/ops/pallas_sage_layer.py::_fwd_kernel
// (launched by _call_fwd). Per node tile t (T rows) with slab start
// s_t = clip(t*T - W/2, 0, max(N - (T+W), 0)) and, with spill edges, the
// spill window start w_t = clip(off[t] / 16 * 16, 0, Es - 256):
//
//   acc  = band_t @ x[s_t : s_t+T+W]  (+ sel_t @ star-table window)   f32
//        + sum_{m in [lo_r, hi_r)} msgs[w_t + m]          (spill, f32)
//   agg  = bf16(acc)
//   out  = agg @ W_l + x_t @ W_r + b_l                                 f32
//   y    = out * rsqrt(max(sum(out^2), 1e-24))
//   z    = bf16(dropout(relu(y) (+ x_t)))
//   emit: per-block partials of sum_{rows with code c} z  -> table_reduce
//
// The training variant (save_res) also writes the backward's residuals:
// agg and y in bf16 and inv = rsqrt(max(sum(out^2), 1e-24)) in f32, one per
// row. Dropout keeps an element when sage::dropout_bits(seeds, global row,
// column) < thr and scales it by `scale` (ops/dropout.py), after relu and
// the skip and before the cast and the table emit, as the TPU kernel does.
//
// The star selection is the same one-hot product the TPU kernel runs: its
// 2*GW one-hot columns are appended to the band's K dimension, and the
// matching table rows (wb.. and T0+wb.., or the whole table when GW == T0)
// to the slab's rows, so it lands in the same f32 accumulator before the
// cast, as on the TPU. The spill term (the TPU's one-hot [T, 256] product
// with the tile's message window, pallas_sage_layer.py:313-349) is the same
// f32 sum taken directly: each thread adds its two rows' message runs to
// its accumulator registers, each run summed on its own first in message
// order (banded.cuh::add_spill), also before the cast.
//
// What bounds it on an H100: at the flagship shape (N = 103,424, T = 256,
// W = 64, H = 512, 2GW = 32) a layer does 149 GFLOP of bf16 products against
// ~271 MB of compulsory traffic, so it is compute-bound (0.15 ms at the
// 989 TFLOP/s dense bf16 peak; 0.08 ms memory bound at 3.35 TB/s).
//
// Design: the product engine of engine.cuh. One block of four consumer
// warpgroups (H/4 columns each) and a producer warp owns 64 rows across the
// full width, in clusters of two neighbouring blocks:
//  - phase 1, acc = [band | sel] @ [x slab ; table window], K1 = T+W+2GW,
//    with the pieces of banded.cuh, the header of the band kernel that runs
//    the same product alone (#4 and the backward's band pass):
//    the consumers convert the block's int8 band rows to bf16 (counts <=
//    127 are exact) straight into the K-major 64-byte-swizzled A tile that
//    wgmma reads, with the one-hot selector columns after them. K is cut
//    into runs (the slab; the table window's one or two row runs), each a
//    whole number of 32-deep slices; A's columns past a run's rows are
//    zero, so the extra B rows a slice carries add exact zeros. The slab's
//    and the table's rows stream by TMA through the weight ring as MN-major
//    [32 k, 64 n] boxes, the layout of x @ W, multicast to both blocks
//    when they lie in one node tile (T % 128 == 0), else each block loads
//    its own;
//  - agg = bf16(acc) goes from the registers into the row tile (which
//    aliases the phase-1 A tile: the products that read it are done);
//  - phase 2, out = [agg | x_t] @ [W_l ; W_r], K = 2H: the producer streams
//    W_l's slices, then W_r's with x_t's [64, 32] slices beside them; the
//    weight slices are multicast to both blocks, so each weight byte read
//    from L2 serves 128 rows;
//  - the epilogue runs on the registers: + b_l, the row's sum of squares
//    (a thread's pairs, the quad by shuffles, then the four warpgroups
//    through shared memory in a fixed order), inv, y, relu, the skip row of
//    x (read with __ldg before any store), the keep mask, z = bf16 into the
//    tile, flushed in 16-byte rows. With emit, each block's partials of z
//    by accumulate code are summed from the tile in row order
//    (engine.cuh::code_sums); the cross-tile table sum (a sequential-grid
//    accumulator on the TPU) is then sage_common.cuh::table_reduce_kernel,
//    a second, deterministic pass.
//
// Shared memory at H = 512, of the 227 KB a block may take: 2 KB of
// alignment slack, barriers and codes; a ring of 4 slices of 36 KB (a
// [32, 512] B slice and a [64, 32] streamed A slice) = 144 KB; the A tile
// of ceil(K1 / 32) 4 KB panels (12 at the flagship, 48 KB), aliased by the
// 64 KB row tile; 1 KB for the row sums: 211 KB. A table window of more
// rows (the whole table, GW == T0) takes a larger A tile and fewer ring
// slices (at least 2). Registers: 112 a consumer thread, 64 of them the
// sums.

#include <algorithm>

#include "banded.cuh"
#include "engine.cuh"

namespace {

using eng::BK;
using eng::BM;
using eng::NCONS;
using eng::NTHREADS;
using eng::NWG;
using eng::PANEL;
using eng::Thr;
typedef __nv_bfloat16 bf16;

#define SAGE_CLUSTER __cluster_dims__(2, 1, 1)
static_assert(eng::CLUSTER == 2, "SAGE_CLUSTER names the cluster size");
// the barriers, then the block's selector and accumulate codes, in the
// first 1024 bytes
static_assert(sizeof(eng::Smem) <= 512, "barriers before the codes");

constexpr int SMEM_MAX = 232448;  // dynamic shared memory of a block (H100)
constexpr int SMEM_FIXED = 1024 + eng::ring_offset() + NWG * BM * 4;
constexpr int MAX_STAGES = 4;

struct Maps {
  CUtensorMap x, x_a, table, w_l, w_r;
};

struct Params {
  Maps m;
  const bf16* x;               // [N, H]
  const int8_t* band;          // [N, T+W] (tile t = rows t*T .. t*T+T)
  const bf16* b_l;             // [H]
  const int* code;             // [N] selector codes in [0, 2GW], 2GW = none
  const int* gwin;             // [n_tiles] window bases, or null (wb = 0)
  const int* acc_code;         // [N] accumulate codes (emit)
  const bf16* msgs;            // [Es, H] x at the spill senders (has_spill)
  const int* spill_off;        // [n_tiles + 1] spill offsets (has_spill)
  const int* spill_lo;         // [N] first window column of each row
  const int* spill_hi;         // [N] end window column of each row
  bf16* z;                     // [N, H]
  float* partial;              // [N / BM, 2GW, H] (emit)
  bf16* y_out;                 // [N, H] (save_res)
  float* inv_out;              // [N] (save_res)
  bf16* agg_out;               // [N, H] (save_res)
  int n, tile, width, gw, t0, has_super, skip, emit, save_res;
  int n_spill, has_spill;      // spill list rows, spill term on
  int stages;                  // ring slices
  eng::Drop drop;
};

using banded::Geo;
using banded::slices;

// phase 1's K runs of a block in node tile t, star window base wb
__host__ __device__ inline Geo geo(const Params& p, int t, int wb) {
  Geo g(p.n, p.tile, p.width, t);
  if (p.has_super) g.add_table(p.gw, p.t0, wb, p.gwin == nullptr);
  return g;
}

template <int H>
__global__ void SAGE_CLUSTER __launch_bounds__(NTHREADS, 1)
    sage_fwd_kernel(const __grid_constant__ Params p) {
  constexpr int NW = H / NWG, NK = H / BK;
  constexpr int SLICE = eng::slice_bytes(H, true);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = eng::align_smem(smem_raw);
  int* scode = reinterpret_cast<int*>(smem + 512);
  int* sacc = scode + BM;
  unsigned char* tile = smem + eng::ring_offset() + p.stages * SLICE;
  const int row0 = blockIdx.x * BM;
  const bool valid = row0 < p.n;  // the last cluster's second block may be empty
  const int nvalid = valid ? BM : 0;
  // an empty block reads the first rows' inputs (and drops them): no
  // address it forms lies past the end, even for a load the compiler hoists
  const int rowc = valid ? row0 : 0;
  // an empty block walks the last tile's slices, as its cluster peer needs
  const int t = min((int)blockIdx.x / (p.tile / BM), p.n / p.tile - 1);
  const Geo g = geo(p, t, p.has_super && p.gwin ? p.gwin[t] : 0);
  const int g2 = 2 * p.gw;
  float* red = reinterpret_cast<float*>(
      tile + max(eng::tile_bytes(H), g.nk1 * PANEL));  // [NWG][BM] row sums
  eng::roles(
      smem, p.stages, SLICE,
      [&](eng::Producer& pr, uint64_t*) {
        const bool mc = p.tile % (eng::CLUSTER * BM) == 0;  // one node tile
        for (int i = 0; i < g.nrun; ++i)
          pr.b<true>(g.run[i].src == banded::TABLE ? &p.m.table : &p.m.x, H,
                     g.run[i].row, 0, slices(g.run[i].rows), nullptr, 0, 0,
                     mc);
        pr.b<true>(&p.m.w_l, H, 0, 0, NK);
        pr.b<true>(&p.m.w_r, H, 0, 0, NK, &p.m.x_a, 0, row0);
      },
      [&](hop::Ring& ring, uint64_t*) {
        Thr th;
        if (threadIdx.x < BM) {
          const int r = rowc + threadIdx.x;
          scode[threadIdx.x] = valid && p.has_super ? p.code[r] : g2;
          sacc[threadIdx.x] = valid && p.emit ? p.acc_code[r] : g2;
        }
        hop::named_sync(eng::BAR_ALL, NCONS);
        const int s = p.tile + p.width;
        banded::build_a(tile, s, g, scode, nullptr, nullptr,
                        [&](int r, int k) {
                          return valid ? __ldg(reinterpret_cast<const uint2*>(
                                             p.band + (size_t)(rowc + r) * s +
                                             k))
                                       : make_uint2(0u, 0u);
                        });
        hop::named_sync(eng::BAR_ALL, NCONS);

        // phase 1: acc = [band | sel] @ [x slab ; table window] (+ spill)
        float acc[NW / 2];
        eng::gemm<NW, true>(acc, ring, hop::smem_u32(tile), g.nk1, false, th);
        if (p.has_spill && valid) {
          const int ws = sage::spill_window_start(p.spill_off[t], p.n_spill);
          const int r = rowc + th.r0;
          const int lo[2] = {p.spill_lo[r], p.spill_lo[r + 8]};
          const int hi[2] = {p.spill_hi[r], p.spill_hi[r + 8]};
          banded::add_spill<NW, H>(acc, p.msgs, ws, lo, hi, th);
        }
        // agg = bf16(acc): the row tile (over the spent A tile)
        eng::to_tile<NW>(acc, tile, th);
        if (p.save_res) eng::flush<H>(tile, p.agg_out, H, 0, row0, nvalid);
        if (p.skip) eng::prefetch_rows(p.x, H * 2, row0, nvalid);

        // phase 2: out = agg @ W_l + x_t @ W_r (x_t streamed beside W_r)
        eng::gemm<NW, true>(acc, ring, hop::smem_u32(tile), NK, false, th);
        eng::gemm<NW, true>(acc, ring, 0, NK, true, th);

        // + b_l; the row norm: the thread's pairs, its quad, then the
        // warpgroups in a fixed order
        float sq[2] = {0.f, 0.f};
        eng::pairs_chunked<NW>(th, [&](int i, int r, int c) {
          const float2 b = eng::ld2(p.b_l + c);
          acc[i] += b.x;
          acc[i + 1] += b.y;
          const int h = (i / 2) % 2;
          sq[h] += acc[i] * acc[i];
          sq[h] += acc[i + 1] * acc[i + 1];
        });
        float inv[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          sq[h] += __shfl_xor_sync(0xffffffffu, sq[h], 1);
          sq[h] += __shfl_xor_sync(0xffffffffu, sq[h], 2);
          if (th.lane % 4 == 0) red[th.wg * BM + th.r0 + 8 * h] = sq[h];
        }
        hop::named_sync(eng::BAR_ALL, NCONS);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = th.r0 + 8 * h;
          const float s =
              ((red[r] + red[BM + r]) + red[2 * BM + r]) + red[3 * BM + r];
          inv[h] = rsqrtf(fmaxf(s, 1e-24f));
          if (p.save_res && valid && th.wg == 0 && th.lane % 4 == 0)
            p.inv_out[row0 + r] = inv[h];
        }
        // y = out * inv; z = bf16(dropout(relu(y) (+ x_t)))
        eng::pairs<NW>(th, [&](int i, int r, int c) {
          acc[i] *= inv[(i / 2) % 2];
          acc[i + 1] *= inv[(i / 2) % 2];
        });
        if (p.save_res) eng::emit<NW>(acc, tile, p.y_out, H, row0, nvalid, th);
        eng::relu<NW>(acc);
        if (p.skip) eng::add_pairs<NW>(acc, p.x, H, row0, nvalid, th);
        eng::dropout<NW>(acc, p.drop, row0, th);
        eng::emit<NW>(acc, tile, p.z, H, row0, nvalid, th);
        // next layer's star table: this block's partials by accumulate code
        if (p.emit && valid)
          eng::code_sums<H>(tile, sacc, g2,
                            p.partial + (size_t)blockIdx.x * g2 * H);
      });
}

// dynamic shared memory and ring slices of a launch, 0 slices if the A
// tile leaves no room for two
template <int H>
void plan(Params& p, int nk1, int* smem) {
  constexpr int SLICE = eng::slice_bytes(H, true);
  const int region = std::max(eng::tile_bytes(H), nk1 * PANEL);
  p.stages = std::min(MAX_STAGES, (SMEM_MAX - SMEM_FIXED - region) / SLICE);
  *smem = SMEM_FIXED + p.stages * SLICE + region;
}

template <int H>
cudaError_t launch(Params p, cudaStream_t stream) {
  int smem;
  plan<H>(p, geo(p, 0, 0).nk1, &smem);
  if (p.stages < 2) return cudaErrorInvalidValue;
  cudaError_t e = eng::set_smem(sage_fwd_kernel<H>, smem);
  if (e != cudaSuccess) return e;
  sage_fwd_kernel<H><<<eng::grid_blocks(p.n), NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t launch_h(const Params& p, int h, cudaStream_t st) {
  switch (h) {
    case 128: return launch<128>(p, st);
    case 256: return launch<256>(p, st);
    case 512: return launch<512>(p, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int sage_layer_fwd(
    const void* x, const void* band, const void* w_l, const void* w_r,
    const void* b_l, const void* table, const void* code, const void* gwin,
    const void* acc_code, const void* msgs, const void* spill_off,
    const void* spill_lo, const void* spill_hi, void* z, void* partial,
    void* ftab, void* y_out, void* inv_out, void* agg_out, int n, int h,
    int tile, int width, int gw, int t0, int tg, int has_super, int skip,
    int emit, int save_res, int n_spill, int has_spill, int dropout,
    unsigned int thr, unsigned int s0, unsigned int s1, float scale,
    void* stream) {
  Params p = {};
  p.x = static_cast<const bf16*>(x);
  p.band = static_cast<const int8_t*>(band);
  p.b_l = static_cast<const bf16*>(b_l);
  p.code = static_cast<const int*>(code);
  p.gwin = static_cast<const int*>(gwin);
  p.acc_code = static_cast<const int*>(acc_code);
  p.msgs = static_cast<const bf16*>(msgs);
  p.spill_off = static_cast<const int*>(spill_off);
  p.spill_lo = static_cast<const int*>(spill_lo);
  p.spill_hi = static_cast<const int*>(spill_hi);
  p.n_spill = n_spill;
  p.has_spill = has_spill;
  p.z = static_cast<bf16*>(z);
  p.partial = static_cast<float*>(partial);
  p.y_out = static_cast<bf16*>(y_out);
  p.inv_out = static_cast<float*>(inv_out);
  p.agg_out = static_cast<bf16*>(agg_out);
  p.save_res = save_res;
  p.drop = {dropout, thr, s0, s1, scale};
  p.n = n;
  p.tile = tile;
  p.width = width;
  p.gw = gw;
  p.t0 = t0;
  p.has_super = has_super;
  p.skip = skip;
  p.emit = emit;
  bool ok = eng::map_mn(&p.m.x, x, n, h) && eng::map_a(&p.m.x_a, x, n, h, h) &&
            eng::map_mn(&p.m.w_l, w_l, h, h) &&
            eng::map_mn(&p.m.w_r, w_r, h, h);
  if (has_super) ok = ok && eng::map_mn(&p.m.table, table, tg, h);
  if (!ok || n % BM != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = launch_h(p, h, st);
  if (e != cudaSuccess) return (int)e;
  if (emit) {
    dim3 grid((h + 255) / 256, tg);
    sage::table_reduce_kernel<<<grid, 256, 0, st>>>(
        static_cast<const float*>(partial), p.gwin, static_cast<float*>(ftab),
        n / tile, tile / BM, gw, t0, h);
  }
  return (int)cudaGetLastError();
}
