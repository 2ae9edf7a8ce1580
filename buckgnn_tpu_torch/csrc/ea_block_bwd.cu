// Fused edge-augmented GraphNetBlock backward for Hopper (sm_90a).
//
// Replaces the TPU kernel buckgnn_tpu/ops/pallas_ea_block.py::_bwd_kernel
// (launched by _call_bwd) together with its XLA epilogue _fold_dx. The
// function, step by step with its casts, is ea_block_bwd_plain in
// buckgnn_tpu_torch/ops/ea_block.py. It replays the forward from the stored
// e1 and m1 (e2, sm, agg, g1, x1 and b1 are recomputed) and returns the
// folded dx, de_win (not in encoder mode), every weight gradient and the
// bias stack's gradient in f32.
//
// The TPU kernel leans on its sequential grid: weight and bias gradients
// accumulate in VMEM across tiles, and the sender gradient leaves as a
// tile-centre block, a [2 * width, H] slab-overlap halo and a receiver-
// tiled far table that XLA folds into dx afterwards. CUDA blocks run in
// parallel and in no order, so the work is split into passes on one
// stream, with no float atomics (two runs give the same bits). Passes 1-3
// are chains on the product engine of ea_common.cuh (64-row blocks in
// clusters of two, every weight streamed by TMA through a ring and read
// MN-major for the recomputed forward products, K-major for the W^T of the
// backward ones, wgmma, epilogues on the registers):
//   1. node pass 1, 64 nodes a block: recompute sm (each node's run of m1
//      rows), agg, g1 ([x | agg] @ W_g0, x streamed), x1, b1 (10 products
//      with the backward's), keeping the relu masks of g1 and b1 as bits in
//      the registers of the threads that use them and the pass's bias rows
//      in shared memory; then beta, gamma, the mean and phi's second layer
//      backward: dsm to device memory, the weight-gradient operands to
//      scratch, per-block bias column sums;
//   2. edge pass, 64 slots a block: e1 comes by TMA, dsm[recv] by cp.async
//      while e2 = e1 @ W_e1 runs; dzm, de2, de1, deo (de_win, or in encoder
//      mode the encoder's recompute first and its backward last); operands
//      and bias sums as in pass 1;
//   3. node pass 2, 64 nodes a block: r_de1 (the node's run of de1 rows)
//      and s = [de1 | dzm] summed over the node's sender-sorted slots (which
//      folds the slab-overlap halo and the far rows in one pass) go through
//      the row tile one part at a time: dx = bf16(dzg @ W_g0[:H]^T + r_de1
//      @ W_er^T + s @ W_sp^T (+ dz_x)) in one chain of sums, dzg streamed
//      (so the f32 dxt = dzg @ W_g0[:H]^T never reaches device memory);
//   4. weight gradients A^T @ B over node rows or slot rows, split over a
//      fixed number of row chunks (split-K) with f32 partials (atb.cuh: TMA
//      and wgmma, A^T by the descriptor), then every partial and the bias
//      column sums reduced in a fixed order.
//
// What bounds it on an H100: at the ea-virtual shape (224,650 valid slots
// of E = 239,168, N = 51,712, H = 512) the useful products are the data
// and weight gradients plus the recomputed e2 and node side, 2 H^2 (7 E +
// 23 N) over valid slots = 1.45 TFLOP (1.46 ms at 989 TFLOP/s), against
// ~1.5 GB of compulsory traffic (0.45 ms at 3.35 TB/s): bound by
// operations. The chains serialise product and epilogue within a block
// (one block per SM), and the design writes and reads ~1.7 GB of operands
// for the weight pass; the TPU kernel keeps them in VMEM.

#include "atb.cuh"
#include "ea_common.cuh"

namespace {

using ea::bf16;
using ea::BK;
using ea::BM;
using ea::NCONS;
using ea::NTHREADS;
using ea::roles;
using ea::Thr;

using splitk::atb;
using splitk::KSPLIT;  // row chunks of the weight passes
constexpr int NODE_SUMS = 5;  // bias rows 3-7 from node blocks
constexpr int EDGE_SUMS = 6;  // bias rows 0-2 and 8-10 from edge blocks
constexpr int STAGES_E = 3;   // ring slices of the edge pass
constexpr int STAGES = 4;     // of the node passes

#define EA_CLUSTER __cluster_dims__(2, 1, 1)
static_assert(ea::CLUSTER == 2, "EA_CLUSTER names the cluster size");

struct Scratch {
  // [N, H] bf16 node operands
  bf16 *sm, *agg, *g1, *x1, *b1, *dx2c, *dzb, *dx1c, *dzg, *daggc, *dsm,
      *rde1;
  bf16* snode;  // [N, 2H]
  // [E, H] bf16 slot operands
  bf16 *e2, *dzm, *de2c, *de1, *ein, *deoc;
  bf16 *hen1, *hen2, *dz2, *dz1;  // [E, 128] (enc)
  float* nsum;  // [N / BM, NODE_SUMS, H]
  float* esum;  // [ceil(E / BM), EDGE_SUMS, H]
  float* part;  // weight partials (part_floats)
};

// tensor maps: A operands, the weights read MN-major (W [k, n]: the
// recomputed forward) and K-major (suffix t: W^T from W [n, k])
struct Maps {
  CUtensorMap x, e1s, dzg, wp1, wg0, wg1, wb0, we1, wen1, wen2, wb1t, wb0t,
      wg1t, wg0t, wp1t, wpet, we1t, weet, wert, wspt, wen2t, wen1t;
};

struct Params {
  Maps m;
  const bf16 *dzx, *dze, *e1s, *m1s, *x, *e_in, *wen0;
  const float* bias;
  const int *recv, *rlo, *rhi, *sorder, *soff;
  const float* cnt;
  bf16 *dx, *de_win;
  int n, e, skip;
  ea::Drop drop;
  Scratch s;
};

size_t align256(size_t b) { return (b + 255) / 256 * 256; }

// the weight partials of the one weight-pass launch: ten [H, H] products
// and W_sp's [H, 2H], and in encoder mode [128, H] and two [128, 128]
size_t part_floats(int h, int enc) {
  const size_t c = ea::ENC_HID;
  return (size_t)KSPLIT * (12 * (size_t)h * h + (enc ? c * h + 2 * c * c : 0));
}

// carve the scratch buffer (base null: only count the bytes)
size_t carve(unsigned char* base, int n, int e, int h, int enc, Scratch* s) {
  size_t off = 0;
  auto take = [&](size_t bytes) {
    unsigned char* p = base ? base + off : nullptr;
    off += align256(bytes);
    return p;
  };
  const size_t nh = (size_t)n * h * 2, eh = (size_t)e * h * 2;
  bf16** node[] = {&s->sm, &s->agg, &s->g1, &s->x1, &s->b1, &s->dx2c,
                   &s->dzb, &s->dx1c, &s->dzg, &s->daggc, &s->dsm, &s->rde1};
  for (bf16** q : node) *q = reinterpret_cast<bf16*>(take(nh));
  s->snode = reinterpret_cast<bf16*>(take(2 * nh));
  bf16** edge[] = {&s->e2, &s->dzm, &s->de2c, &s->de1};
  for (bf16** q : edge) *q = reinterpret_cast<bf16*>(take(eh));
  s->ein = s->deoc = s->hen1 = s->hen2 = s->dz2 = s->dz1 = nullptr;
  if (enc) {
    const size_t e128 = (size_t)e * ea::ENC_HID * 2;
    s->ein = reinterpret_cast<bf16*>(take(eh));
    s->deoc = reinterpret_cast<bf16*>(take(eh));
    bf16** small[] = {&s->hen1, &s->hen2, &s->dz2, &s->dz1};
    for (bf16** q : small) *q = reinterpret_cast<bf16*>(take(e128));
  }
  s->nsum = reinterpret_cast<float*>(
      take((size_t)(n / BM) * NODE_SUMS * h * 4));
  s->esum = reinterpret_cast<float*>(
      take((size_t)((e + BM - 1) / BM) * EDGE_SUMS * h * 4));
  s->part = reinterpret_cast<float*>(take(part_floats(h, enc) * 4));
  return off;
}

// ---- pass 1: node side ----------------------------------------------------
template <int H>
__global__ void EA_CLUSTER __launch_bounds__(NTHREADS, 1)
    bwd_node1_kernel(const __grid_constant__ Params p) {
  constexpr int NW = H / ea::NWG, NK = H / BK;
  constexpr int SLICE = ea::slice_bytes(H, true);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = ea::align_smem(smem_raw);
  unsigned char* tile = smem + ea::ring_offset() + STAGES * SLICE;
  float* red = reinterpret_cast<float*>(tile + ea::tile_bytes(H));
  float* scnt = red + ea::RED_WARPS * NW;
  float* sb = scnt + BM;  // bias rows 3-6
  const Scratch& s = p.s;
  const int row0 = blockIdx.x * BM;
  const int nvalid = max(0, min(BM, p.n - row0));
  float* sums = nvalid ? s.nsum + (size_t)blockIdx.x * NODE_SUMS * H : nullptr;
  roles(smem, STAGES, SLICE,
        [&](ea::Producer& pr, uint64_t*) {
          pr.b<true>(&p.m.wp1, H, 0, 0, NK);
          pr.b<true>(&p.m.wg0, H, 0, 0, NK, &p.m.x, 0, row0);
          pr.b<true>(&p.m.wg0, H, H, 0, NK);
          pr.b<true>(&p.m.wg1, H, 0, 0, NK);
          pr.b<true>(&p.m.wb0, H, 0, 0, NK);
          pr.b<false>(&p.m.wb1t, H, 0, 0, NK);
          pr.b<false>(&p.m.wb0t, H, 0, 0, NK);
          pr.b<false>(&p.m.wg1t, H, 0, 0, NK);
          pr.b<false>(&p.m.wg0t, H, 0, H, NK);
          pr.b<false>(&p.m.wp1t, H, 0, 0, NK);
        },
        [&](hop::Ring& ring, uint64_t*) {
          Thr t;
          const uint32_t a = hop::smem_u32(tile);
          if (threadIdx.x < BM) {
            const int r = threadIdx.x;
            const float v = p.cnt[ea::row_or0(row0, r, nvalid)];
            scnt[r] = r < nvalid ? v : 0.f;
          }
          float acc[NW / 2];
          uint32_t g1m[(NW / 2 + 31) / 32], b1m[(NW / 2 + 31) / 32];
          ea::stage_bias(sb, p.bias, 3, 4, H);
          // recompute sm, agg, g1, x1, b1 (as the forward's node pass)
          ea::run_sums<H>(tile, s.sm, H, 0, p.m1s, H, 0, p.rlo, p.rhi,
                          nullptr, row0, nvalid);
          hop::fence_async_smem();
          hop::named_sync(ea::BAR_ALL, NCONS);
          ea::gemm<NW, true>(acc, ring, a, NK, false, t);
          const float* b3 = sb;
          ea::pairs_chunked<NW>(t, [&](int i, int r, int c) {
            const float cn = scnt[r];
            const float2 b = *reinterpret_cast<const float2*>(b3 + c);
            acc[i] = (acc[i] + cn * b.x) / fmaxf(cn, 1.f);
            acc[i + 1] = (acc[i + 1] + cn * b.y) / fmaxf(cn, 1.f);
          });
          ea::emit<NW>(acc, tile, s.agg, H, row0, nvalid, t);
          ea::gemm<NW, true>(acc, ring, 0, NK, false, t);
          ea::gemm<NW, true>(acc, ring, a, NK, true, t);
          ea::add_bias<NW>(acc, sb + 1 * H, t);
          ea::relu<NW>(acc);
          ea::mask_bits<NW>(acc, g1m);
          ea::emit<NW>(acc, tile, s.g1, H, row0, nvalid, t);
          ea::gemm<NW, true>(acc, ring, a, NK, false, t);
          ea::add_bias<NW>(acc, sb + 2 * H, t);
          ea::emit<NW>(acc, tile, s.x1, H, row0, nvalid, t);
          ea::prefetch_rows(p.dzx, H * 2, row0, nvalid);
          ea::gemm<NW, true>(acc, ring, a, NK, false, t);
          ea::add_bias<NW>(acc, sb + 3 * H, t);
          ea::relu<NW>(acc);
          ea::mask_bits<NW>(acc, b1m);
          ea::emit<NW>(acc, tile, s.b1, H, row0, nvalid, t);

          // dx2 = dz_x after the mask; dx2c = bf16(dx2)
#pragma unroll
          for (int i = 0; i < NW / 2; ++i) acc[i] = 0.f;
          ea::add_dropped<NW>(acc, p.dzx, H, row0, nvalid, p.drop, p.e + row0,
                              t);
          ea::colsum<NW>(acc, t, red, sums ? sums + 4 * H : nullptr);  // b_b1
          ea::emit<NW>(acc, tile, s.dx2c, H, row0, nvalid, t);
          // dzb = bf16(where(b1 > 0, dx2c @ W_b1^T, 0))
          ea::gemm<NW, false>(acc, ring, a, NK, false, t);
          ea::apply_mask<NW>(acc, b1m);
          ea::colsum<NW>(acc, t, red, sums ? sums + 3 * H : nullptr);  // b_b0
          ea::emit<NW>(acc, tile, s.dzb, H, row0, nvalid, t);
          // dx1 = dx2 + dzb @ W_b0^T; dx1c = bf16(dx1)
          ea::gemm<NW, false>(acc, ring, a, NK, false, t);
          ea::add_dropped<NW>(acc, p.dzx, H, row0, nvalid, p.drop, p.e + row0,
                              t);
          ea::colsum<NW>(acc, t, red, sums ? sums + 2 * H : nullptr);  // b_g1
          ea::emit<NW>(acc, tile, s.dx1c, H, row0, nvalid, t);
          // dzg = bf16(where(g1 > 0, dx1c @ W_g1^T, 0))
          ea::gemm<NW, false>(acc, ring, a, NK, false, t);
          ea::apply_mask<NW>(acc, g1m);
          ea::colsum<NW>(acc, t, red, sums ? sums + 1 * H : nullptr);  // b_g0
          ea::emit<NW>(acc, tile, s.dzg, H, row0, nvalid, t);
          // dagg_d = dzg @ W_g0[H:]^T / max(cnt, 1); daggc = bf16(dagg_d)
          ea::gemm<NW, false>(acc, ring, a, NK, false, t);
          ea::pairs<NW>(t, [&](int i, int r, int c) {
            const float d = fmaxf(scnt[r], 1.f);
            acc[i] /= d;
            acc[i + 1] /= d;
          });
          // b_p1: the sum of cnt * dagg_d
          ea::colsum<NW>(acc, t, red, sums, scnt);
          ea::emit<NW>(acc, tile, s.daggc, H, row0, nvalid, t);
          // dsm = bf16(daggc @ W_p1^T)
          ea::gemm<NW, false>(acc, ring, a, NK, false, t);
          ea::emit<NW>(acc, tile, s.dsm, H, row0, nvalid, t);
        });
}

// ---- pass 2: slot side ----------------------------------------------------
template <int H, bool ENC>
__global__ void EA_CLUSTER __launch_bounds__(NTHREADS, 1)
    bwd_edge_kernel(const __grid_constant__ Params p) {
  constexpr int NW = H / ea::NWG, NK = H / BK;
  constexpr int HW = ea::ENC_HID / ea::NWG;  // the encoder's warpgroup width
  constexpr int NKE = ea::ENC_HID / BK;
  constexpr int C = ea::ENC_HID;
  constexpr int SLICE = ea::slice_bytes(H, false);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = ea::align_smem(smem_raw);
  unsigned char* tile = smem + ea::ring_offset() + STAGES_E * SLICE;
  unsigned char* stage = tile + ea::tile_bytes(H);  // dsm[recv]; then sums
  float* red = reinterpret_cast<float*>(stage);
  int* srecv = reinterpret_cast<int*>(stage + ea::tile_bytes(H));
  const Scratch& s = p.s;
  const int f0 = blockIdx.x * BM;
  const int nvalid = max(0, min(BM, p.e - f0));
  float* sums = nvalid ? s.esum + (size_t)blockIdx.x * EDGE_SUMS * H : nullptr;
  roles(smem, STAGES_E, SLICE,
        [&](ea::Producer& pr, uint64_t* abar) {
          pr.tile(tile, abar, &p.m.e1s, H, f0);
          if constexpr (ENC) {
            pr.b<true>(&p.m.wen1, C, 0, 0, NKE);
            pr.b<true>(&p.m.wen2, H, 0, 0, NKE);
          }
          pr.b<true>(&p.m.we1, H, 0, 0, NK);
          pr.b<false>(&p.m.wpet, H, 0, 0, NK);
          pr.b<false>(&p.m.we1t, H, 0, 0, NK);
          pr.b<false>(&p.m.weet, H, 0, 0, NK);
          if constexpr (ENC) {
            pr.b<false>(&p.m.wen2t, C, 0, 0, NK);
            pr.b<false>(&p.m.wen1t, C, 0, 0, NKE);
          }
        },
        [&](hop::Ring& ring, uint64_t* abar) {
          Thr t;
          const uint32_t a = hop::smem_u32(tile);
          if (threadIdx.x < BM) {
            const int r = threadIdx.x;
            const int rv = p.recv[ea::row_or0(f0, r, nvalid)];
            srecv[r] = r < nvalid ? rv : -1;
          }
          hop::named_sync(ea::BAR_ALL, NCONS);
          float acc[NW / 2];
          uint32_t e1m[(NW / 2 + 31) / 32];
          uint32_t h1m[1], h2m[1];
          float h[HW / 2];
          if constexpr (ENC) {
            // h1, h2 and e_in from the raw rows (the staging tile is their
            // row tile), for the weight pass and the masks
            ea::encoder_first<HW>(h, p.e_in, f0, nvalid, p.wen0,
                                  p.bias + 8 * H, t);
            ea::mask_bits<HW>(h, h1m);
            ea::emit<HW>(h, stage, s.hen1, C, f0, nvalid, t);
            const uint32_t st = hop::smem_u32(stage);
            ea::prefetch_bias(p.bias + 9 * H, C);
            ea::gemm<HW, true>(h, ring, st, NKE, false, t);
            ea::add_bias<HW>(h, p.bias + 9 * H, t);
            ea::relu<HW>(h);
            ea::mask_bits<HW>(h, h2m);
            ea::emit<HW>(h, stage, s.hen2, C, f0, nvalid, t);
            ea::prefetch_bias(p.bias + 10 * H, H);
            ea::gemm<NW, true>(acc, ring, st, NKE, false, t);
            ea::add_bias<NW>(acc, p.bias + 10 * H, t);
            ea::emit<NW>(acc, stage, s.ein, H, f0, nvalid, t);
            hop::named_sync(ea::BAR_ALL, NCONS);  // the stage tile is read
          }
          ea::gather_rows<H>(stage, s.dsm, H, 0, srecv);  // dsm[recv]
          hop::mbar_wait(abar, 0);
          // e1's relu mask, from the tile
          ea::pairs<NW>(t, [&](int i, int r, int c) {
            const float2 v = ea::ld_pair(tile, r, c);
            acc[i] = v.x;
            acc[i + 1] = v.y;
          });
          ea::mask_bits<NW>(acc, e1m);

          // e2 = bf16(e1 @ W_e1 + b_e1), for dW_pe
          ea::prefetch_bias(p.bias + H, H);
          ea::prefetch_rows(p.m1s, H * 2, f0, nvalid);
          ea::gemm<NW, true>(acc, ring, a, NK, false, t);
          ea::add_bias<NW>(acc, p.bias + H, t);
          ea::emit<NW>(acc, tile, s.e2, H, f0, nvalid, t);

          // dzm = bf16(where(m1 > 0, dsm[recv], 0))
          hop::cp_wait_all();
          hop::named_sync(ea::BAR_ALL, NCONS);
          ea::pairs_chunked<NW>(t, [&](int i, int r, int c) {
            float2 m = ea::ld2(p.m1s +
                               (size_t)ea::row_or0(f0, r, nvalid) * H + c);
            if (r >= nvalid) m = make_float2(0.f, 0.f);
            const float2 d = ea::ld_pair(stage, r, c);
            acc[i] = m.x > 0.f ? d.x : 0.f;
            acc[i + 1] = m.y > 0.f ? d.y : 0.f;
          });
          hop::named_sync(ea::BAR_ALL, NCONS);  // the stage tile is read
          ea::colsum<NW>(acc, t, red, sums ? sums + 2 * H : nullptr);  // b_p0
          ea::emit<NW>(acc, tile, s.dzm, H, f0, nvalid, t);

          // de2 = dz_e (masked) + dzm @ W_pe^T; de2c = bf16(de2)
          ea::prefetch_rows(p.dze, H * 2, f0, nvalid);
          ea::gemm<NW, false>(acc, ring, a, NK, false, t);
          ea::add_dropped<NW>(acc, p.dze, H, f0, nvalid, p.drop, f0, t);
          ea::colsum<NW>(acc, t, red, sums ? sums + 1 * H : nullptr);  // b_e1
          ea::emit<NW>(acc, tile, s.de2c, H, f0, nvalid, t);

          // de1 = bf16(where(e1 > 0, de2c @ W_e1^T, 0))
          ea::gemm<NW, false>(acc, ring, a, NK, false, t);
          ea::apply_mask<NW>(acc, e1m);
          ea::colsum<NW>(acc, t, red, sums);  // b_e0
          ea::emit<NW>(acc, tile, s.de1, H, f0, nvalid, t);

          // deo = de1 @ W_ee^T (+ dz_e with the skip)
          ea::gemm<NW, false>(acc, ring, a, NK, false, t);
          if (p.skip)
            ea::add_dropped<NW>(acc, p.dze, H, f0, nvalid, p.drop, f0, t);
          if constexpr (!ENC) {
            ea::emit<NW>(acc, tile, p.de_win, H, f0, nvalid, t);
          } else {
            // the encoder's backward: deo_c -> dz2 -> dz1
            ea::colsum<NW>(acc, t, red, sums ? sums + 5 * H : nullptr);  // be_2
            ea::emit<NW>(acc, tile, s.deoc, H, f0, nvalid, t);
            // h's recompute values are dead: without this the sums'
            // read-write operands would keep them live through the chain
#pragma unroll
            for (int i = 0; i < HW / 2; ++i) h[i] = 0.f;
            ea::gemm<HW, false>(h, ring, a, NK, false, t);
            ea::apply_mask<HW>(h, h2m);
            ea::colsum<HW>(h, t, red, sums ? sums + 4 * H : nullptr, nullptr, H);
            ea::emit<HW>(h, tile, s.dz2, C, f0, nvalid, t);
            ea::gemm<HW, false>(h, ring, a, NKE, false, t);
            ea::apply_mask<HW>(h, h1m);
            ea::colsum<HW>(h, t, red, sums ? sums + 3 * H : nullptr, nullptr, H);
            ea::emit<HW>(h, tile, s.dz1, C, f0, nvalid, t);
          }
        });
}

// ---- pass 3: the receiver and sender folds into dx -------------------------
template <int H>
__global__ void EA_CLUSTER __launch_bounds__(NTHREADS, 1)
    bwd_node2_kernel(const __grid_constant__ Params p) {
  constexpr int NW = H / ea::NWG, NK = H / BK;
  constexpr int SLICE = ea::slice_bytes(H, true);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = ea::align_smem(smem_raw);
  unsigned char* tile = smem + ea::ring_offset() + STAGES * SLICE;
  const Scratch& s = p.s;
  const int row0 = blockIdx.x * BM;
  const int nvalid = max(0, min(BM, p.n - row0));
  roles(smem, STAGES, SLICE,
        [&](ea::Producer& pr, uint64_t*) {
          pr.b<false>(&p.m.wg0t, H, 0, 0, NK, &p.m.dzg, 0, row0);
          pr.b<false>(&p.m.wert, H, 0, 0, NK);
          pr.b<false>(&p.m.wspt, H, 0, 0, NK);
          pr.b<false>(&p.m.wspt, H, H, 0, NK);
        },
        [&](hop::Ring& ring, uint64_t*) {
          Thr t;
          const uint32_t a = hop::smem_u32(tile);
          float acc[NW / 2];
          if (p.skip) ea::prefetch_rows(p.dzx, H * 2, row0, nvalid);
          // dzg @ W_g0[:H]^T (dzg streamed from node pass 1's operand)
          ea::gemm<NW, false>(acc, ring, 0, NK, false, t);
          // r_de1: the node's run of de1 rows (it is their receiver)
          ea::run_sums<H>(tile, s.rde1, H, 0, s.de1, H, 0, p.rlo, p.rhi,
                          nullptr, row0, nvalid);
          hop::fence_async_smem();
          hop::named_sync(ea::BAR_ALL, NCONS);
          ea::gemm<NW, false>(acc, ring, a, NK, true, t);
          // s = [de1 | dzm] summed over the node's sender-sorted slots: the
          // slab-overlap halo and the far rows in one pass, half by half
          for (int part = 0; part < 2; ++part) {
            hop::named_sync(ea::BAR_ALL, NCONS);
            ea::run_sums<H>(tile, s.snode, 2 * H, part * H,
                            part ? s.dzm : s.de1, H, 0, p.soff, p.soff + 1,
                            p.sorder, row0, nvalid);
            hop::fence_async_smem();
            hop::named_sync(ea::BAR_ALL, NCONS);
            ea::gemm<NW, false>(acc, ring, a, NK, true, t);
          }
          // dx = bf16(dzg @ W_g0[:H]^T + r_de1 @ W_er^T + s @ W_sp^T (+
          // dz_x)), one chain of sums
          if (p.skip)
            ea::add_dropped<NW>(acc, p.dzx, H, row0, nvalid, p.drop,
                                p.e + row0, t);
          ea::emit<NW>(acc, tile, p.dx, H, row0, nvalid, t);
        });
}

struct Grads {
  float *wer, *wee, *wsp, *we1, *wpe, *wp1, *wg0, *wg1, *wb0, *wb1;
  float *wen0, *wen1, *wen2, *bias;
};

template <int H, bool ENC>
cudaError_t launch(const Params& p, const Grads& g, cudaStream_t st) {
  cudaError_t err;
  const Scratch& s = p.s;
  const int nb = ea::grid_blocks(p.n), eb = ea::grid_blocks(p.e);
  const int smem1 = ea::smem_bytes(STAGES, ea::slice_bytes(H, true),
                                   ea::tile_bytes(H) +
                                       ea::RED_WARPS * (H / ea::NWG) * 4 +
                                       BM * 4 + 4 * H * 4);
  if ((err = ea::set_smem(bwd_node1_kernel<H>, smem1)) != cudaSuccess)
    return err;
  bwd_node1_kernel<H><<<nb, NTHREADS, smem1, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int smem2 = ea::smem_bytes(STAGES_E, ea::slice_bytes(H, false),
                                   2 * ea::tile_bytes(H) + BM * 4);
  if ((err = ea::set_smem(bwd_edge_kernel<H, ENC>, smem2)) != cudaSuccess)
    return err;
  bwd_edge_kernel<H, ENC><<<eb, NTHREADS, smem2, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int smem3 = ea::smem_bytes(STAGES, ea::slice_bytes(H, true),
                                   ea::tile_bytes(H));
  if ((err = ea::set_smem(bwd_node2_kernel<H>, smem3)) != cudaSuccess)
    return err;
  bwd_node2_kernel<H><<<nb, NTHREADS, smem3, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // pass 4: the weight gradients and the bias column sums (atb.cuh)
  const int n = p.n, e = p.e;
  splitk::Jobs jobs;
  jobs.add(s.b1, H, H, s.dx2c, H, H, n, g.wb1);
  jobs.add(s.x1, H, H, s.dzb, H, H, n, g.wb0);
  jobs.add(s.g1, H, H, s.dx1c, H, H, n, g.wg1);
  jobs.add(p.x, H, H, s.dzg, H, H, n, g.wg0);
  jobs.add(s.agg, H, H, s.dzg, H, H, n, g.wg0 + (size_t)H * H);
  jobs.add(s.sm, H, H, s.daggc, H, H, n, g.wp1);
  jobs.add(p.x, H, H, s.rde1, H, H, n, g.wer);
  jobs.add(p.x, H, H, s.snode, 2 * H, 2 * H, n, g.wsp);
  jobs.add(s.e2, H, H, s.dzm, H, H, e, g.wpe);
  jobs.add(p.e1s, H, H, s.de2c, H, H, e, g.we1);
  jobs.add(ENC ? s.ein : p.e_in, H, H, s.de1, H, H, e, g.wee);
  if (ENC) {
    const int c = ea::ENC_HID;
    jobs.add(s.hen2, c, c, s.deoc, H, H, e, g.wen2);
    jobs.add(s.hen1, c, c, s.dz2, c, c, e, g.wen1);
    jobs.add(p.e_in, ea::ENC_IN, ea::ENC_IN, s.dz1, c, c, e, g.wen0);
  }
  if (jobs.part_floats > part_floats(H, ENC)) return cudaErrorInvalidValue;
  if ((err = atb(jobs, s.part, st)) != cudaSuccess) return err;
  // bias rows: node slots 0-4 are rows 3-7; slot slots 0-5 rows 0-2, 8-10
  if ((err = splitk::bias_reduce(s.nsum, p.n / BM, NODE_SUMS, NODE_SUMS,
                                 {{3, 4, 5, 6, 7}}, H, g.bias, st)) !=
      cudaSuccess)
    return err;
  return splitk::bias_reduce(s.esum, (p.e + BM - 1) / BM, EDGE_SUMS,
                             ENC ? EDGE_SUMS : 3, {{0, 1, 2, 8, 9, 10}}, H,
                             g.bias, st);
}

bool make_maps(Maps* m, const Params& p, const void* const* w, int h,
               int enc) {
  // w: wer, wee, wsp, we1, wpe, wp1, wg0, wg1, wb0, wb1, wen1, wen2
  const int c = ea::ENC_HID;
  bool ok = ea::map_a(&m->x, p.x, p.n, h, h) &&
            ea::map_a(&m->e1s, p.e1s, p.e, h, h) &&
            ea::map_a(&m->dzg, p.s.dzg, p.n, h, h) &&
            ea::map_mn(&m->wp1, w[5], h, h) &&
            ea::map_mn(&m->wg0, w[6], 2 * h, h) &&
            ea::map_mn(&m->wg1, w[7], h, h) &&
            ea::map_mn(&m->wb0, w[8], h, h) &&
            ea::map_mn(&m->we1, w[3], h, h) &&
            ea::map_k(&m->wb1t, w[9], h, h, h) &&
            ea::map_k(&m->wb0t, w[8], h, h, h) &&
            ea::map_k(&m->wg1t, w[7], h, h, h) &&
            ea::map_k(&m->wg0t, w[6], 2 * h, h, h) &&
            ea::map_k(&m->wp1t, w[5], h, h, h) &&
            ea::map_k(&m->wpet, w[4], h, h, h) &&
            ea::map_k(&m->we1t, w[3], h, h, h) &&
            ea::map_k(&m->weet, w[1], h, h, h) &&
            ea::map_k(&m->wert, w[0], h, h, h) &&
            ea::map_k(&m->wspt, w[2], h, 2 * h, h);
  if (enc)
    ok = ok && ea::map_mn(&m->wen1, w[10], c, c) &&
         ea::map_mn(&m->wen2, w[11], c, h) &&
         ea::map_k(&m->wen2t, w[11], c, h, c) &&
         ea::map_k(&m->wen1t, w[10], c, c, c);
  return ok;
}

}  // namespace

extern "C" long long ea_block_bwd_scratch_bytes(int n, int e, int h,
                                                int enc) {
  Scratch s;
  return (long long)carve(nullptr, n, e, h, enc, &s);
}

extern "C" int ea_block_bwd(
    const void* dzx, const void* dze, const void* e1s, const void* m1s,
    const void* x, const void* e_in, const void* wer, const void* wee,
    const void* wsp, const void* we1, const void* wpe, const void* wp1,
    const void* wg0, const void* wg1, const void* wb0, const void* wb1,
    const void* wen0, const void* wen1, const void* wen2, const void* bias,
    const void* recv, const void* rlo, const void* rhi, const void* sorder,
    const void* soff, const void* cnt, void* scratch,
    void* dx, void* de_win, void* dwer, void* dwee, void* dwsp, void* dwe1,
    void* dwpe, void* dwp1, void* dwg0, void* dwg1, void* dwb0, void* dwb1,
    void* dwen0, void* dwen1, void* dwen2, void* dbias, int n, int e, int h,
    int enc, int skip, int dropout, unsigned int thr, unsigned int s0,
    unsigned int s1, float scale, void* stream) {
  Params p;
  p.dzx = static_cast<const bf16*>(dzx);
  p.dze = static_cast<const bf16*>(dze);
  p.e1s = static_cast<const bf16*>(e1s);
  p.m1s = static_cast<const bf16*>(m1s);
  p.x = static_cast<const bf16*>(x);
  p.e_in = static_cast<const bf16*>(e_in);
  p.wen0 = static_cast<const bf16*>(wen0);
  p.bias = static_cast<const float*>(bias);
  p.recv = static_cast<const int*>(recv);
  p.rlo = static_cast<const int*>(rlo);
  p.rhi = static_cast<const int*>(rhi);
  p.sorder = static_cast<const int*>(sorder);
  p.soff = static_cast<const int*>(soff);
  p.cnt = static_cast<const float*>(cnt);
  p.dx = static_cast<bf16*>(dx);
  p.de_win = static_cast<bf16*>(de_win);
  p.n = n;
  p.e = e;
  p.skip = skip;
  p.drop = {dropout, thr, s0, s1, scale};
  carve(static_cast<unsigned char*>(scratch), n, e, h, enc, &p.s);
  Grads g = {static_cast<float*>(dwer), static_cast<float*>(dwee),
             static_cast<float*>(dwsp), static_cast<float*>(dwe1),
             static_cast<float*>(dwpe), static_cast<float*>(dwp1),
             static_cast<float*>(dwg0), static_cast<float*>(dwg1),
             static_cast<float*>(dwb0), static_cast<float*>(dwb1),
             static_cast<float*>(dwen0), static_cast<float*>(dwen1),
             static_cast<float*>(dwen2), static_cast<float*>(dbias)};
  if (n % BM != 0) return (int)cudaErrorInvalidValue;
  const void* w[] = {wer, wee, wsp, we1, wpe, wp1, wg0, wg1, wb0, wb1,
                     wen1, wen2};
  if (!make_maps(&p.m, p, w, h, enc)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (h * 2 + (enc ? 1 : 0)) {
    case 256: err = launch<128, false>(p, g, st); break;
    case 512: err = launch<256, false>(p, g, st); break;
    case 513: err = launch<256, true>(p, g, st); break;
    case 1024: err = launch<512, false>(p, g, st); break;
    case 1025: err = launch<512, true>(p, g, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}
