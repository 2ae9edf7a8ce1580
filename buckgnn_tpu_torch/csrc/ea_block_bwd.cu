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
// stream, with no float atomics (two runs give the same bits):
//   1. node pass 1, one block per 32 nodes: recompute sm (each node's run
//      of m1 rows), agg, g1, x1, b1; then beta, gamma, the mean and phi's
//      second layer backward: dsm (bf16) and dxt (f32) to device memory,
//      the weight-gradient operands to scratch, and per-block bias column
//      sums;
//   2. edge pass, one block per 32 slots: e2 recomputed from e1, dm1 as a
//      row gather of dsm by receiver, dzm, de2, de1, deo (de_win, or in
//      encoder mode the encoder's backward from the raw rows); operands
//      and bias sums as in pass 1;
//   3. node pass 2, one block per 32 nodes: r_de1 sums the node's run of
//      de1 rows (receiver side) and s sums [de1 | dzm] over the node's
//      sender-sorted slots, which folds the slab-overlap halo and the far
//      rows in one pass; dx = bf16(r_de1 @ W_er^T + s @ W_sp^T + dxt
//      (+ dz_x));
//   4. weight gradients A^T @ B over node rows or slot rows, split over a
//      fixed number of row chunks (split-K) with f32 partials, all in one
//      launch (atb.cuh), then every partial and the bias column sums
//      reduced in a fixed order.
// Products are wmma 16x16x16 bf16 with f32 sums, weights read from global
// memory (L2); no TMA, wgmma or pipelining yet.
//
// What bounds it on an H100: at the ea-virtual shape (224,650 valid slots
// of E = 239,168, N = 51,712, H = 512) the useful products are the data
// and weight gradients plus the recomputed e2 and node side, 2 H^2 (7 E +
// 23 N) over valid slots = 1.45 TFLOP (1.46 ms at 989 TFLOP/s), against
// ~1.5 GB of compulsory traffic (0.45 ms at 3.35 TB/s): bound by
// operations. This design also writes and reads ~1.7 GB of operands for
// the weight passes; the TPU kernel keeps them in VMEM.

#include "atb.cuh"
#include "ea_common.cuh"

namespace {

using ea::bf16;
using ea::lda_of;
using ea::ldf_of;
using ea::NTHREADS;
using ea::NWARP;

constexpr int BM = 32;      // rows per block of the node and edge passes
using splitk::atb;
using splitk::KSPLIT;  // row chunks of the weight passes
constexpr int NODE_SUMS = 5;  // bias rows 3-7 from node blocks
constexpr int EDGE_SUMS = 6;  // bias rows 0-2 and 8-10 from edge blocks

struct Scratch {
  // [N, H] bf16 node operands
  bf16 *sm, *agg, *g1, *x1, *b1, *dx2c, *dzb, *dx1c, *dzg, *daggc, *dsm,
      *rde1;
  bf16* snode;  // [N, 2H]
  float* dxt;   // [N, H]
  // [E, H] bf16 slot operands
  bf16 *e2, *dzm, *de2c, *de1, *ein, *deoc;
  bf16 *hen1, *hen2, *dz2, *dz1;  // [E, 128] (enc)
  float* nsum;  // [N / BM, NODE_SUMS, H]
  float* esum;  // [ceil(E / BM), EDGE_SUMS, H]
  float* part;  // weight partials (part_floats)
};

struct Params {
  const bf16 *dzx, *dze, *e1s, *m1s, *x, *e_in;
  const bf16 *wer, *wee, *wsp, *we1, *wpe, *wp1, *wg0, *wg1, *wb0, *wb1;
  const bf16 *wen0, *wen1, *wen2;
  const float* bias;
  const int *recv, *rlo, *rhi, *sorder, *soff;
  const float* cnt;
  bf16 *dx, *de_win;
  int n, e, enc, skip;
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
  s->dxt = reinterpret_cast<float*>(take((size_t)n * h * 4));
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

// dz of one element after the keep mask, in f32
__device__ __forceinline__ float masked(const Params& p, const bf16* dz,
                                        size_t gh, int c, uint32_t rk) {
  const float v = __bfloat162float(dz[gh + c]);
  return p.drop.on ? p.drop.apply(v, rk, c) : v;
}

// sf rows -> bf16 into smem (lda) and into a global [., H] operand
template <int H>
__device__ __forceinline__ void emit_bf16(const float* sf, bf16* sa,
                                          bf16* g, int row0, int nvalid) {
  constexpr int LDA = lda_of(H), LDF = ldf_of(H);
  for (int i = threadIdx.x; i < BM * H / 2; i += NTHREADS) {
    const int r = i / (H / 2);
    const int c = (i % (H / 2)) * 2;
    const float a = sf[r * LDF + c], b = sf[r * LDF + c + 1];
    if (sa) ea::st2(sa + r * LDA + c, a, b);
    if (g && r < nvalid) ea::st2(g + (size_t)(row0 + r) * H + c, a, b);
  }
}

// ---- pass 1: node side ----------------------------------------------------
template <int H>
__global__ void __launch_bounds__(NTHREADS, 1) bwd_node1_kernel(Params p) {
  constexpr int LDA = lda_of(H);
  constexpr int LDF = ldf_of(H);
  constexpr int NQ = H / 64;
  constexpr int RPW = BM / NWARP;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sf = reinterpret_cast<float*>(smem);
  bf16* ba = reinterpret_cast<bf16*>(sf + BM * LDF);
  bf16* bb = ba + BM * LDA;
  bf16* bc = bb + BM * LDA;
  float* scnt = reinterpret_cast<float*>(bc + BM * LDA);
  const Scratch& s = p.s;
  const int row0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* sums = s.nsum + (size_t)blockIdx.x * NODE_SUMS * H;
  if (threadIdx.x < BM) scnt[threadIdx.x] = p.cnt[row0 + threadIdx.x];

  // recompute sm, agg, g1, x1, b1 (as the forward's node pass)
  for (int rr = 0; rr < RPW; ++rr) {
    const int r = warp * RPW + rr;
    const int lo = p.rlo[row0 + r], hi = p.rhi[row0 + r];
    float acc[NQ][2];
#pragma unroll
    for (int q = 0; q < NQ; ++q) acc[q][0] = acc[q][1] = 0.f;
    for (int f = lo; f < hi; ++f) {
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const float2 m = ea::ld2(p.m1s + (size_t)f * H + q * 64 + lane * 2);
        acc[q][0] += m.x;
        acc[q][1] += m.y;
      }
    }
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int c = q * 64 + lane * 2;
      ea::st2(ba + r * LDA + c, acc[q][0], acc[q][1]);
      ea::st2(s.sm + (size_t)(row0 + r) * H + c, acc[q][0], acc[q][1]);
    }
  }
  __syncthreads();
  ea::product<BM, H, false>(sf, ba, LDA, p.wp1, H, H);
  const float* b3 = p.bias + 3 * H;
  for (int i = threadIdx.x; i < BM * H; i += NTHREADS) {
    const int r = i / H, c = i % H;
    sf[r * LDF + c] = (sf[r * LDF + c] + scnt[r] * b3[c]) / fmaxf(scnt[r], 1.f);
  }
  __syncthreads();
  emit_bf16<H>(sf, bb, s.agg, row0, BM);  // agg -> bb
  __syncthreads();
  ea::product2<BM, H, false>(sf, p.x + (size_t)row0 * H, H, p.wg0, H, H, bb,
                             LDA, p.wg0 + (size_t)H * H, H, H);
  const float* b4 = p.bias + 4 * H;
  for (int i = threadIdx.x; i < BM * H; i += NTHREADS) {
    const int r = i / H, c = i % H;
    sf[r * LDF + c] = fmaxf(sf[r * LDF + c] + b4[c], 0.f);
  }
  __syncthreads();
  emit_bf16<H>(sf, bc, s.g1, row0, BM);  // g1 -> bc
  __syncthreads();
  ea::product<BM, H, false>(sf, bc, LDA, p.wg1, H, H);
  const float* b5 = p.bias + 5 * H;
  for (int i = threadIdx.x; i < BM * H; i += NTHREADS) {
    const int r = i / H, c = i % H;
    sf[r * LDF + c] += b5[c];
  }
  __syncthreads();
  emit_bf16<H>(sf, ba, s.x1, row0, BM);  // x1 -> ba
  __syncthreads();
  ea::product<BM, H, false>(sf, ba, LDA, p.wb0, H, H);
  const float* b6 = p.bias + 6 * H;
  for (int i = threadIdx.x; i < BM * H; i += NTHREADS) {
    const int r = i / H, c = i % H;
    sf[r * LDF + c] = fmaxf(sf[r * LDF + c] + b6[c], 0.f);
  }
  __syncthreads();
  emit_bf16<H>(sf, bb, s.b1, row0, BM);  // b1 -> bb
  __syncthreads();

  // dx2 = dz_x after the mask; dx2c = bf16(dx2)
  for (int rr = 0; rr < RPW; ++rr) {
    const int r = warp * RPW + rr;
    const size_t gh = (size_t)(row0 + r) * H;
    const uint32_t rk = p.drop.key((uint32_t)(p.e + row0 + r));
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int c = q * 64 + lane * 2;
      sf[r * LDF + c] = masked(p, p.dzx, gh, c, rk);
      sf[r * LDF + c + 1] = masked(p, p.dzx, gh, c + 1, rk);
    }
  }
  __syncthreads();
  ea::colsum<BM>(sf, LDF, H, H, nullptr, sums + 4 * H);  // b_b1
  emit_bf16<H>(sf, ba, s.dx2c, row0, BM);
  __syncthreads();
  // dzb = bf16(where(b1 > 0, dx2c @ W_b1^T, 0))
  ea::product<BM, H, true>(sf, ba, LDA, p.wb1, H, H);
  for (int i = threadIdx.x; i < BM * H; i += NTHREADS) {
    const int r = i / H, c = i % H;
    if (!(__bfloat162float(bb[r * LDA + c]) > 0.f)) sf[r * LDF + c] = 0.f;
  }
  __syncthreads();
  ea::colsum<BM>(sf, LDF, H, H, nullptr, sums + 3 * H);  // b_b0
  emit_bf16<H>(sf, ba, s.dzb, row0, BM);
  __syncthreads();
  // dx1 = dx2 + dzb @ W_b0^T; dx1c = bf16(dx1)
  ea::product<BM, H, true>(sf, ba, LDA, p.wb0, H, H);
  for (int rr = 0; rr < RPW; ++rr) {
    const int r = warp * RPW + rr;
    const size_t gh = (size_t)(row0 + r) * H;
    const uint32_t rk = p.drop.key((uint32_t)(p.e + row0 + r));
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int c = q * 64 + lane * 2;
      sf[r * LDF + c] = masked(p, p.dzx, gh, c, rk) + sf[r * LDF + c];
      sf[r * LDF + c + 1] =
          masked(p, p.dzx, gh, c + 1, rk) + sf[r * LDF + c + 1];
    }
  }
  __syncthreads();
  ea::colsum<BM>(sf, LDF, H, H, nullptr, sums + 2 * H);  // b_g1
  emit_bf16<H>(sf, ba, s.dx1c, row0, BM);
  __syncthreads();
  // dzg = bf16(where(g1 > 0, dx1c @ W_g1^T, 0))
  ea::product<BM, H, true>(sf, ba, LDA, p.wg1, H, H);
  for (int i = threadIdx.x; i < BM * H; i += NTHREADS) {
    const int r = i / H, c = i % H;
    if (!(__bfloat162float(bc[r * LDA + c]) > 0.f)) sf[r * LDF + c] = 0.f;
  }
  __syncthreads();
  ea::colsum<BM>(sf, LDF, H, H, nullptr, sums + 1 * H);  // b_g0
  emit_bf16<H>(sf, ba, s.dzg, row0, BM);
  __syncthreads();
  // dxt = dzg @ W_g0[:H]^T (f32)
  ea::product<BM, H, true>(sf, ba, LDA, p.wg0, H, H);
  for (int i = threadIdx.x; i < BM * H; i += NTHREADS) {
    const int r = i / H, c = i % H;
    s.dxt[(size_t)(row0 + r) * H + c] = sf[r * LDF + c];
  }
  __syncthreads();
  // dagg_d = dzg @ W_g0[H:]^T / max(cnt, 1); daggc = bf16(dagg_d)
  ea::product<BM, H, true>(sf, ba, LDA, p.wg0 + (size_t)H * H, H, H);
  for (int i = threadIdx.x; i < BM * H; i += NTHREADS) {
    const int r = i / H, c = i % H;
    sf[r * LDF + c] /= fmaxf(scnt[r], 1.f);
  }
  __syncthreads();
  ea::colsum<BM>(sf, LDF, H, H, scnt, sums);  // b_p1: sum of cnt * dagg_d
  emit_bf16<H>(sf, bb, s.daggc, row0, BM);
  __syncthreads();
  // dsm = bf16(daggc @ W_p1^T)
  ea::product<BM, H, true>(sf, bb, LDA, p.wp1, H, H);
  emit_bf16<H>(sf, nullptr, s.dsm, row0, BM);
}

// ---- pass 2: slot side ----------------------------------------------------
template <int H, bool ENC>
__global__ void __launch_bounds__(NTHREADS, 1) bwd_edge_kernel(Params p) {
  constexpr int LDA = lda_of(H);
  constexpr int LDF = ldf_of(H);
  constexpr int NQ = H / 64;
  constexpr int RPW = BM / NWARP;
  constexpr int LDH = lda_of(ea::ENC_HID);
  extern __shared__ __align__(128) unsigned char smem[];
  float* sf = reinterpret_cast<float*>(smem);
  bf16* ba = reinterpret_cast<bf16*>(sf + BM * LDF);
  bf16* bb = ba + BM * LDA;
  bf16* sh1 = bb + BM * LDA;
  bf16* sh2 = sh1 + BM * LDH;
  int* srecv = reinterpret_cast<int*>(sh2 + BM * LDH);
  const Scratch& s = p.s;
  const int f0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nvalid = min(BM, p.e - f0);
  float* sums = s.esum + (size_t)blockIdx.x * EDGE_SUMS * H;
  if (threadIdx.x < BM)
    srecv[threadIdx.x] = threadIdx.x < nvalid ? p.recv[f0 + threadIdx.x] : -1;
  ea::load_rows<BM, H>(ba, p.e1s + (size_t)f0 * H, nvalid);  // e1 -> ba
  if constexpr (ENC) {
    // h1, h2 and e_in from the raw rows, for the weight passes and masks
    ea::encoder_hidden<BM>(p.e_in, f0, p.e, p.wen0, p.wen1, p.bias + 8 * H,
                           p.bias + 9 * H, sh1, sh2, sf);
    for (int i = threadIdx.x; i < BM * ea::ENC_HID; i += NTHREADS) {
      const int r = i / ea::ENC_HID, c = i % ea::ENC_HID;
      if (r < nvalid) {
        s.hen1[(size_t)(f0 + r) * ea::ENC_HID + c] = sh1[r * LDH + c];
        s.hen2[(size_t)(f0 + r) * ea::ENC_HID + c] = sh2[r * LDH + c];
      }
    }
    ea::product<BM, H, false>(sf, sh2, LDH, p.wen2, H, ea::ENC_HID);
    const float* b10 = p.bias + 10 * H;
    for (int i = threadIdx.x; i < BM * H; i += NTHREADS) {
      const int r = i / H, c = i % H;
      sf[r * LDF + c] += b10[c];
    }
    __syncthreads();
    emit_bf16<H>(sf, nullptr, s.ein, f0, nvalid);
  }
  __syncthreads();

  // e2 = bf16(e1 @ W_e1 + b_e1), for dW_pe
  ea::product<BM, H, false>(sf, ba, LDA, p.we1, H, H);
  const float* b1 = p.bias + H;
  for (int i = threadIdx.x; i < BM * H; i += NTHREADS) {
    const int r = i / H, c = i % H;
    sf[r * LDF + c] += b1[c];
  }
  __syncthreads();
  emit_bf16<H>(sf, nullptr, s.e2, f0, nvalid);
  __syncthreads();

  // dzm = bf16(where(m1 > 0, dsm[recv], 0))
  for (int rr = 0; rr < RPW; ++rr) {
    const int r = warp * RPW + rr;
    const int v = srecv[r];
    const size_t gh = (size_t)(f0 + r) * H;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int c = q * 64 + lane * 2;
      float d0 = 0.f, d1 = 0.f;
      if (v >= 0) {
        const float2 m = ea::ld2(p.m1s + gh + c);
        const float2 d = ea::ld2(s.dsm + (size_t)v * H + c);
        d0 = m.x > 0.f ? d.x : 0.f;
        d1 = m.y > 0.f ? d.y : 0.f;
      }
      sf[r * LDF + c] = d0;
      sf[r * LDF + c + 1] = d1;
    }
  }
  __syncthreads();
  ea::colsum<BM>(sf, LDF, H, H, nullptr, sums + 2 * H);  // b_p0
  emit_bf16<H>(sf, bb, s.dzm, f0, nvalid);
  __syncthreads();

  // de2 = dz_e (masked) + dzm @ W_pe^T; de2c = bf16(de2)
  ea::product<BM, H, true>(sf, bb, LDA, p.wpe, H, H);
  for (int rr = 0; rr < RPW; ++rr) {
    const int r = warp * RPW + rr;
    if (r >= nvalid) continue;
    const size_t gh = (size_t)(f0 + r) * H;
    const uint32_t rk = p.drop.key((uint32_t)(f0 + r));
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int c = q * 64 + lane * 2;
      sf[r * LDF + c] = masked(p, p.dze, gh, c, rk) + sf[r * LDF + c];
      sf[r * LDF + c + 1] =
          masked(p, p.dze, gh, c + 1, rk) + sf[r * LDF + c + 1];
    }
  }
  __syncthreads();
  ea::colsum<BM>(sf, LDF, H, H, nullptr, sums + 1 * H);  // b_e1
  emit_bf16<H>(sf, bb, s.de2c, f0, nvalid);
  __syncthreads();

  // de1 = bf16(where(e1 > 0, de2c @ W_e1^T, 0))
  ea::product<BM, H, true>(sf, bb, LDA, p.we1, H, H);
  for (int i = threadIdx.x; i < BM * H; i += NTHREADS) {
    const int r = i / H, c = i % H;
    if (!(__bfloat162float(ba[r * LDA + c]) > 0.f)) sf[r * LDF + c] = 0.f;
  }
  __syncthreads();
  ea::colsum<BM>(sf, LDF, H, H, nullptr, sums);  // b_e0
  emit_bf16<H>(sf, ba, s.de1, f0, nvalid);
  __syncthreads();

  // deo = de1 @ W_ee^T (+ dz_e with the skip)
  ea::product<BM, H, true>(sf, ba, LDA, p.wee, H, H);
  if (p.skip) {
    for (int rr = 0; rr < RPW; ++rr) {
      const int r = warp * RPW + rr;
      if (r >= nvalid) continue;
      const size_t gh = (size_t)(f0 + r) * H;
      const uint32_t rk = p.drop.key((uint32_t)(f0 + r));
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const int c = q * 64 + lane * 2;
        sf[r * LDF + c] += masked(p, p.dze, gh, c, rk);
        sf[r * LDF + c + 1] += masked(p, p.dze, gh, c + 1, rk);
      }
    }
    __syncthreads();
  }
  if constexpr (!ENC) {
    emit_bf16<H>(sf, nullptr, p.de_win, f0, nvalid);
  } else {
    // the encoder's backward: deo_c -> dz2 -> dz1
    constexpr int LDF128 = ldf_of(ea::ENC_HID);
    ea::colsum<BM>(sf, LDF, H, H, nullptr, sums + 5 * H);  // be_2
    emit_bf16<H>(sf, bb, s.deoc, f0, nvalid);
    __syncthreads();
    ea::product<BM, ea::ENC_HID, true>(sf, bb, LDA, p.wen2, H, H);
    for (int i = threadIdx.x; i < BM * ea::ENC_HID; i += NTHREADS) {
      const int r = i / ea::ENC_HID, c = i % ea::ENC_HID;
      float v = sf[r * LDF128 + c];
      if (!(__bfloat162float(sh2[r * LDH + c]) > 0.f)) v = 0.f;
      sf[r * LDF128 + c] = v;
      const bf16 vb = __float2bfloat16_rn(v);
      sh2[r * LDH + c] = vb;  // dz2 replaces h2
      if (r < nvalid) s.dz2[(size_t)(f0 + r) * ea::ENC_HID + c] = vb;
    }
    __syncthreads();
    ea::colsum<BM>(sf, LDF128, ea::ENC_HID, H, nullptr, sums + 4 * H);
    __syncthreads();
    ea::product<BM, ea::ENC_HID, true>(sf, sh2, LDH, p.wen1, ea::ENC_HID,
                                       ea::ENC_HID);
    for (int i = threadIdx.x; i < BM * ea::ENC_HID; i += NTHREADS) {
      const int r = i / ea::ENC_HID, c = i % ea::ENC_HID;
      float v = sf[r * LDF128 + c];
      if (!(__bfloat162float(sh1[r * LDH + c]) > 0.f)) v = 0.f;
      sf[r * LDF128 + c] = v;
      if (r < nvalid)
        s.dz1[(size_t)(f0 + r) * ea::ENC_HID + c] = __float2bfloat16_rn(v);
    }
    __syncthreads();
    ea::colsum<BM>(sf, LDF128, ea::ENC_HID, H, nullptr, sums + 3 * H);
  }
}

// ---- pass 3: the receiver and sender folds into dx -------------------------
template <int H>
__global__ void __launch_bounds__(NTHREADS, 1) bwd_node2_kernel(Params p) {
  constexpr int LDA = lda_of(H);
  constexpr int LDS = lda_of(2 * H);
  constexpr int LDF = ldf_of(H);
  constexpr int NQ = H / 64;
  constexpr int RPW = BM / NWARP;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sf = reinterpret_cast<float*>(smem);
  bf16* ba = reinterpret_cast<bf16*>(sf + BM * LDF);
  bf16* bs = ba + BM * LDA;
  const Scratch& s = p.s;
  const int row0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int rr = 0; rr < RPW; ++rr) {
    const int r = warp * RPW + rr;
    const int n = row0 + r;
    // r_de1: the node's run of de1 rows (it is their receiver)
    float acc[NQ][2];
#pragma unroll
    for (int q = 0; q < NQ; ++q) acc[q][0] = acc[q][1] = 0.f;
    for (int f = p.rlo[n]; f < p.rhi[n]; ++f) {
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const float2 d = ea::ld2(s.de1 + (size_t)f * H + q * 64 + lane * 2);
        acc[q][0] += d.x;
        acc[q][1] += d.y;
      }
    }
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int c = q * 64 + lane * 2;
      ea::st2(ba + r * LDA + c, acc[q][0], acc[q][1]);
      ea::st2(s.rde1 + (size_t)n * H + c, acc[q][0], acc[q][1]);
    }
    // s = [de1 | dzm] summed over the node's sender-sorted slots: the
    // slab-overlap halo and the far rows in one pass
    float sa[NQ][2], sz[NQ][2];
#pragma unroll
    for (int q = 0; q < NQ; ++q) sa[q][0] = sa[q][1] = sz[q][0] = sz[q][1] = 0.f;
    for (int k = p.soff[n]; k < p.soff[n + 1]; ++k) {
      const size_t gh = (size_t)p.sorder[k] * H;
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const int c = q * 64 + lane * 2;
        const float2 d = ea::ld2(s.de1 + gh + c);
        const float2 z = ea::ld2(s.dzm + gh + c);
        sa[q][0] += d.x;
        sa[q][1] += d.y;
        sz[q][0] += z.x;
        sz[q][1] += z.y;
      }
    }
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int c = q * 64 + lane * 2;
      ea::st2(bs + r * LDS + c, sa[q][0], sa[q][1]);
      ea::st2(bs + r * LDS + H + c, sz[q][0], sz[q][1]);
      ea::st2(s.snode + (size_t)n * 2 * H + c, sa[q][0], sa[q][1]);
      ea::st2(s.snode + (size_t)n * 2 * H + H + c, sz[q][0], sz[q][1]);
    }
  }
  __syncthreads();
  // dx = bf16(r_de1 @ W_er^T + s @ W_sp^T + dxt (+ dz_x))
  ea::product2<BM, H, true>(sf, ba, LDA, p.wer, H, H, bs, LDS, p.wsp, 2 * H,
                            2 * H);
  for (int rr = 0; rr < RPW; ++rr) {
    const int r = warp * RPW + rr;
    const size_t gh = (size_t)(row0 + r) * H;
    const uint32_t rk = p.drop.key((uint32_t)(p.e + row0 + r));
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int c = q * 64 + lane * 2;
      float v0 = sf[r * LDF + c] + s.dxt[gh + c];
      float v1 = sf[r * LDF + c + 1] + s.dxt[gh + c + 1];
      if (p.skip) {
        v0 += masked(p, p.dzx, gh, c, rk);
        v1 += masked(p, p.dzx, gh, c + 1, rk);
      }
      ea::st2(p.dx + gh + c, v0, v1);
    }
  }
}

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

struct Grads {
  float *wer, *wee, *wsp, *we1, *wpe, *wp1, *wg0, *wg1, *wb0, *wb1;
  float *wen0, *wen1, *wen2, *bias;
};

template <int H, bool ENC>
cudaError_t launch(const Params& p, const Grads& g, cudaStream_t st) {
  cudaError_t err;
  const Scratch& s = p.s;
  const int nb = p.n / BM, eb = (p.e + BM - 1) / BM;
  const int smem1 = BM * ldf_of(H) * 4 + 3 * BM * lda_of(H) * 2 + BM * 4;
  if ((err = set_smem(bwd_node1_kernel<H>, smem1)) != cudaSuccess)
    return err;
  bwd_node1_kernel<H><<<nb, NTHREADS, smem1, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int smem2 = BM * ldf_of(H) * 4 + 2 * BM * lda_of(H) * 2 +
                    2 * BM * lda_of(ea::ENC_HID) * 2 + BM * 4;
  if ((err = set_smem(bwd_edge_kernel<H, ENC>, smem2)) != cudaSuccess)
    return err;
  bwd_edge_kernel<H, ENC><<<eb, NTHREADS, smem2, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int smem3 =
      BM * ldf_of(H) * 4 + BM * lda_of(H) * 2 + BM * lda_of(2 * H) * 2;
  if ((err = set_smem(bwd_node2_kernel<H>, smem3)) != cudaSuccess)
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
  if ((err = splitk::bias_reduce(s.nsum, nb, NODE_SUMS, NODE_SUMS,
                                 {{3, 4, 5, 6, 7}}, H, g.bias, st)) !=
      cudaSuccess)
    return err;
  return splitk::bias_reduce(s.esum, eb, EDGE_SUMS, ENC ? EDGE_SUMS : 3,
                             {{0, 1, 2, 8, 9, 10}}, H, g.bias, st);
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
  p.wer = static_cast<const bf16*>(wer);
  p.wee = static_cast<const bf16*>(wee);
  p.wsp = static_cast<const bf16*>(wsp);
  p.we1 = static_cast<const bf16*>(we1);
  p.wpe = static_cast<const bf16*>(wpe);
  p.wp1 = static_cast<const bf16*>(wp1);
  p.wg0 = static_cast<const bf16*>(wg0);
  p.wg1 = static_cast<const bf16*>(wg1);
  p.wb0 = static_cast<const bf16*>(wb0);
  p.wb1 = static_cast<const bf16*>(wb1);
  p.wen0 = static_cast<const bf16*>(wen0);
  p.wen1 = static_cast<const bf16*>(wen1);
  p.wen2 = static_cast<const bf16*>(wen2);
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
  p.enc = enc;
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
