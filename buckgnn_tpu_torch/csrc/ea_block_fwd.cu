// Fused edge-augmented GraphNetBlock forward for Hopper (sm_90a).
//
// Replaces the TPU kernel buckgnn_tpu/ops/pallas_ea_block.py::_fwd_kernel
// (launched by _call_fwd; its body is _recompute and, in encoder mode,
// _enc_chain). The function and its cast points are in
// buckgnn_tpu_torch/ops/ea_block.py (module docstring); the plain version
// there, ea_block_fwd_plain, is the same computation in PyTorch.
//
// The TPU kernel walks node tiles in order: it DMAs a tile's x-slab,
// multiplies a [W, slab + Ct] one-hot selection with the slab's and the far
// rows' projections to find each slot's sender, a [W, tile] one for its
// receiver, and the transposed receiver selection for the scatter-mean.
// Here the windows are flattened to E slots and three passes run on one
// stream:
//   1. projection pass, one block per 64 nodes and H output columns:
//      p = bf16(x @ [W_sp | W_er]) -> [N, 3H] scratch, once per node (the
//      TPU projects every slab row, and adjacent slabs overlap by width);
//   2. edge pass, one block per 64 slots: the slot's sender and receiver
//      projections are row gathers of p by global id (the far table and
//      the slab are one id space; pads gather nothing), and e1 -> e2 -> m1
//      chain in shared memory (a 64-row bf16 tile of H = 512 is 64 KB);
//      writes ze (skip and dropout applied), m1 and, with save_res, e1; in
//      encoder mode the 3-layer edge encoder runs first from the raw
//      [64, 8] rows, so the encoded window never reaches device memory;
//   3. node pass, one block per 32 nodes: sm sums each node's contiguous
//      run of m1 rows (slots are receiver-sorted), then agg, gamma, beta,
//      skip and dropout; x1f stays in shared memory in f32 for x2.
// Products are wmma 16x16x16 bf16 with f32 sums from shared or global
// memory; weights are read from global memory (L2). No TMA, wgmma or
// pipelining yet.
//
// What bounds it on an H100: at the ea-virtual shape (224,650 valid slots
// of E = 239,168, N = 51,712, H = 512) the useful products are 2 H^2 (3 E
// + 9 N) over valid slots = 597 GFLOP (0.60 ms at 989 TFLOP/s) against
// ~0.5 GB of compulsory traffic (0.15 ms at 3.35 TB/s): bound by
// operations. This design also writes
// and reads p (159 MB) and, when serving, m1 (245 MB).

#include "ea_common.cuh"

namespace {

using ea::bf16;
using ea::lda_of;
using ea::ldf_of;
using ea::NTHREADS;
using ea::NWARP;

struct Params {
  const bf16* x;      // [N, H]
  const bf16* e_in;   // [E, H], or the raw [E, 8] window (enc)
  const bf16 *wer, *wee, *wsp, *we1, *wpe, *wp1, *wg0, *wg1, *wb0, *wb1;
  const bf16 *wen0, *wen1, *wen2;
  const float* bias;  // [8 | 11, H]
  const int *send, *recv, *rlo, *rhi;
  const float* cnt;   // [N]
  bf16* proj;         // [N, 3H] scratch
  bf16 *zx, *ze, *e1s, *m1s;
  int n, e, enc, skip, save_res;
  ea::Drop drop;
};

constexpr int BM_P = 64;  // rows per projection block
constexpr int BM_E = 64;  // slots per edge block
constexpr int BM_N = 32;  // nodes per node block

// the encoder's two [BM_E, 128] hidden tiles fit in the e_in tile's space
__host__ __device__ constexpr bool enc_overlay(int h) {
  return 2 * lda_of(ea::ENC_HID) <= lda_of(h);
}

// ---- pass 1: p = bf16(x @ [W_sp | W_er]) --------------------------------
template <int H>
__global__ void __launch_bounds__(NTHREADS, 1) fwd_proj_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* sf = reinterpret_cast<float*>(smem);
  const int row0 = blockIdx.x * BM_P;
  const int part = blockIdx.y;  // 0, 1: halves of W_sp; 2: W_er
  const bf16* b = part < 2 ? p.wsp + part * H : p.wer;
  const int ldb = part < 2 ? 2 * H : H;
  ea::product<BM_P, H, false>(sf, p.x + (size_t)row0 * H, H, b, ldb, H);
  constexpr int LDF = ldf_of(H);
  for (int i = threadIdx.x; i < BM_P * H / 2; i += NTHREADS) {
    const int r = i / (H / 2);
    const int c = (i % (H / 2)) * 2;
    ea::st2(p.proj + (size_t)(row0 + r) * 3 * H + part * H + c,
            sf[r * LDF + c], sf[r * LDF + c + 1]);
  }
}

// ---- pass 2: the edge chain ---------------------------------------------
template <int H, bool ENC>
__global__ void __launch_bounds__(NTHREADS, 1) fwd_edge_kernel(Params p) {
  constexpr int LDA = lda_of(H);
  constexpr int LDF = ldf_of(H);
  constexpr int NQ = H / 64;
  constexpr int RPW = BM_E / NWARP;
  constexpr int LDH = lda_of(ea::ENC_HID);
  extern __shared__ __align__(128) unsigned char smem[];
  float* sf = reinterpret_cast<float*>(smem);
  bf16* sa = reinterpret_cast<bf16*>(smem + BM_E * LDF * 4);
  // encoder mode: h1 and h2 overlay sa when they fit (H = 512), else they
  // follow it
  bf16* sh1 = enc_overlay(H) ? sa : sa + BM_E * LDA;
  bf16* sh2 = sh1 + BM_E * LDH;
  int* ssend = reinterpret_cast<int*>(
      smem + BM_E * LDF * 4 + BM_E * LDA * 2 +
      (ENC && !enc_overlay(H) ? 2 * BM_E * LDH * 2 : 0));
  int* srecv = ssend + BM_E;
  const int f0 = blockIdx.x * BM_E;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nvalid = min(BM_E, p.e - f0);
  if (threadIdx.x < BM_E) {
    const bool ok = threadIdx.x < nvalid;
    ssend[threadIdx.x] = ok ? p.send[f0 + threadIdx.x] : -1;
    srecv[threadIdx.x] = ok ? p.recv[f0 + threadIdx.x] : -1;
  }
  // e_in -> sa
  if constexpr (ENC) {
    ea::encoder_hidden<BM_E>(p.e_in, f0, p.e, p.wen0, p.wen1, p.bias + 8 * H,
                             p.bias + 9 * H, sh1, sh2, sf);
    ea::product<BM_E, H, false>(sf, sh2, LDH, p.wen2, H, ea::ENC_HID);
    const float* b10 = p.bias + 10 * H;
    for (int i = threadIdx.x; i < BM_E * H / 2; i += NTHREADS) {
      const int r = i / (H / 2);
      const int c = (i % (H / 2)) * 2;
      ea::st2(sa + r * LDA + c, sf[r * LDF + c] + b10[c],
              sf[r * LDF + c + 1] + b10[c + 1]);
    }
  } else {
    ea::load_rows<BM_E, H>(sa, p.e_in + (size_t)f0 * H, nvalid);
  }
  __syncthreads();

  // e1 = bf16(relu(e_in @ W_ee + p_r[recv] + p_s[send] + b_e0))
  ea::product<BM_E, H, false>(sf, sa, LDA, p.wee, H, H);
  for (int rr = 0; rr < RPW; ++rr) {
    const int r = warp * RPW + rr;
    const int s = ssend[r];
    const int v = srecv[r];
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int c = q * 64 + lane * 2;
      float z0 = sf[r * LDF + c], z1 = sf[r * LDF + c + 1];
      if (v >= 0) {
        const float2 pr = ea::ld2(p.proj + (size_t)v * 3 * H + 2 * H + c);
        z0 += pr.x;
        z1 += pr.y;
      }
      if (s >= 0) {
        const float2 ps = ea::ld2(p.proj + (size_t)s * 3 * H + c);
        z0 += ps.x;
        z1 += ps.y;
      }
      z0 = fmaxf(z0 + p.bias[c], 0.f);
      z1 = fmaxf(z1 + p.bias[c + 1], 0.f);
      ea::st2(sa + r * LDA + c, z0, z1);
      if (p.save_res && r < nvalid)
        ea::st2(p.e1s + (size_t)(f0 + r) * H + c, z0, z1);
    }
  }
  __syncthreads();

  // e2f = e1 @ W_e1 + b_e1; ze = dropout(e2f (+ e_in)); e2 = bf16(e2f)
  ea::product<BM_E, H, false>(sf, sa, LDA, p.we1, H, H);
  const float* b1 = p.bias + H;
  for (int rr = 0; rr < RPW; ++rr) {
    const int r = warp * RPW + rr;
    const bool ok = r < nvalid;
    const size_t gh = (size_t)(f0 + r) * H;
    const uint32_t rk = p.drop.key((uint32_t)(f0 + r));
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int c = q * 64 + lane * 2;
      const float a0 = sf[r * LDF + c] + b1[c];
      const float a1 = sf[r * LDF + c + 1] + b1[c + 1];
      ea::st2(sa + r * LDA + c, a0, a1);
      if (!ok) continue;
      float o0 = a0, o1 = a1;
      if (p.skip) {
        const float2 ei = ea::ld2(p.e_in + gh + c);
        o0 += ei.x;
        o1 += ei.y;
      }
      if (p.drop.on) {
        o0 = p.drop.apply(o0, rk, c);
        o1 = p.drop.apply(o1, rk, c + 1);
      }
      ea::st2(p.ze + gh + c, o0, o1);
    }
  }
  __syncthreads();

  // m1 = bf16(relu(e2 @ W_pe + p_p[send] + b_p0))
  ea::product<BM_E, H, false>(sf, sa, LDA, p.wpe, H, H);
  const float* b2 = p.bias + 2 * H;
  for (int rr = 0; rr < RPW; ++rr) {
    const int r = warp * RPW + rr;
    if (r >= nvalid) continue;
    const int s = ssend[r];
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int c = q * 64 + lane * 2;
      float z0 = sf[r * LDF + c], z1 = sf[r * LDF + c + 1];
      if (s >= 0) {
        const float2 ps = ea::ld2(p.proj + (size_t)s * 3 * H + H + c);
        z0 += ps.x;
        z1 += ps.y;
      }
      ea::st2(p.m1s + (size_t)(f0 + r) * H + c, fmaxf(z0 + b2[c], 0.f),
              fmaxf(z1 + b2[c + 1], 0.f));
    }
  }
}

// ---- pass 3: the node chain ---------------------------------------------
template <int H>
__global__ void __launch_bounds__(NTHREADS, 1) fwd_node_kernel(Params p) {
  constexpr int LDA = lda_of(H);
  constexpr int LDF = ldf_of(H);
  constexpr int NQ = H / 64;
  constexpr int RPW = BM_N / NWARP;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sf = reinterpret_cast<float*>(smem);
  float* sx1 = sf + BM_N * LDF;
  bf16* sa = reinterpret_cast<bf16*>(sx1 + BM_N * LDF);
  const int row0 = blockIdx.x * BM_N;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // sm = bf16(sum of the node's m1 rows, in slot order)
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
    for (int q = 0; q < NQ; ++q)
      ea::st2(sa + r * LDA + q * 64 + lane * 2, acc[q][0], acc[q][1]);
  }
  __syncthreads();

  // agg = bf16((sm @ W_p1 + cnt * b_p1) / max(cnt, 1))
  ea::product<BM_N, H, false>(sf, sa, LDA, p.wp1, H, H);
  const float* b3 = p.bias + 3 * H;
  for (int i = threadIdx.x; i < BM_N * H; i += NTHREADS) {
    const int r = i / H, c = i % H;
    const float cn = p.cnt[row0 + r];
    sa[r * LDA + c] = __float2bfloat16_rn((sf[r * LDF + c] + cn * b3[c]) /
                                          fmaxf(cn, 1.f));
  }
  __syncthreads();

  // g1 = bf16(relu(x @ W_g0[:H] + agg @ W_g0[H:] + b_g0))
  ea::product2<BM_N, H, false>(sf, p.x + (size_t)row0 * H, H, p.wg0, H, H,
                               sa, LDA, p.wg0 + (size_t)H * H, H, H);
  const float* b4 = p.bias + 4 * H;
  for (int i = threadIdx.x; i < BM_N * H; i += NTHREADS) {
    const int r = i / H, c = i % H;
    sa[r * LDA + c] = __float2bfloat16_rn(fmaxf(sf[r * LDF + c] + b4[c], 0.f));
  }
  __syncthreads();

  // x1f = g1 @ W_g1 + b_g1 (kept in f32), x1 = bf16(x1f)
  ea::product<BM_N, H, false>(sf, sa, LDA, p.wg1, H, H);
  const float* b5 = p.bias + 5 * H;
  for (int i = threadIdx.x; i < BM_N * H; i += NTHREADS) {
    const int r = i / H, c = i % H;
    const float v = sf[r * LDF + c] + b5[c];
    sx1[r * LDF + c] = v;
    sa[r * LDA + c] = __float2bfloat16_rn(v);
  }
  __syncthreads();

  // b1 = bf16(relu(x1 @ W_b0 + b_b0))
  ea::product<BM_N, H, false>(sf, sa, LDA, p.wb0, H, H);
  const float* b6 = p.bias + 6 * H;
  for (int i = threadIdx.x; i < BM_N * H; i += NTHREADS) {
    const int r = i / H, c = i % H;
    sa[r * LDA + c] = __float2bfloat16_rn(fmaxf(sf[r * LDF + c] + b6[c], 0.f));
  }
  __syncthreads();

  // zx = bf16(dropout(x1f + b1 @ W_b1 + b_b1 (+ x)))
  ea::product<BM_N, H, false>(sf, sa, LDA, p.wb1, H, H);
  const float* b7 = p.bias + 7 * H;
  for (int rr = 0; rr < RPW; ++rr) {
    const int r = warp * RPW + rr;
    const size_t gh = (size_t)(row0 + r) * H;
    const uint32_t rk = p.drop.key((uint32_t)(p.e + row0 + r));
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int c = q * 64 + lane * 2;
      float o0 = sx1[r * LDF + c] + sf[r * LDF + c] + b7[c];
      float o1 = sx1[r * LDF + c + 1] + sf[r * LDF + c + 1] + b7[c + 1];
      if (p.skip) {
        const float2 xv = ea::ld2(p.x + gh + c);
        o0 += xv.x;
        o1 += xv.y;
      }
      if (p.drop.on) {
        o0 = p.drop.apply(o0, rk, c);
        o1 = p.drop.apply(o1, rk, c + 1);
      }
      ea::st2(p.zx + gh + c, o0, o1);
    }
  }
}

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <int H, bool ENC>
cudaError_t launch(const Params& p, cudaStream_t st) {
  cudaError_t err;
  const int smem_p = BM_P * ldf_of(H) * 4;
  if ((err = set_smem(fwd_proj_kernel<H>, smem_p)) != cudaSuccess)
    return err;
  fwd_proj_kernel<H><<<dim3(p.n / BM_P, 3), NTHREADS, smem_p, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int smem_e = BM_E * ldf_of(H) * 4 + BM_E * lda_of(H) * 2 +
                     (ENC && !enc_overlay(H)
                          ? 2 * BM_E * lda_of(ea::ENC_HID) * 2 : 0) +
                     2 * BM_E * 4;
  if ((err = set_smem(fwd_edge_kernel<H, ENC>, smem_e)) != cudaSuccess)
    return err;
  fwd_edge_kernel<H, ENC><<<(p.e + BM_E - 1) / BM_E, NTHREADS, smem_e, st>>>(
      p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int smem_n = 2 * BM_N * ldf_of(H) * 4 + BM_N * lda_of(H) * 2;
  if ((err = set_smem(fwd_node_kernel<H>, smem_n)) != cudaSuccess)
    return err;
  fwd_node_kernel<H><<<p.n / BM_N, NTHREADS, smem_n, st>>>(p);
  return cudaGetLastError();
}

size_t align256(size_t b) { return (b + 255) / 256 * 256; }

}  // namespace

extern "C" long long ea_block_fwd_scratch_bytes(int n, int e, int h,
                                                int enc) {
  (void)e;
  (void)enc;
  return (long long)align256((size_t)n * 3 * h * sizeof(bf16));
}

extern "C" int ea_block_fwd(
    const void* x, const void* e_in, const void* wer, const void* wee,
    const void* wsp, const void* we1, const void* wpe, const void* wp1,
    const void* wg0, const void* wg1, const void* wb0, const void* wb1,
    const void* wen0, const void* wen1, const void* wen2, const void* bias,
    const void* send, const void* recv, const void* rlo, const void* rhi,
    const void* cnt, void* scratch, void* zx, void* ze, void* e1s, void* m1s,
    int n, int e, int h, int enc, int skip, int save_res, int dropout,
    unsigned int thr, unsigned int s0, unsigned int s1, float scale,
    void* stream) {
  Params p;
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
  p.send = static_cast<const int*>(send);
  p.recv = static_cast<const int*>(recv);
  p.rlo = static_cast<const int*>(rlo);
  p.rhi = static_cast<const int*>(rhi);
  p.cnt = static_cast<const float*>(cnt);
  p.proj = static_cast<bf16*>(scratch);
  p.zx = static_cast<bf16*>(zx);
  p.ze = static_cast<bf16*>(ze);
  p.e1s = static_cast<bf16*>(e1s);
  p.m1s = static_cast<bf16*>(m1s);
  p.n = n;
  p.e = e;
  p.enc = enc;
  p.skip = skip;
  p.save_res = save_res;
  p.drop = {dropout, thr, s0, s1, scale};
  if (n % BM_P != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (h * 2 + (enc ? 1 : 0)) {
    case 256: err = launch<128, false>(p, st); break;
    case 512: err = launch<256, false>(p, st); break;
    case 513: err = launch<256, true>(p, st); break;
    case 1024: err = launch<512, false>(p, st); break;
    case 1025: err = launch<512, true>(p, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}
