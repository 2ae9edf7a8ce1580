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
// stream, each a chain of products on the engine of ea_common.cuh (64-row
// blocks in clusters of two, weights through a TMA ring, wgmma):
//   1. projection pass: p = bf16(x @ [W_sp | W_er]) -> [N, 3H] scratch, once
//      per node (the TPU projects every slab row; adjacent slabs overlap),
//      x loaded once into the row tile by TMA;
//   2. edge pass, 64 slots a block: e_in comes into the row tile by TMA (in
//      encoder mode the 3-layer edge encoder makes it in place from the raw
//      [64, 8] rows: the first layer as f32 FMAs, the others on the engine),
//      p_s[send] rows by cp.async into a staging tile while e_in @ W_ee
//      runs; e1 -> e2 -> m1 chain in the row tile. Receivers repeat within
//      a block (slots are receiver-sorted), so p_r[recv] is read in the
//      epilogue from L2.
//      Writes ze (skip and dropout applied; through the staging tile, after
//      which p_p[send] is staged during the m1 product), m1 and, with
//      save_res, e1, each from a tile in coalesced 16-byte rows;
//   3. node pass, 64 nodes a block: sm sums each node's contiguous run of
//      m1 rows into the row tile, then agg, g1 = [x | agg] @ W_g0 (x
//      streamed beside the weight's first half), x1, b1 and zx; x1f, needed
//      in f32 by x2, waits in a per-thread scratch between its two uses;
//      the pass's five bias rows wait in shared memory.
//
// What bounds it on an H100: at the ea-virtual shape (224,650 valid slots
// of E = 239,168, N = 51,712, H = 512) the useful products are 2 H^2 (3 E
// + 9 N) over valid slots = 597 GFLOP (0.60 ms at 989 TFLOP/s) against
// ~0.5 GB of compulsory traffic (0.15 ms at 3.35 TB/s): bound by
// operations. Each pass now waits on its epilogues (the chain serialises
// product and epilogue within a block, one block per SM) and on the L2
// gathers; this design also writes and reads p (159 MB) and, when serving,
// m1 (245 MB).

#include "ea_common.cuh"

namespace {

using ea::bf16;
using ea::BK;
using ea::BM;
using ea::NCONS;
using ea::NTHREADS;
using ea::roles;
using ea::Thr;

struct Maps {
  CUtensorMap x, e_in, wsp, wer, wee, we1, wpe, wp1, wg0, wg1, wb0, wb1, wen1,
      wen2;
};

struct Params {
  Maps m;
  const bf16* x;      // [N, H]
  const bf16* e_in;   // [E, H], or the raw [E, 8] window (enc)
  const bf16* wen0;   // [8, 128]
  const float* bias;  // [8 | 11, H]
  const int *send, *recv, *rlo, *rhi;
  const float* cnt;   // [N]
  bf16* proj;         // [N, 3H] scratch
  float* x1f;         // per-thread x1f scratch of the node pass
  bf16 *zx, *ze, *e1s, *m1s;
  int n, e, skip, save_res;
  ea::Drop drop;
};

constexpr int STAGES_E = 3;  // ring slices of the edge pass (H = 512: 32 KB)
constexpr int STAGES = 4;    // of the other passes

#define EA_CLUSTER __cluster_dims__(2, 1, 1)
static_assert(ea::CLUSTER == 2, "EA_CLUSTER names the cluster size");

// ---- the engine alone: out = A @ W or A @ W^T, f32 -------------------------
// For the engine test (tests/test_torch_port_cuda.py): K <= 512 takes A
// whole into the row tile; K = 1024 streams A's first half beside the
// weight and takes the second half into the tile, as [x | agg] @ W_g0 does.
struct TestParams {
  CUtensorMap a, w;
  float* out;
  int m, k;
};

template <int NW, bool MN>
__global__ void EA_CLUSTER __launch_bounds__(NTHREADS, 1)
    engine_test_kernel(const __grid_constant__ TestParams p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = ea::align_smem(smem_raw);
  constexpr int SLICE = ea::slice_bytes(ea::NWG * NW, true);
  unsigned char* tile = smem + ea::ring_offset() + STAGES * SLICE;
  const int row0 = blockIdx.x * BM;
  const int split = p.k > 512 ? p.k / 2 : 0;  // streamed columns
  roles(smem, STAGES, SLICE,
        [&](ea::Producer& pr, uint64_t* abar) {
          pr.tile(tile, abar, &p.a, p.k - split, row0, split);
          if (split) pr.b<MN>(&p.w, ea::NWG * NW, 0, 0, split / BK, &p.a, 0, row0);
          pr.b<MN>(&p.w, ea::NWG * NW, split, 0, (p.k - split) / BK);
        },
        [&](hop::Ring& ring, uint64_t* abar) {
          Thr t;
          float acc[NW / 2];
          hop::mbar_wait(abar, 0);
          if (split) ea::gemm<NW, MN>(acc, ring, 0, split / BK, false, t);
          ea::gemm<NW, MN>(acc, ring, hop::smem_u32(tile), (p.k - split) / BK,
                           split > 0, t);
          ea::pairs<NW>(t, [&](int i, int r, int c) {
            if (row0 + r < p.m)
              *reinterpret_cast<float2*>(p.out + (size_t)(row0 + r) * ea::NWG * NW +
                                         c) = make_float2(acc[i], acc[i + 1]);
          });
        });
}

// ---- pass 1: p = bf16(x @ [W_sp | W_er]) --------------------------------
template <int H>
__global__ void EA_CLUSTER __launch_bounds__(NTHREADS, 1)
    fwd_proj_kernel(const __grid_constant__ Params p) {
  constexpr int NW = H / ea::NWG, NK = H / BK;
  constexpr int SLICE = ea::slice_bytes(H, false);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = ea::align_smem(smem_raw);
  unsigned char* tile = smem + ea::ring_offset() + STAGES * SLICE;
  const int row0 = blockIdx.x * BM;
  const int nvalid = max(0, min(BM, p.n - row0));
  roles(smem, STAGES, SLICE,
        [&](ea::Producer& pr, uint64_t* abar) {
          pr.tile(tile, abar, &p.m.x, H, row0);
          pr.b<true>(&p.m.wsp, H, 0, 0, NK);
          pr.b<true>(&p.m.wsp, H, 0, H, NK);
          pr.b<true>(&p.m.wer, H, 0, 0, NK);
        },
        [&](hop::Ring& ring, uint64_t* abar) {
          Thr t;
          float acc[NW / 2];
          hop::mbar_wait(abar, 0);
          for (int part = 0; part < 3; ++part) {
            ea::gemm<NW, true>(acc, ring, hop::smem_u32(tile), NK, false, t);
            ea::to_global<NW>(acc, p.proj, 3 * H, part * H, row0, nvalid, t);
          }
        });
}

// ---- pass 2: the edge chain ---------------------------------------------
template <int H, bool ENC>
__global__ void EA_CLUSTER __launch_bounds__(NTHREADS, 1)
    fwd_edge_kernel(const __grid_constant__ Params p) {
  constexpr int NW = H / ea::NWG, NK = H / BK;
  constexpr int HW = ea::ENC_HID / ea::NWG;  // the encoder's warpgroup width
  constexpr int SLICE = ea::slice_bytes(H, false);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = ea::align_smem(smem_raw);
  unsigned char* tile = smem + ea::ring_offset() + STAGES_E * SLICE;
  unsigned char* stage = tile + ea::tile_bytes(H);  // gathered rows
  int* ssend = reinterpret_cast<int*>(stage + ea::tile_bytes(H));
  int* srecv = ssend + BM;
  const int f0 = blockIdx.x * BM;
  const int nvalid = max(0, min(BM, p.e - f0));
  roles(smem, STAGES_E, SLICE,
        [&](ea::Producer& pr, uint64_t* abar) {
          if constexpr (ENC) {
            pr.b<true>(&p.m.wen1, ea::ENC_HID, 0, 0, ea::ENC_HID / BK);
            pr.b<true>(&p.m.wen2, H, 0, 0, ea::ENC_HID / BK);
          } else {
            pr.tile(tile, abar, &p.m.e_in, H, f0);
          }
          pr.b<true>(&p.m.wee, H, 0, 0, NK);
          pr.b<true>(&p.m.we1, H, 0, 0, NK);
          pr.b<true>(&p.m.wpe, H, 0, 0, NK);
        },
        [&](hop::Ring& ring, uint64_t* abar) {
          Thr t;
          const uint32_t a = hop::smem_u32(tile);
          if (threadIdx.x < BM) {
            const int r = threadIdx.x;
            const int f = ea::row_or0(f0, r, nvalid);
            const int sd = p.send[f], rv = p.recv[f];
            ssend[r] = r < nvalid ? sd : -1;
            srecv[r] = r < nvalid ? rv : -1;
          }
          hop::named_sync(ea::BAR_ALL, NCONS);
          ea::gather_rows<H>(stage, p.proj, 3 * H, 0, ssend);  // p_s[send]
          float acc[NW / 2];
          if constexpr (ENC) {
            // h1 = bf16(relu(raw @ wen0 + b8)), f32 FMAs in k order
            float h[HW / 2];
            ea::encoder_first<HW>(h, p.e_in, f0, nvalid, p.wen0,
                                  p.bias + 8 * H, t);
            ea::to_tile<HW>(h, tile, t);
            // h2 = bf16(relu(h1 @ wen1 + b9))
            ea::prefetch_bias(p.bias + 9 * H, ea::ENC_HID);
            ea::gemm<HW, true>(h, ring, a, ea::ENC_HID / BK, false, t);
            ea::add_bias<HW>(h, p.bias + 9 * H, t);
            ea::relu<HW>(h);
            ea::to_tile<HW>(h, tile, t);
            // e_in = bf16(h2 @ wen2 + b10)
            ea::prefetch_bias(p.bias + 10 * H, H);
            ea::gemm<NW, true>(acc, ring, a, ea::ENC_HID / BK, false, t);
            ea::add_bias<NW>(acc, p.bias + 10 * H, t);
            ea::to_tile<NW>(acc, tile, t);
          } else {
            hop::mbar_wait(abar, 0);
          }

          // e1 = bf16(relu(e_in @ W_ee + p_r[recv] + p_s[send] + b_e0))
          ea::prefetch_bias(p.bias, H);
          ea::gemm<NW, true>(acc, ring, a, NK, false, t);
          hop::cp_wait_all();
          hop::named_sync(ea::BAR_ALL, NCONS);
          ea::pairs_chunked<NW>(t, [&](int i, int r, int c) {
            const int v = srecv[r];
            if (v >= 0) {
              const float2 pr = ea::ld2(p.proj + (size_t)v * 3 * H + 2 * H + c);
              acc[i] += pr.x;
              acc[i + 1] += pr.y;
            }
            const float2 ps = ea::ld_pair(stage, r, c);
            acc[i] += ps.x;
            acc[i + 1] += ps.y;
          });
          ea::add_bias<NW>(acc, p.bias, t);
          ea::relu<NW>(acc);
          ea::to_tile<NW>(acc, tile, t);
          if (p.save_res) ea::flush<H>(tile, p.e1s, H, 0, f0, nvalid);

          // e2f = e1 @ W_e1 + b_e1; ze = dropout(e2f (+ e_in)); e2 = bf16(e2f)
          ea::prefetch_bias(p.bias + H, H);
          ea::gemm<NW, true>(acc, ring, a, NK, false, t);
          ea::add_bias<NW>(acc, p.bias + H, t);
          ea::to_tile<NW>(acc, tile, t);
          if (p.skip) ea::add_pairs<NW>(acc, p.e_in, H, f0, nvalid, t);
          ea::dropout<NW>(acc, p.drop, f0, t);
          ea::emit<NW>(acc, stage, p.ze, H, f0, nvalid, t);  // via the stage
          hop::named_sync(ea::BAR_ALL, NCONS);
          ea::gather_rows<H>(stage, p.proj, 3 * H, H, ssend);  // p_p[send]

          // m1 = bf16(relu(e2 @ W_pe + p_p[send] + b_p0))
          ea::prefetch_bias(p.bias + 2 * H, H);
          ea::gemm<NW, true>(acc, ring, a, NK, false, t);
          hop::cp_wait_all();
          hop::named_sync(ea::BAR_ALL, NCONS);
          ea::pairs_chunked<NW>(t, [&](int i, int r, int c) {
            const float2 pp = ea::ld_pair(stage, r, c);
            acc[i] += pp.x;
            acc[i + 1] += pp.y;
          });
          ea::add_bias<NW>(acc, p.bias + 2 * H, t);
          ea::relu<NW>(acc);
          ea::emit<NW>(acc, tile, p.m1s, H, f0, nvalid, t);
        });
}

// ---- pass 3: the node chain ---------------------------------------------
template <int H>
__global__ void EA_CLUSTER __launch_bounds__(NTHREADS, 1)
    fwd_node_kernel(const __grid_constant__ Params p) {
  constexpr int NW = H / ea::NWG, NK = H / BK;
  constexpr int SLICE = ea::slice_bytes(H, true);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = ea::align_smem(smem_raw);
  unsigned char* tile = smem + ea::ring_offset() + STAGES * SLICE;
  float* sb = reinterpret_cast<float*>(tile + ea::tile_bytes(H));  // rows 3-7
  const int row0 = blockIdx.x * BM;
  const int nvalid = max(0, min(BM, p.n - row0));
  roles(smem, STAGES, SLICE,
        [&](ea::Producer& pr, uint64_t*) {
          pr.b<true>(&p.m.wp1, H, 0, 0, NK);
          pr.b<true>(&p.m.wg0, H, 0, 0, NK, &p.m.x, 0, row0);
          pr.b<true>(&p.m.wg0, H, H, 0, NK);
          pr.b<true>(&p.m.wg1, H, 0, 0, NK);
          pr.b<true>(&p.m.wb0, H, 0, 0, NK);
          pr.b<true>(&p.m.wb1, H, 0, 0, NK);
        },
        [&](hop::Ring& ring, uint64_t*) {
          Thr t;
          const uint32_t a = hop::smem_u32(tile);
          float acc[NW / 2];
          ea::stage_bias(sb, p.bias, 3, 5, H);
          // sm = bf16(sum of the node's m1 rows, in slot order)
          ea::run_sums<H>(tile, nullptr, 0, 0, p.m1s, H, 0, p.rlo, p.rhi,
                          nullptr, row0, nvalid);
          hop::fence_async_smem();
          hop::named_sync(ea::BAR_ALL, NCONS);

          // agg = bf16((sm @ W_p1 + cnt * b_p1) / max(cnt, 1))
          ea::gemm<NW, true>(acc, ring, a, NK, false, t);
          const float* b3 = sb;
          float cnt[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = t.r0 + 8 * h;
            const float v = ea::ldf(p.cnt + ea::row_or0(row0, r, nvalid));
            cnt[h] = r < nvalid ? v : 0.f;
          }
          ea::pairs_chunked<NW>(t, [&](int i, int r, int c) {
            const float cn = cnt[(i / 2) % 2];
            const float2 b = *reinterpret_cast<const float2*>(b3 + c);
            acc[i] = (acc[i] + cn * b.x) / fmaxf(cn, 1.f);
            acc[i + 1] = (acc[i + 1] + cn * b.y) / fmaxf(cn, 1.f);
          });
          ea::to_tile<NW>(acc, tile, t);

          // g1 = bf16(relu(x @ W_g0[:H] + agg @ W_g0[H:] + b_g0))
          ea::gemm<NW, true>(acc, ring, 0, NK, false, t);
          ea::gemm<NW, true>(acc, ring, a, NK, true, t);
          ea::add_bias<NW>(acc, sb + 1 * H, t);
          ea::relu<NW>(acc);
          ea::to_tile<NW>(acc, tile, t);

          // x1f = g1 @ W_g1 + b_g1 (kept in f32), x1 = bf16(x1f)
          ea::gemm<NW, true>(acc, ring, a, NK, false, t);
          float4* spill = reinterpret_cast<float4*>(p.x1f) +
                          (size_t)blockIdx.x * (NW / 8) * NCONS + threadIdx.x;
          ea::add_bias<NW>(acc, sb + 2 * H, t);
#pragma unroll
          for (int q = 0; q < NW / 8; ++q)
            spill[q * NCONS] = make_float4(acc[4 * q], acc[4 * q + 1],
                                           acc[4 * q + 2], acc[4 * q + 3]);
          ea::to_tile<NW>(acc, tile, t);

          // b1 = bf16(relu(x1 @ W_b0 + b_b0))
          ea::gemm<NW, true>(acc, ring, a, NK, false, t);
          ea::add_bias<NW>(acc, sb + 3 * H, t);
          ea::relu<NW>(acc);
          ea::to_tile<NW>(acc, tile, t);

          // zx = bf16(dropout(x1f + b1 @ W_b1 + b_b1 (+ x)))
          if (p.skip) ea::prefetch_rows(p.x, H * 2, row0, nvalid);
          ea::gemm<NW, true>(acc, ring, a, NK, false, t);
#pragma unroll
          for (int q = 0; q < NW / 8; ++q) {
            const float4 x1 = spill[q * NCONS];
            acc[4 * q] = x1.x + acc[4 * q];
            acc[4 * q + 1] = x1.y + acc[4 * q + 1];
            acc[4 * q + 2] = x1.z + acc[4 * q + 2];
            acc[4 * q + 3] = x1.w + acc[4 * q + 3];
            if (q % 8 == 7) asm volatile("" ::: "memory");
          }
          ea::add_bias<NW>(acc, sb + 4 * H, t);
          if (p.skip) ea::add_pairs<NW>(acc, p.x, H, row0, nvalid, t);
          ea::dropout<NW>(acc, p.drop, p.e + row0, t);
          ea::emit<NW>(acc, tile, p.zx, H, row0, nvalid, t);
        });
}

template <int H, bool ENC>
cudaError_t launch(const Params& p, cudaStream_t st) {
  cudaError_t err;
  const int smem_p = ea::smem_bytes(STAGES, ea::slice_bytes(H, false),
                                    ea::tile_bytes(H));
  if ((err = ea::set_smem(fwd_proj_kernel<H>, smem_p)) != cudaSuccess)
    return err;
  fwd_proj_kernel<H><<<ea::grid_blocks(p.n), NTHREADS, smem_p, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int smem_e = ea::smem_bytes(STAGES_E, ea::slice_bytes(H, false),
                                    2 * ea::tile_bytes(H) + 2 * BM * 4);
  if ((err = ea::set_smem(fwd_edge_kernel<H, ENC>, smem_e)) != cudaSuccess)
    return err;
  fwd_edge_kernel<H, ENC><<<ea::grid_blocks(p.e), NTHREADS, smem_e, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int smem_n = ea::smem_bytes(STAGES, ea::slice_bytes(H, true),
                                    ea::tile_bytes(H) + 5 * H * 4);
  if ((err = ea::set_smem(fwd_node_kernel<H>, smem_n)) != cudaSuccess)
    return err;
  fwd_node_kernel<H><<<ea::grid_blocks(p.n), NTHREADS, smem_n, st>>>(p);
  return cudaGetLastError();
}

size_t align256(size_t b) { return (b + 255) / 256 * 256; }

size_t proj_bytes(int n, int h) {
  return align256((size_t)n * 3 * h * sizeof(bf16));
}

template <int NW, bool MN>
cudaError_t launch_test(const TestParams& p, cudaStream_t st) {
  const int smem = ea::smem_bytes(STAGES, ea::slice_bytes(ea::NWG * NW, true),
                                  ea::tile_bytes(512));
  cudaError_t err = ea::set_smem(engine_test_kernel<NW, MN>, smem);
  if (err != cudaSuccess) return err;
  engine_test_kernel<NW, MN><<<ea::grid_blocks(p.m), NTHREADS, smem, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" long long ea_block_fwd_scratch_bytes(int n, int e, int h,
                                                int enc) {
  (void)e;
  (void)enc;
  // p, then the node pass's x1f: its sums (h / NWG / 2) per consumer
  // thread
  return (long long)(proj_bytes(n, h) +
                     align256((size_t)ea::grid_blocks(n) * NCONS *
                              (h / ea::NWG / 2) * sizeof(float)));
}

// out [m, n] f32 = a [m, k] @ w (w [k, n]), or a @ w^T (wt: w [n, k]); the
// engine alone, for its test. n in (128, 256, 512), k in (128, ..., 1024).
extern "C" int ea_engine_product(const void* a, const void* w, void* out,
                                 int m, int k, int n, int wt, void* stream) {
  TestParams p;
  p.out = static_cast<float*>(out);
  p.m = m;
  p.k = k;
  if (k % 64 != 0 || k > 1024 || (k > 512 && k != 1024))
    return (int)cudaErrorInvalidValue;
  if (!ea::map_a(&p.a, a, m, k, k)) return (int)cudaErrorInvalidValue;
  const bool ok = wt ? ea::map_k(&p.w, w, n, k, n) : ea::map_mn(&p.w, w, k, n);
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n * 2 + (wt ? 1 : 0)) {
    case 256: return (int)launch_test<128 / ea::NWG, true>(p, st);
    case 257: return (int)launch_test<128 / ea::NWG, false>(p, st);
    case 512: return (int)launch_test<256 / ea::NWG, true>(p, st);
    case 513: return (int)launch_test<256 / ea::NWG, false>(p, st);
    case 1024: return (int)launch_test<512 / ea::NWG, true>(p, st);
    case 1025: return (int)launch_test<512 / ea::NWG, false>(p, st);
    default: return (int)cudaErrorInvalidValue;
  }
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
  p.wen0 = static_cast<const bf16*>(wen0);
  p.bias = static_cast<const float*>(bias);
  p.send = static_cast<const int*>(send);
  p.recv = static_cast<const int*>(recv);
  p.rlo = static_cast<const int*>(rlo);
  p.rhi = static_cast<const int*>(rhi);
  p.cnt = static_cast<const float*>(cnt);
  p.proj = static_cast<bf16*>(scratch);
  p.x1f = reinterpret_cast<float*>(static_cast<unsigned char*>(scratch) +
                                   proj_bytes(n, h));
  p.zx = static_cast<bf16*>(zx);
  p.ze = static_cast<bf16*>(ze);
  p.e1s = static_cast<bf16*>(e1s);
  p.m1s = static_cast<bf16*>(m1s);
  p.n = n;
  p.e = e;
  p.skip = skip;
  p.save_res = save_res;
  p.drop = {dropout, thr, s0, s1, scale};
  if (n % BM != 0) return (int)cudaErrorInvalidValue;
  const int c = ea::ENC_HID;
  bool ok = ea::map_a(&p.m.x, x, n, h, h) &&
            ea::map_mn(&p.m.wsp, wsp, h, 2 * h) &&
            ea::map_mn(&p.m.wer, wer, h, h) &&
            ea::map_mn(&p.m.wee, wee, h, h) &&
            ea::map_mn(&p.m.we1, we1, h, h) &&
            ea::map_mn(&p.m.wpe, wpe, h, h) &&
            ea::map_mn(&p.m.wp1, wp1, h, h) &&
            ea::map_mn(&p.m.wg0, wg0, 2 * h, h) &&
            ea::map_mn(&p.m.wg1, wg1, h, h) &&
            ea::map_mn(&p.m.wb0, wb0, h, h) &&
            ea::map_mn(&p.m.wb1, wb1, h, h);
  if (enc)
    ok = ok && ea::map_mn(&p.m.wen1, wen1, c, c) &&
         ea::map_mn(&p.m.wen2, wen2, c, h);
  else
    ok = ok && ea::map_a(&p.m.e_in, e_in, e, h, h);
  if (!ok) return (int)cudaErrorInvalidValue;
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
