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
//   2. band pass, one block per 64 rows: dx = dxp + band @ dagg slab,
//      banded.cuh::banded_kernel with its acc add (the banded SpMM's kernel);
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
// keeps dagg in VMEM. Products use wmma 16x16x16 bf16 fragments with f32
// accumulators; there is no TMA, wgmma or pipelining yet. The split tile
// kernel at the virtual-edge shape (the same N, T, W and H, no supernodes)
// does ~217 GFLOP (0.22 ms at 989 TFLOP/s) against ~0.64 GB of compulsory
// traffic (dz, y, agg, x read; dagg, dxp written: 0.19 ms at 3.35 TB/s),
// so it is bound by operations too; it also writes and reads dout.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "atb.cuh"
#include "banded.cuh"
#include "sage_common.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 64;  // rows per block of the tile pass
constexpr int NWARP = 8;
constexpr int NTHREADS = NWARP * 32;
using splitk::KSPLIT;  // row chunks of the weight pass

typedef __nv_bfloat16 bf16;

struct Params {
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
  int n, tile, width, gw, t0, apply_prev, has_super, skip, dropout;
  uint32_t thr, s0, s1;
  float scale;
};

// dz_eff of one element (before the relu mask)
template <int H>
__device__ __forceinline__ float dz_eff(const Params& p, size_t grow_h, int c,
                                        int trow, uint32_t rk) {
  float v = __bfloat162float(p.dz[grow_h + c]);
  if (trow >= 0) v += __bfloat162float(p.tprev[(size_t)trow * H + c]);
  if (p.dropout)
    v = sage::dropout_bits(rk, p.s1, c) < p.thr ? v * p.scale : 0.f;
  return v;
}

// the table row that a selector code picks in tile t's window, or -1
__device__ __forceinline__ int table_row(const Params& p, int code, int wb) {
  if (!p.apply_prev || code >= 2 * p.gw) return -1;
  return code < p.gw ? wb + code : p.t0 + wb + (code - p.gw);
}

// acc[64, H] = sA[64, H] (bf16, smem, row-major, lda) @ W^T, W [H, H]
// row-major in global memory, read as a column-major B fragment
template <int H>
__device__ __forceinline__ void product_wt(
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> (&acc)[BM / 16]
                                                             [H / NWARP / 16],
    const bf16* sA, int lda, const bf16* w, int n0) {
  constexpr int MF = BM / 16;
  constexpr int NF = H / NWARP / 16;
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  for (int k0 = 0; k0 < H; k0 += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[MF];
#pragma unroll
    for (int i = 0; i < MF; ++i)
      wmma::load_matrix_sync(a[i], sA + i * 16 * lda + k0, lda);
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      // B(k, n) = W[n, k]: column-major with leading dimension H
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::load_matrix_sync(b, w + (size_t)(n0 + j * 16) * H + k0, H);
#pragma unroll
      for (int i = 0; i < MF; ++i) wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
    }
  }
}

template <int H>
__device__ __forceinline__ void store_acc(
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> (&acc)[BM / 16]
                                                             [H / NWARP / 16],
    float* sf, int ldf, int n0) {
#pragma unroll
  for (int i = 0; i < BM / 16; ++i)
#pragma unroll
    for (int j = 0; j < H / NWARP / 16; ++j)
      wmma::store_matrix_sync(sf + i * 16 * ldf + n0 + j * 16, acc[i][j], ldf,
                              wmma::mem_row_major);
}

// ---- pass 1: per-row tile math ------------------------------------------
template <int H>
__global__ void __launch_bounds__(NTHREADS, 1) bwd_tile_kernel(Params p) {
  constexpr int WN = H / NWARP;
  constexpr int NF = WN / 16;
  constexpr int MF = BM / 16;
  constexpr int LDF = H + 4;  // f32 staging stride (floats)
  constexpr int LDA = H + 8;  // bf16 dout stride (elements)
  constexpr int NQ = H / 64;  // column pairs per lane
  constexpr int RPW = BM / NWARP;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sf = reinterpret_cast<float*>(smem);
  bf16* sd = reinterpret_cast<bf16*>(smem + BM * LDF * 4);
  int* strow = reinterpret_cast<int*>(smem + BM * LDF * 4 + BM * LDA * 2);
  int* sacc = strow + BM;

  const int bpt = p.tile / BM;
  const int t = blockIdx.x / bpt;
  const int row0 = blockIdx.x * BM;
  const int wb = p.gwin ? p.gwin[t] : 0;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int n0 = warp * WN;

  if (tid < BM) {
    strow[tid] = p.apply_prev ? table_row(p, p.code[row0 + tid], wb) : -1;
    sacc[tid] = p.has_super ? p.acc_code[row0 + tid] : 0;
  }
  __syncthreads();

  // dout, one warp per row: sf = f32 dout, sd and global dout = bf16(dout)
  for (int rr = 0; rr < RPW; ++rr) {
    const int r = warp * RPW + rr;
    const size_t gh = (size_t)(row0 + r) * H;
    const uint32_t rk = sage::row_key(p.s0, (uint32_t)(row0 + r));
    const int trow = strow[r];
    float dy[NQ][2], yv[NQ][2];
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int c = q * 64 + lane * 2;
      const __nv_bfloat162 y2 = *reinterpret_cast<const __nv_bfloat162*>(
          p.y + gh + c);
      yv[q][0] = __bfloat162float(y2.x);
      yv[q][1] = __bfloat162float(y2.y);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float d = dz_eff<H>(p, gh, c + e, trow, rk);
        dy[q][e] = yv[q][e] > 0.f ? d : 0.f;
        s += dy[q][e] * yv[q][e];
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    const float iv = p.inv[row0 + r];
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int c = q * 64 + lane * 2;
      const float o0 = (dy[q][0] - yv[q][0] * s) * iv;
      const float o1 = (dy[q][1] - yv[q][1] * s) * iv;
      sf[r * LDF + c] = o0;
      sf[r * LDF + c + 1] = o1;
      const __nv_bfloat162 oc = __floats2bfloat162_rn(o0, o1);
      *reinterpret_cast<__nv_bfloat162*>(sd + r * LDA + c) = oc;
      *reinterpret_cast<__nv_bfloat162*>(p.dout + gh + c) = oc;
    }
  }
  __syncthreads();
  // db_l partial: column sums of the f32 dout, in row order
  for (int c = tid; c < H; c += NTHREADS) {
    float s = 0.f;
    for (int r = 0; r < BM; ++r) s += sf[r * LDF + c];
    p.db_part[(size_t)blockIdx.x * H + c] = s;
  }
  __syncthreads();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MF][NF];
  // dxp = bf16(dout) @ W_r^T (+ dz_eff with the skip)
  product_wt<H>(acc, sd, LDA, p.w_r, n0);
  store_acc<H>(acc, sf, LDF, n0);
  __syncthreads();
  for (int rr = 0; rr < RPW; ++rr) {
    const int r = warp * RPW + rr;
    const size_t gh = (size_t)(row0 + r) * H;
    const uint32_t rk = sage::row_key(p.s0, (uint32_t)(row0 + r));
    const int trow = strow[r];
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int c = q * 64 + lane * 2;
      float v0 = sf[r * LDF + c];
      float v1 = sf[r * LDF + c + 1];
      if (p.skip) {
        v0 += dz_eff<H>(p, gh, c, trow, rk);
        v1 += dz_eff<H>(p, gh, c + 1, trow, rk);
      }
      *reinterpret_cast<__nv_bfloat162*>(p.dxp + gh + c) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
  __syncthreads();

  // dagg = bf16(bf16(dout) @ W_l^T); sf keeps the rounded values
  product_wt<H>(acc, sd, LDA, p.w_l, n0);
  store_acc<H>(acc, sf, LDF, n0);
  __syncthreads();
  for (int rr = 0; rr < RPW; ++rr) {
    const int r = warp * RPW + rr;
    const size_t gh = (size_t)(row0 + r) * H;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int c = q * 64 + lane * 2;
      const __nv_bfloat162 a2 =
          __floats2bfloat162_rn(sf[r * LDF + c], sf[r * LDF + c + 1]);
      *reinterpret_cast<__nv_bfloat162*>(p.dagg + gh + c) = a2;
      sf[r * LDF + c] = __bfloat162float(a2.x);
      sf[r * LDF + c + 1] = __bfloat162float(a2.y);
    }
  }
  if (!p.has_super) return;
  __syncthreads();
  // own star table partial: rows summed by accumulate code, in row order
  // (a run of equal codes is summed in a register, then added)
  const int g2 = 2 * p.gw;
  float* dst = p.t_part + (size_t)blockIdx.x * g2 * H;
  for (int c = tid; c < H; c += NTHREADS) {
    for (int s = 0; s < g2; ++s) dst[(size_t)s * H + c] = 0.f;
    float a = 0.f;
    int cur = g2;
    for (int r = 0; r < BM; ++r) {
      const int code = sacc[r];
      if (code != cur) {
        if (cur < g2) dst[(size_t)cur * H + c] += a;
        a = 0.f;
        cur = code;
      }
      if (code < g2) a += sf[r * LDF + c];
    }
    if (cur < g2) dst[(size_t)cur * H + c] += a;
  }
}

template <int H>
cudaError_t launch_tile(const Params& p, cudaStream_t st) {
  const int tile_smem = BM * (H + 4) * 4 + BM * (H + 8) * 2 + 2 * BM * 4;
  cudaError_t e = cudaFuncSetAttribute(
      bwd_tile_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      tile_smem);
  if (e != cudaSuccess) return e;
  bwd_tile_kernel<H><<<p.n / BM, NTHREADS, tile_smem, st>>>(p);
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
  sage::BandParams bp = {};  // pass 2: dx = bf16(band @ dagg slab + dxp)
  bp.x = p.dagg;
  bp.band = p.band;
  bp.acc = p.dxp;
  bp.out = p.dx;
  bp.n = p.n;
  bp.tile = p.tile;
  bp.width = p.width;
  bp.has_acc = 1;
  if ((e = sage::launch_banded<H>(bp, st)) != cudaSuccess) return e;
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
  Params p;
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
  p.dropout = dropout;
  p.thr = thr;
  p.s0 = s0;
  p.s1 = s1;
  p.scale = scale;
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
  p.dropout = dropout;
  p.thr = thr;
  p.s0 = s0;
  p.s1 = s1;
  p.scale = scale;
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
