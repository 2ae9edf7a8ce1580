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
// The int8 band is converted to bf16 in shared memory (counts <= 127 are
// exact). The star selection is the same one-hot product the TPU kernel
// runs: its 2*GW one-hot columns are appended to the band's K dimension,
// and the matching table rows (wb.. and T0+wb.., or the whole table when
// GW == T0) to the slab's rows, so it lands in the same f32 accumulator
// before the cast, as on the TPU. The spill term (the TPU's one-hot
// [T, 256] product with the tile's message window, pallas_sage_layer.py:
// 313-349) is the same f32 sum taken directly (sage_common.cuh::
// add_spill_run), which each row's warp adds to the staged accumulator,
// also before the cast.
//
// What bounds it on an H100: at the flagship shape (N = 103,424, T = 256,
// W = 64, H = 512) a layer does ~149 GFLOP of bf16 products against
// ~271 MB of compulsory traffic, so it is compute-bound (0.15 ms at the
// 989 TFLOP/s dense bf16 peak; 0.08 ms memory bound at 3.35 TB/s).
//
// Design, simple first: one block of 8 warps owns 64 rows across the full
// width H, so the row norm is a block-local reduction and agg never leaves
// shared memory. Products use wmma 16x16x16 bf16 fragments; each warp owns
// 64 rows x H/8 columns of the accumulator. The slab and weight operands
// are read as fragments straight from global memory (the weights, 1 MB,
// stay in L2); there is no TMA, wgmma or software pipelining yet, so the
// kernel is latency-bound well below the tensor-core peak. The cross-tile
// table sum (a sequential-grid accumulator on the TPU) becomes per-block
// f32 partials plus a second, deterministic reduction kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "sage_common.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 64;  // rows per block
constexpr int NWARP = 8;
constexpr int NTHREADS = NWARP * 32;

struct Params {
  const __nv_bfloat16* x;      // [N, H]
  const int8_t* band;          // [N, T+W] (tile t = rows t*T .. t*T+T)
  const __nv_bfloat16* w_l;    // [H, H] (in, out)
  const __nv_bfloat16* w_r;    // [H, H] (in, out)
  const __nv_bfloat16* b_l;    // [H]
  const __nv_bfloat16* table;  // [tg, H] star table (has_super)
  const int* code;             // [N] selector codes in [0, 2GW], 2GW = none
  const int* gwin;             // [n_tiles] window bases, or null (wb = 0)
  const int* acc_code;         // [N] accumulate codes (emit)
  const __nv_bfloat16* msgs;   // [Es, H] x at the spill senders (has_spill)
  const int* spill_off;        // [n_tiles + 1] spill offsets (has_spill)
  const int* spill_lo;         // [N] first window column of each row
  const int* spill_hi;         // [N] end window column of each row
  __nv_bfloat16* z;            // [N, H]
  float* partial;              // [N / BM, 2GW, H] (emit)
  __nv_bfloat16* y_out;        // [N, H] (save_res)
  float* inv_out;              // [N] (save_res)
  __nv_bfloat16* agg_out;      // [N, H] (save_res)
  int n, tile, width, gw, t0, has_super, skip, emit, save_res, dropout;
  int n_spill, has_spill;      // spill list rows, spill term on
  uint32_t thr, s0, s1;        // dropout threshold and seed words
  float scale;
  int region0;                 // bytes of the f32 / phase-1 shared region
};

template <int H>
__global__ void __launch_bounds__(NTHREADS, 1) sage_fwd_kernel(Params p) {
  constexpr int WN = H / NWARP;  // accumulator columns per warp
  constexpr int NF = WN / 16;    // column fragments per warp
  constexpr int MF = BM / 16;    // row fragments
  constexpr int LDF = H + 4;     // f32 staging stride (floats)
  constexpr int LDA = H + 8;     // bf16 agg / z stride (elements)
  extern __shared__ __align__(128) unsigned char smem[];
  float* sf = reinterpret_cast<float*>(smem);
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem);  // aliases sf
  __nv_bfloat16* sagg = reinterpret_cast<__nv_bfloat16*>(smem + p.region0);
  int* scode = reinterpret_cast<int*>(smem + p.region0 + BM * LDA * 2);
  int* sacc = scode + BM;

  const int S = p.tile + p.width;
  const int G2 = p.has_super ? 2 * p.gw : 0;
  const int K1 = S + G2;
  const int LD1 = K1 + 8;
  const int bpt = p.tile / BM;
  const int t = blockIdx.x / bpt;
  const int row0 = blockIdx.x * BM;  // == t*T + (blockIdx.x % bpt)*BM
  const int start = max(0, min(t * p.tile - p.width / 2, max(p.n - S, 0)));
  const int wb = p.gwin ? p.gwin[t] : 0;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int n0 = warp * WN;

  if (tid < BM) {
    scode[tid] = p.has_super ? p.code[row0 + tid] : 0;
    sacc[tid] = p.emit ? p.acc_code[row0 + tid] : 0;
  }
  // phase-1 A operand: [band rows (int8 -> bf16) | one-hot star selectors]
  const int8_t* band = p.band + (size_t)row0 * S;
  for (int i = tid; i < BM * S; i += NTHREADS) {
    const int r = i / S;
    const int k = i - r * S;
    sA[r * LD1 + k] = __float2bfloat16((float)band[i]);
  }
  __syncthreads();
  for (int i = tid; i < BM * G2; i += NTHREADS) {
    const int r = i / G2;
    const int c = i - r * G2;
    sA[r * LD1 + S + c] = __float2bfloat16(scode[r] == c ? 1.f : 0.f);
  }
  __syncthreads();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MF][NF];
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  // phase 1: acc = [band | sel] @ [x slab ; table window]
  for (int k0 = 0; k0 < K1; k0 += 16) {
    const __nv_bfloat16* brow;
    if (k0 < S) {
      brow = p.x + (size_t)(start + k0) * H;
    } else {
      const int r0 = k0 - S;
      const int trow = r0 < p.gw ? wb + r0 : p.t0 + wb + (r0 - p.gw);
      brow = p.table + (size_t)trow * H;
    }
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>
        a[MF];
#pragma unroll
    for (int i = 0; i < MF; ++i)
      wmma::load_matrix_sync(a[i], sA + i * 16 * LD1 + k0, LD1);
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> b;
      wmma::load_matrix_sync(b, brow + n0 + j * 16, H);
#pragma unroll
      for (int i = 0; i < MF; ++i) wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
    }
  }
  __syncthreads();  // every warp is done with sA before sf overwrites it
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j)
      wmma::store_matrix_sync(sf + i * 16 * LDF + n0 + j * 16, acc[i][j], LDF,
                              wmma::mem_row_major);
  __syncthreads();
  if (p.has_spill) {
    // spill term: each warp adds its rows' message runs
    constexpr int NQS = H / 64;
    const int ws = sage::spill_window_start(p.spill_off[t], p.n_spill);
    for (int rr = 0; rr < BM / NWARP; ++rr) {
      const int r = warp * (BM / NWARP) + rr;
      float v[NQS][2];
#pragma unroll
      for (int q = 0; q < NQS; ++q) {
        v[q][0] = sf[r * LDF + q * 64 + lane * 2];
        v[q][1] = sf[r * LDF + q * 64 + lane * 2 + 1];
      }
      sage::add_spill_run<H>(p.msgs, ws, p.spill_lo[row0 + r],
                             p.spill_hi[row0 + r], lane, v);
#pragma unroll
      for (int q = 0; q < NQS; ++q) {
        sf[r * LDF + q * 64 + lane * 2] = v[q][0];
        sf[r * LDF + q * 64 + lane * 2 + 1] = v[q][1];
      }
    }
    __syncthreads();
  }
  for (int i = tid; i < BM * H; i += NTHREADS) {
    const int r = i / H;
    const int c = i - r * H;
    const __nv_bfloat16 a = __float2bfloat16_rn(sf[r * LDF + c]);
    sagg[r * LDA + c] = a;
    if (p.save_res) p.agg_out[(size_t)(row0 + r) * H + c] = a;
  }
  __syncthreads();

  // phase 2: out = agg @ W_l + x_t @ W_r (bias in the epilogue)
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  for (int k0 = 0; k0 < H; k0 += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>
        a[MF];
#pragma unroll
    for (int i = 0; i < MF; ++i)
      wmma::load_matrix_sync(a[i], sagg + i * 16 * LDA + k0, LDA);
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> b;
      wmma::load_matrix_sync(b, p.w_l + (size_t)k0 * H + n0 + j * 16, H);
#pragma unroll
      for (int i = 0; i < MF; ++i) wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
    }
  }
  for (int k0 = 0; k0 < H; k0 += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>
        a[MF];
#pragma unroll
    for (int i = 0; i < MF; ++i)
      wmma::load_matrix_sync(a[i], p.x + (size_t)(row0 + i * 16) * H + k0, H);
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> b;
      wmma::load_matrix_sync(b, p.w_r + (size_t)k0 * H + n0 + j * 16, H);
#pragma unroll
      for (int i = 0; i < MF; ++i) wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j)
      wmma::store_matrix_sync(sf + i * 16 * LDF + n0 + j * 16, acc[i][j], LDF,
                              wmma::mem_row_major);
  __syncthreads();

  // epilogue: each warp owns BM/NWARP rows; a lane holds column pairs
  constexpr int NQ = H / 64;
  for (int rr = 0; rr < BM / NWARP; ++rr) {
    const int r = warp * (BM / NWARP) + rr;
    const size_t grow = (size_t)(row0 + r) * H;
    float v[NQ][2];
    float sq = 0.f;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int c = q * 64 + lane * 2;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float o = sf[r * LDF + c + e] + __bfloat162float(p.b_l[c + e]);
        v[q][e] = o;
        sq += o * o;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sq += __shfl_xor_sync(0xffffffffu, sq, off);
    const float inv = rsqrtf(fmaxf(sq, 1e-24f));
    if (p.save_res && lane == 0) p.inv_out[row0 + r] = inv;
    const uint32_t rk = sage::row_key(p.s0, (uint32_t)(row0 + r));
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int c = q * 64 + lane * 2;
      const float y0 = v[q][0] * inv;
      const float y1 = v[q][1] * inv;
      if (p.save_res)
        *reinterpret_cast<__nv_bfloat162*>(p.y_out + grow + c) =
            __floats2bfloat162_rn(y0, y1);
      float r0 = fmaxf(y0, 0.f);
      float r1 = fmaxf(y1, 0.f);
      if (p.skip) {
        const __nv_bfloat162 xs =
            *reinterpret_cast<const __nv_bfloat162*>(p.x + grow + c);
        r0 += __bfloat162float(xs.x);
        r1 += __bfloat162float(xs.y);
      }
      if (p.dropout) {
        r0 = sage::dropout_bits(rk, p.s1, c) < p.thr ? r0 * p.scale : 0.f;
        r1 = sage::dropout_bits(rk, p.s1, c + 1) < p.thr ? r1 * p.scale : 0.f;
      }
      const __nv_bfloat162 zz = __floats2bfloat162_rn(r0, r1);
      *reinterpret_cast<__nv_bfloat162*>(p.z + grow + c) = zz;
      *reinterpret_cast<__nv_bfloat162*>(sagg + r * LDA + c) = zz;
    }
  }

  if (!p.emit) return;
  __syncthreads();
  // next layer's star table: per-block partial sums of z by accumulate code
  const int g2 = 2 * p.gw;
  float* part = sf;  // [g2][H]
  float* dst = p.partial + (size_t)blockIdx.x * g2 * H;
  for (int c = tid; c < H; c += NTHREADS) {
    for (int s = 0; s < g2; ++s) part[s * H + c] = 0.f;
    for (int r = 0; r < BM; ++r) {
      const int code = sacc[r];
      if (code < g2) part[code * H + c] += __bfloat162float(sagg[r * LDA + c]);
    }
    for (int s = 0; s < g2; ++s) dst[s * H + c] = part[s * H + c];
  }
}

template <int H>
cudaError_t launch(Params p, int n_blocks, cudaStream_t stream) {
  const int S = p.tile + p.width;
  const int k1 = S + (p.has_super ? 2 * p.gw : 0);
  int region0 = BM * (H + 4) * 4;
  const int a_bytes = BM * (k1 + 8) * 2;
  if (a_bytes > region0) region0 = (a_bytes + 255) / 256 * 256;
  p.region0 = region0;
  const int smem = region0 + BM * (H + 8) * 2 + 2 * BM * 4;
  cudaError_t e = cudaFuncSetAttribute(
      sage_fwd_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  sage_fwd_kernel<H><<<n_blocks, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
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
  Params p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.band = static_cast<const int8_t*>(band);
  p.w_l = static_cast<const __nv_bfloat16*>(w_l);
  p.w_r = static_cast<const __nv_bfloat16*>(w_r);
  p.b_l = static_cast<const __nv_bfloat16*>(b_l);
  p.table = static_cast<const __nv_bfloat16*>(table);
  p.code = static_cast<const int*>(code);
  p.gwin = static_cast<const int*>(gwin);
  p.acc_code = static_cast<const int*>(acc_code);
  p.msgs = static_cast<const __nv_bfloat16*>(msgs);
  p.spill_off = static_cast<const int*>(spill_off);
  p.spill_lo = static_cast<const int*>(spill_lo);
  p.spill_hi = static_cast<const int*>(spill_hi);
  p.n_spill = n_spill;
  p.has_spill = has_spill;
  p.z = static_cast<__nv_bfloat16*>(z);
  p.partial = static_cast<float*>(partial);
  p.y_out = static_cast<__nv_bfloat16*>(y_out);
  p.inv_out = static_cast<float*>(inv_out);
  p.agg_out = static_cast<__nv_bfloat16*>(agg_out);
  p.save_res = save_res;
  p.dropout = dropout;
  p.thr = thr;
  p.s0 = s0;
  p.s1 = s1;
  p.scale = scale;
  p.n = n;
  p.tile = tile;
  p.width = width;
  p.gw = gw;
  p.t0 = t0;
  p.has_super = has_super;
  p.skip = skip;
  p.emit = emit;
  p.region0 = 0;
  const int n_blocks = n / BM;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (h) {
    case 128: e = launch<128>(p, n_blocks, st); break;
    case 256: e = launch<256>(p, n_blocks, st); break;
    case 512: e = launch<512>(p, n_blocks, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return (int)e;
  if (emit) {
    dim3 grid((h + 255) / 256, tg);
    sage::table_reduce_kernel<<<grid, 256, 0, st>>>(
        static_cast<const float*>(partial), p.gwin, static_cast<float*>(ftab),
        n / tile, tile / BM, gw, t0, h);
  }
  return (int)cudaGetLastError();
}
