// The float32 and any-width variants of the SAGE kernels for Hopper (sm_90a):
// the banded SpMM (#4), the fused layer's forward (#1), its merged backward
// (#2) and the split backward's tile kernel (#3), in float32 or bf16 at any
// H % 128 == 0, with f32 accumulation.
//
// Replace, for every (dtype, H) that the product engine does not take
// (ops/banded_matmul.py::kernel_variant: the engine takes bf16 at H in
// {128, 256, 512}), the TPU kernels
//   #4 buckgnn_tpu/ops/pallas_banded.py::_kernel (band_simple),
//   #1 buckgnn_tpu/ops/pallas_sage_layer.py::_fwd_kernel (sage_fwd_simple),
//   #2 buckgnn_tpu/ops/pallas_sage_layer.py::_bwd_merged_kernel
//      (sage_bwd_simple),
//   #3 buckgnn_tpu/ops/pallas_sage_layer.py::_bwd_kernel (sage_bwd_simple
//      without a band),
// which take any float x_dtype and any H % 128 == 0 with f32 accumulation
// (pallas_banded.py:84, 123-127; pallas_sage_layer.py:242, 604, 711). The
// engine kernels (sage_layer_fwd.cu, sage_layer_bwd.cu, banded_matmul.cu)
// stream bf16 x slabs and weights MN-major into wgmma, which takes tf32
// operands K-major only, so they cannot be templated to float32; these
// kernels take their products from wtile.cuh's weight tile instead, which
// takes float32 operands split into tf32 parts for 3xTF32 wgmma (float32
// accuracy).
//
// What each computes is what the engine kernel computes (their headers say
// it in full), with the same slab start s_t = clip(t*T - W/2, 0, N - (T+W)),
// spill window start (sage_common.cuh::spill_window_start), dropout words
// (sage_common.cuh::dropout_bits: keep when the word < thr, scale by
// `scale`, after relu and the skip) and star-table codes. Each TPU kernel
// becomes a few launches of four pieces:
//  - band_kernel: acc = band_t @ x[s_t : s_t+T+W] + the row's spill run
//    [lo, hi) of its message window + table[code] + acc_in, cast once to
//    the output type. A block a tile and 512 bytes of columns (256 for
//    bf16 and where the slab does not fit): the slab comes into shared
//    memory once by bulk copies, a row a thread, then a warp a row, a lane
//    on 4 (2) columns, finds the row's nonzero band counts by
//    ballot and adds count * x[s_t + k] for those alone (the int8 counts
//    are exact in either type), so it does the data's multiply-adds, not
//    the dense [T, T+W] product. Sums run in the plain version's order of
//    terms: band (ascending k, fmaf), spill, table, acc. #4 alone; #1's
//    phase 1 (agg = x_dtype(acc)); #2's band pass (dx = x_dtype(band @
//    dagg slab + dxp)).
//  - the products, on the tensor cores in 3xTF32 (bf16 operands in one
//    tf32 pass), 128 x 128 tiles of C on wtile.cuh's weight tile, B
//    pre-split once a call into the wrapper's scratch (``wsplit``), A and
//    B's parts by TMA, A's fragments from registers: #1's out = agg @ W_l
//    + x @ W_r + b_l (f32) from [W_l; W_r]; the backward's dagg | dxp =
//    dout @ [W_l^T | W_r^T] (+ dz_eff on dxp) in one launch, from W's rows
//    (`DaggDxp` stores C's halves); its weight pass [dW_l; dW_r] = [agg |
//    x]^T @ dout, A read transposed, from dout pre-split over its rows, in
//    row chunks whose f32 partials (`DwParts`) sum_parts adds in chunk
//    order.
//  - row passes, one warp per row, looping over the row's columns, so any
//    H fits: #1's epilogue (sum of squares, inv, y, relu, skip, dropout,
//    z) and the backward's norm backward (dz_eff with the next layer's
//    star and the dropout mask, dy, s = rowsum(dy * y), dout). The row-wide
//    norm is split from the products because a row of H = 1024 f32 sums
//    does not fit one block's registers beside a product tile.
//  - code sums: per 64-row block, the sums of a [N, H] tensor's rows by
//    code (each code's rows in row order), the partials that
//    sage_common.cuh::table_reduce_kernel adds in block order:
//    code_sums_once_kernel, one pass over the block's rows into per-code
//    sums in shared memory, for #1's emitted table (of z), #2's own table
//    (of dagg) and #3's (of dagg, global codes) where its codes' sums fit
//    shared memory; else code_sums_kernel, a pass over the rows for each
//    code (the same adds in the same order: the same bits). colsum_* adds
//    db = colsum(dout) the same way, in two fixed-order passes.
// No float atomics: two runs give the same bits.
//
// What bounds them on an H100: at the flagship shape (N = 103,424, H = 512,
// T + W = 320) #1 is 4 N H^2 = 108 GFLOP of f32 products, 3 tf32 products
// each (0.66 ms at the 495 TFLOP/s TF32 rate) beside the band's few
// nonzeros a row, and the backward twice that, so they are bound by
// operations; the band kernel alone is bound by bytes (x, the band, acc and
// out), the code sums by z's bytes and the partials', dout's pre-split by
// its 0.6 GB. The row passes, the band, the pre-splits and the code sums
// are separate launches that read and write device memory (PERF.md has the
// times).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wtile.cuh"

namespace simple {

// the table row that a row's code selects, or -1: with window bases
// (``gwin``) codes [0, gw) select rows wb.., [gw, 2gw) rows t0 + wb..;
// without, the code is the row and tg selects nothing
__device__ __forceinline__ int table_row(int code, const int* gwin, int t,
                                         int gw, int t0, int tg) {
  if (gwin == nullptr) return (code >= 0 && code < tg) ? code : -1;
  const int wb = gwin[t];
  if (code >= 0 && code < gw) return wb + code;
  if (code >= gw && code < 2 * gw) return t0 + wb + code - gw;
  return -1;
}

// ---- the band product (#4) ----------------------------------------------

constexpr int BAND_WARPS = 16;        // a block's warps: rows w, w + 16, ..
constexpr int SLAB_BYTES = 229376;    // the slab's shared memory, at most
constexpr int SPAN_GROUPS = 10;       // 32-depth count groups read at once
constexpr int NZ = 2;                 // nonzeros whose loads go out together

struct BandP {
  const void* x;       // [N, H]
  const int8_t* band;  // [N, T+W]
  const void* msgs;    // [Es, H] spill messages, or null
  const int* off;      // [N/T + 1] spill offsets
  const int* lo;       // [N] first window column of each row
  const int* hi;       // [N] end window column of each row
  const int* code;     // [N] table codes, or null
  const int* gwin;     // [N/T] window bases, or null (code = table row)
  const void* table;   // [tg, H]
  const void* acc;     // [N, H] added last, or null
  void* out;           // [N, H]
  int n, h, tile, width, n_spill, tg, gw, t0;
};

// C neighbouring values as f32, 8 or 16 bytes of them (C = 2 or 4
// float32, 4 or 8 bf16)
template <int C>
__device__ __forceinline__ void ldv(const float* p, float (&o)[C]) {
  if constexpr (C == 2) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p));
    o[0] = v.x; o[1] = v.y;
  } else {
    ld4(p, o);
  }
}
template <int C>
__device__ __forceinline__ void ldv(const bf16* p, float (&o)[C]) {
  if constexpr (C == 4) {
    ld4(p, o);
  } else {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[2 * i] = bf_lo(w[i]);
      o[2 * i + 1] = bf_hi(w[i]);
    }
  }
}
template <typename T, int C>
__device__ __forceinline__ void ldsv(const unsigned char* s, float (&o)[C]) {
  if constexpr (C * sizeof(T) == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(s);
    if constexpr (sizeof(T) == 4) {
      o[0] = __uint_as_float(v.x); o[1] = __uint_as_float(v.y);
    } else {
      o[0] = bf_lo(v.x); o[1] = bf_hi(v.x); o[2] = bf_lo(v.y);
      o[3] = bf_hi(v.y);
    }
  } else {
    const uint4 v = *reinterpret_cast<const uint4*>(s);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (sizeof(T) == 4) {
        o[i] = __uint_as_float(w[i]);
      } else {
        o[2 * i] = bf_lo(w[i]);
        o[2 * i + 1] = bf_hi(w[i]);
      }
    }
  }
}
template <int C>
__device__ __forceinline__ void stv(float* p, const float (&v)[C]) {
  if constexpr (C == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int i = 0; i < C; i += 4)
      st4(p + i, {v[i], v[i + 1], v[i + 2], v[i + 3]});
  }
}
template <int C>
__device__ __forceinline__ void stv(bf16* p, const float (&v)[C]) {
  if constexpr (C == 2) {
    *reinterpret_cast<uint32_t*>(p) = pack2(v[0], v[1]);
  } else {
#pragma unroll
    for (int i = 0; i < C; i += 4)
      st4(p + i, {v[i], v[i + 1], v[i + 2], v[i + 3]});
  }
}

// Block (tile t, chunk of ROWB bytes of columns): the slab x[s_t : s_t +
// T + W, chunk] comes into shared memory by 1-D bulk copies (a row a
// thread), then warp w runs the tile's rows w, w + 16, ..., a lane on C
// = ROWB / 32 / sizeof(T) neighbouring columns, reading x from the slab.
// A row's int8 counts (SPAN_GROUPS groups of 32), code and spill range are
// loaded while the warp's previous row runs, its table row and acc as it
// starts: a warp keeps the next row's loads in flight behind this row's
// products. The warp finds the row's nonzero counts by ballot and adds
// count * x for those alone, NZ of them at a time (their shuffles and
// slab reads go out together, their FMAs follow in order), in ascending
// depth, fmaf(cnt, x, acc); then the row's spill run on its own (message
// order), the table row and acc. Every element's terms come in that one
// order whatever the chunking (the card tests' `_band_exact` holds it bit
// for bit). The per-row work is paid once a chunk, so chunks are as wide
// as the slab lets them be (launch_band). A slab of more than SLAB_BYTES / ROWB rows
// is streamed in pieces of that many, the block's rows 16 at a time (a
// row a warp) over every piece. No float atomics.
template <typename T, typename O, int ROWB>
__global__ void __launch_bounds__(BAND_WARPS * 32, 1) band_kernel(BandP p) {
  constexpr int C = ROWB / 32 / (int)sizeof(T);  // a lane's columns
  constexpr int CW = 32 * C;                      // a block's columns
  constexpr int SPAN = 32 * SPAN_GROUPS;
  extern __shared__ __align__(128) unsigned char slab[];  // [rows, ROWB]
  __shared__ uint64_t full;
  const int nch = p.h / CW;
  const int t = blockIdx.x / nch, c0 = blockIdx.x % nch * CW;
  const int s_len = p.tile + p.width;
  const int hi_start = p.n - s_len > 0 ? p.n - s_len : 0;
  const int start = min(max(t * p.tile - p.width / 2, 0), hi_start);
  const int piece = min(s_len, SLAB_BYTES / ROWB);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col = c0 + lane * C;
  const T* x = static_cast<const T*>(p.x);
  if (threadIdx.x == 0) {
    hop::mbar_init(&full, 1);
    hop::fence_barrier_init();
    if (s_len <= piece) hop::mbar_expect_tx(&full, s_len * ROWB);
  }
  __syncthreads();
  // slab rows [k0, k0 + piece) into the slab, by warp 0
  auto load = [&](int k0) {
    const int rows = min(piece, s_len - k0);
    if (lane == 0) hop::mbar_expect_tx(&full, rows * ROWB);
    __syncwarp();
    for (int r = lane; r < rows; r += 32)
      hop::bulk_load(slab + r * ROWB, x + (size_t)(start + k0 + r) * p.h + c0,
                     ROWB, &full);
  };
  // row r's counts at depths k_lo + 32 g + lane, zeros from k_hi
  auto fetch = [&](int r, int k_lo, int k_hi, int (&v)[SPAN_GROUPS]) {
    const int8_t* brow = p.band + (size_t)r * s_len;
#pragma unroll
    for (int g = 0; g < SPAN_GROUPS; ++g) {
      const int k = k_lo + 32 * g + lane;
      v[g] = k < k_hi ? (int)__ldg(brow + k) : 0;
    }
  };
  // row r's code and spill run
  auto meta = [&](int r, int& code, int& mlo, int& mhi) {
    code = p.code ? __ldg(p.code + r) : -1;
    mlo = mhi = 0;
    if (p.msgs) {
      mlo = __ldg(p.lo + r);
      mhi = __ldg(p.hi + r);
    }
  };
  // acc += count * x over v's nonzeros, ascending; the slab holds depths
  // from ``base``
  auto apply = [&](int k_lo, int base, const int (&v)[SPAN_GROUPS],
                   float (&acc)[C]) {
#pragma unroll
    for (int g = 0; g < SPAN_GROUPS; ++g) {
      unsigned m = __ballot_sync(0xFFFFFFFFu, v[g] != 0);
      const unsigned char* xs = slab + (k_lo - base + 32 * g) * ROWB +
                                lane * C * (int)sizeof(T);
      while (m) {
        int j[NZ];
        bool on[NZ];
#pragma unroll
        for (int u = 0; u < NZ; ++u) {
          on[u] = m != 0;
          j[u] = on[u] ? __ffs(m) - 1 : 0;
          m &= m - 1;
        }
        float cnt[NZ], xv[NZ][C];
#pragma unroll
        for (int u = 0; u < NZ; ++u) {
          cnt[u] = (float)__shfl_sync(0xFFFFFFFFu, v[g], j[u]);
          ldsv<T, C>(xs + j[u] * ROWB, xv[u]);
        }
#pragma unroll
        for (int u = 0; u < NZ; ++u)
          if (on[u]) {
#pragma unroll
            for (int i = 0; i < C; ++i)
              acc[i] = fmaf(cnt[u], xv[u][i], acc[i]);
          }
      }
    }
  };
  const int ws = p.msgs ? sage::spill_window_start(p.off[t], p.n_spill) : 0;
  auto trow_of = [&](int code) {
    return table_row(code, p.gwin, t, p.gw, p.t0, p.tg);
  };
  // row r's table row and acc, loaded before its products
  auto terms = [&](int r, int trow, float (&tv)[C], float (&av)[C]) {
    if (trow >= 0)
      ldv<C>(static_cast<const T*>(p.table) + (size_t)trow * p.h + col, tv);
    if (p.acc) ldv<C>(static_cast<const T*>(p.acc) + (size_t)r * p.h + col,
                      av);
  };
  // row r's band sum ``acc`` + its spill run + its table row + acc_in, out
  auto finish = [&](int r, int mlo, int mhi, int trow, const float (&tv)[C],
                    const float (&av)[C], float (&acc)[C]) {
    if (mhi > mlo) {
      // the row's spill run, summed on its own in message order
      const T* msgs = static_cast<const T*>(p.msgs);
      float sp[C];
#pragma unroll
      for (int i = 0; i < C; ++i) sp[i] = 0.f;
      for (int mm = mlo; mm < mhi; ++mm) {
        float mv[C];
        ldv<C>(msgs + (size_t)(ws + mm) * p.h + col, mv);
#pragma unroll
        for (int i = 0; i < C; ++i) sp[i] += mv[i];
      }
#pragma unroll
      for (int i = 0; i < C; ++i) acc[i] += sp[i];
    }
    if (trow >= 0) {
#pragma unroll
      for (int i = 0; i < C; ++i) acc[i] += tv[i];
    }
    if (p.acc) {
#pragma unroll
      for (int i = 0; i < C; ++i) acc[i] += av[i];
    }
    stv<C>(static_cast<O*>(p.out) + (size_t)r * p.h + col, acc);
  };
  const int r0 = t * p.tile;
  int v[SPAN_GROUPS];
  int code = -1, mlo = 0, mhi = 0;
  if (s_len <= piece) {
    // the whole slab at once, a row a thread; then each warp's rows, the
    // next row's counts, code and spill run in flight while this one's
    // products run
    for (int r = threadIdx.x; r < s_len; r += BAND_WARPS * 32)
      hop::bulk_load(slab + r * ROWB, x + (size_t)(start + r) * p.h + c0,
                     ROWB, &full);
    if (warp < p.tile) {
      fetch(r0 + warp, 0, min(s_len, SPAN), v);
      meta(r0 + warp, code, mlo, mhi);
    }
    hop::mbar_wait(&full, 0);
    for (int i = warp; i < p.tile; i += BAND_WARPS) {
      const int r = r0 + i;
      const int trow = trow_of(code), rlo = mlo, rhi = mhi;
      float tv[C], av[C], acc[C];
      terms(r, trow, tv, av);
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] = 0.f;
      const bool next = i + BAND_WARPS < p.tile;
      if (next) meta(r + BAND_WARPS, code, mlo, mhi);
      if (s_len <= SPAN) {
        int vn[SPAN_GROUPS];
        if (next) fetch(r + BAND_WARPS, 0, s_len, vn);
        apply(0, 0, v, acc);
#pragma unroll
        for (int g = 0; g < SPAN_GROUPS; ++g) v[g] = vn[g];
      } else {
        for (int k_lo = 0; k_lo < s_len; k_lo += SPAN) {
          if (k_lo > 0) fetch(r, k_lo, s_len, v);
          apply(k_lo, 0, v, acc);
        }
        if (next) fetch(r + BAND_WARPS, 0, SPAN, v);
      }
      finish(r, rlo, rhi, trow, tv, av, acc);
    }
    return;
  }
  // pieces: the block's rows a warp each, over every piece of the slab
  uint32_t phase = 0;
  for (int i0 = 0; i0 < p.tile; i0 += BAND_WARPS) {
    const int i = i0 + warp, r = r0 + i;
    float tv[C], av[C], acc[C];
    int trow = -1;
    if (i < p.tile) {
      meta(r, code, mlo, mhi);
      trow = trow_of(code);
      terms(r, trow, tv, av);
    }
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.f;
    for (int kp = 0; kp < s_len; kp += piece) {
      __syncthreads();  // every warp is done with the last piece
      if (warp == 0) load(kp);
      hop::mbar_wait(&full, phase);
      phase ^= 1;
      if (i < p.tile) {
        const int ke = min(s_len, kp + piece);
        for (int k_lo = kp; k_lo < ke; k_lo += SPAN) {
          fetch(r, k_lo, ke, v);
          apply(k_lo, kp, v, acc);
        }
      }
    }
    if (i < p.tile) finish(r, mlo, mhi, trow, tv, av, acc);
  }
}

template <typename T, typename O, int ROWB>
cudaError_t launch_band_rows(const BandP& p, cudaStream_t st) {
  const int s_len = p.tile + p.width;
  const int rows = SLAB_BYTES / ROWB;
  const int bytes = (s_len < rows ? s_len : rows) * ROWB;
  auto kernel = band_kernel<T, O, ROWB>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  const int nch = p.h * (int)sizeof(T) / ROWB;
  kernel<<<p.n / p.tile * nch, BAND_WARPS * 32, bytes, st>>>(p);
  return cudaGetLastError();
}

// chunks of 512 bytes of float32 columns (128) where the whole slab fits,
// else, and for bf16, of 256 bytes (64 float32 or 128 bf16 columns): the
// per-row work is paid once a chunk, and H % 128 == 0 makes them whole
template <typename T, typename O>
cudaError_t launch_band(const BandP& p, cudaStream_t st) {
  if constexpr (sizeof(T) == 4) {
    if ((p.tile + p.width) * 512 <= SLAB_BYTES)
      return launch_band_rows<T, O, 512>(p, st);
  }
  return launch_band_rows<T, O, 256>(p, st);
}

cudaError_t band(const BandP& p, bool bf, bool out_f32, cudaStream_t st) {
  if (bf) {
    return out_f32 ? launch_band<bf16, float>(p, st)
                   : launch_band<bf16, bf16>(p, st);
  }
  return out_f32 ? launch_band<float, float>(p, st)
                 : launch_band<float, bf16>(p, st);
}

// ---- row passes ---------------------------------------------------------

// #1's epilogue on out = agg @ W_l + x @ W_r + b_l (f32): y = out * inv,
// inv = rsqrt(max(sum(out^2), 1e-24)), z = T(dropout(relu(y) (+ x))), and
// with save_res y in T and inv
template <typename T>
__global__ void __launch_bounds__(ROW_WARPS * 32) fwd_rows_kernel(
    const float* out, const T* x, T* z, T* y_out, float* inv_out, int n,
    int h, int skip, Drop d) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * ROW_WARPS + (threadIdx.x >> 5);
  if (r >= n) return;
  const float* o = out + (size_t)r * h;
  float ss = 0.f;
  for (int c = lane * 4; c < h; c += 128) {
    float v[4];
    ld4c(o + c, v);
#pragma unroll
    for (int i = 0; i < 4; ++i) ss = fmaf(v[i], v[i], ss);
  }
  ss = warp_sum(ss);
  const float inv = rsqrtf(fmaxf(ss, 1e-24f));
  const uint32_t rk = sage::row_key(d.s0, (uint32_t)r);
  for (int c = lane * 4; c < h; c += 128) {
    float v[4], yv[4], zv[4];
    ld4c(o + c, v);
    float xv[4] = {0.f, 0.f, 0.f, 0.f};
    if (skip) ld4(x + (size_t)r * h + c, xv);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      yv[i] = v[i] * inv;
      float q = yv[i] > 0.f ? yv[i] : 0.f;
      if (skip) q += xv[i];
      if (d.on) {
        q = sage::dropout_bits(rk, d.s1, (uint32_t)(c + i)) < d.thr
                ? q * d.scale : 0.f;
      }
      zv[i] = q;
    }
    st4(z + (size_t)r * h + c, zv);
    if (y_out) st4(y_out + (size_t)r * h + c, yv);
  }
  if (inv_out && lane == 0) inv_out[r] = inv;
}

// the backward's norm backward: dz_eff = dropout(dz (+ table_prev[code])),
// dy = dz_eff where y > 0, dout = (dy - y * rowsum(dy * y)) * inv; writes
// dout in T, in f32 (dout32, for db, when T is not f32) and dz_eff (skip)
template <typename T>
__global__ void __launch_bounds__(ROW_WARPS * 32) bwd_rows_kernel(
    const T* dz, const T* y, const float* inv, const T* table_prev,
    const int* code, const int* gwin, int tile, int gw, int t0, int tg,
    T* dout, float* dout32, float* dzeff, int n, int h, Drop d) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * ROW_WARPS + (threadIdx.x >> 5);
  if (r >= n) return;
  const int trow =
      table_prev ? table_row(code[r], gwin, r / tile, gw, t0, tg) : -1;
  const uint32_t rk = sage::row_key(d.s0, (uint32_t)r);
  auto dz_eff = [&](int c, float (&e)[4]) {
    ld4(dz + (size_t)r * h + c, e);
    if (trow >= 0) {
      float tv[4];
      ld4(table_prev + (size_t)trow * h + c, tv);
#pragma unroll
      for (int i = 0; i < 4; ++i) e[i] += tv[i];
    }
    if (d.on) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        e[i] = sage::dropout_bits(rk, d.s1, (uint32_t)(c + i)) < d.thr
                   ? e[i] * d.scale : 0.f;
    }
  };
  float s = 0.f;
  for (int c = lane * 4; c < h; c += 128) {
    float e[4], yv[4];
    dz_eff(c, e);
    ld4(y + (size_t)r * h + c, yv);
#pragma unroll
    for (int i = 0; i < 4; ++i) s = fmaf(yv[i] > 0.f ? e[i] : 0.f, yv[i], s);
  }
  s = warp_sum(s);
  const float iv = inv[r];
  for (int c = lane * 4; c < h; c += 128) {
    float e[4], yv[4], o[4];
    dz_eff(c, e);
    ld4(y + (size_t)r * h + c, yv);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float dy = yv[i] > 0.f ? e[i] : 0.f;
      o[i] = (dy - yv[i] * s) * iv;
    }
    st4(dout + (size_t)r * h + c, o);
    if (dout32) st4(dout32 + (size_t)r * h + c, o);
    if (dzeff) st4(dzeff + (size_t)r * h + c, e);
  }
}

// ---- sums by code and by column -----------------------------------------

constexpr int CB = 64;  // rows of a code-sum block (table_reduce's blocks)

// part[b, c, col] = sum over rows r of block b with codes[r] == c of v[r,
// col], in row order, for c in [0, ncode)
template <typename T>
__global__ void __launch_bounds__(128) code_sums_kernel(
    const T* v, const int* codes, float* part, int ncode, int h) {
  __shared__ int sc[CB];
  const int b = blockIdx.x;
  const int col = blockIdx.y * 128 + threadIdx.x;
  if (threadIdx.x < CB) sc[threadIdx.x] = codes[b * CB + threadIdx.x];
  __syncthreads();
  float* out = part + (size_t)b * ncode * h + col;
  const T* vb = v + (size_t)b * CB * h + col;
  for (int c = 0; c < ncode; ++c) {
    float s = 0.f;
    for (int r = 0; r < CB; ++r) {
      if (sc[r] == c) s += to_f(vb[(size_t)r * h]);
    }
    out[(size_t)c * h] = s;
  }
}

// the same partials in one pass over the block's rows (#1's emitted table):
// each row added into its code's sum in shared memory, so each code's rows
// are still summed in row order from zero, the same adds as
// code_sums_kernel's; ncode * 128 floats of shared memory
template <typename T>
__global__ void __launch_bounds__(128) code_sums_once_kernel(
    const T* v, const int* codes, float* part, int ncode, int h) {
  extern __shared__ float sums[];  // [ncode, 128]
  __shared__ int sc[CB];
  const int b = blockIdx.x;
  const int col = blockIdx.y * 128 + threadIdx.x;
  if (threadIdx.x < CB) sc[threadIdx.x] = codes[b * CB + threadIdx.x];
  for (int c = 0; c < ncode; ++c) sums[c * 128 + threadIdx.x] = 0.f;
  __syncthreads();
  const T* vb = v + (size_t)b * CB * h + col;
#pragma unroll 8
  for (int r = 0; r < CB; ++r) {
    const float x = to_f(__ldg(vb + (size_t)r * h));
    const int c = sc[r];
    if (c >= 0 && c < ncode) sums[c * 128 + threadIdx.x] += x;
  }
  float* out = part + (size_t)b * ncode * h + col;
  for (int c = 0; c < ncode; ++c)
    out[(size_t)c * h] = sums[c * 128 + threadIdx.x];
}

template <typename T>
cudaError_t code_sums_once(const T* v, const int* codes, float* part,
                           int ncode, int n, int h, cudaStream_t st) {
  const int bytes = ncode * 128 * 4;
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        code_sums_once_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return e;
  }
  code_sums_once_kernel<T><<<dim3(n / CB, h / 128), 128, bytes, st>>>(
      v, codes, part, ncode, h);
  return cudaGetLastError();
}

// table_reduce's fixed order over the tiles whose window holds each table
// row, from the partials by block
cudaError_t table_reduce(const float* part, const int* gwin, float* table,
                         int n, int h, int tile, int gw, int t0, int tg,
                         cudaStream_t st) {
  dim3 grid((h + 255) / 256, tg);
  sage::table_reduce_kernel<<<grid, 256, 0, st>>>(part, gwin, table,
                                                  n / tile, tile / CB, gw,
                                                  t0, h);
  return cudaGetLastError();
}

// the most codes whose sums code_sums_once keeps in shared memory (ncode
// * 128 floats beside the block's codes, within a block's 227 KB)
constexpr int ONCE_CODES = (232448 - CB * 4) / (128 * 4);

// the table of a code sum: partials by block (in one pass over each
// block's rows where the codes' sums fit shared memory, which #2's 2 GW
// window codes always do; else a pass a code: the same adds in the same
// order), then table_reduce's fixed order over the tiles whose window holds
// each table row
template <typename T>
cudaError_t table_sum(const T* v, const int* codes, const int* gwin,
                      float* part, float* table, int n, int h, int tile,
                      int gw, int t0, int tg, int ncode, cudaStream_t st) {
  cudaError_t e;
  if (ncode <= ONCE_CODES) {
    e = code_sums_once<T>(v, codes, part, ncode, n, h, st);
  } else {
    code_sums_kernel<T><<<dim3(n / CB, h / 128), 128, 0, st>>>(v, codes,
                                                               part, ncode, h);
    e = cudaGetLastError();
  }
  if (e != cudaSuccess) return e;
  return table_reduce(part, gwin, table, n, h, tile, gw, t0, tg, st);
}

constexpr int COL_ROWS = 256;  // rows of a column-sum chunk

__global__ void colsum_part_kernel(const float* v, float* part, int n,
                                   int h) {
  const int col = blockIdx.y * 128 + threadIdx.x;
  const int r0 = blockIdx.x * COL_ROWS;
  const int r1 = min(n, r0 + COL_ROWS);
  float s = 0.f;
  for (int r = r0; r < r1; ++r) s += v[(size_t)r * h + col];
  part[(size_t)blockIdx.x * h + col] = s;
}

// db [H] = sum over rows of v [N, H] f32: chunk sums, then in chunk order
cudaError_t colsum(const float* v, float* part, float* out, int n, int h,
                   cudaStream_t st) {
  const int nc = (n + COL_ROWS - 1) / COL_ROWS;
  colsum_part_kernel<<<dim3(nc, h / 128), 128, 0, st>>>(v, part, n, h);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  sum_parts_kernel<void><<<(h + 255) / 256, 256, 0, st>>>(part, out, nc,
                                                    (size_t)h);
  return cudaGetLastError();
}

// ---- the layer ----------------------------------------------------------

struct FwdArgs {
  const void *x, *w_l, *w_r, *b_l, *table, *msgs;
  const int8_t* band;
  const int *code, *gwin, *acc_code, *off, *lo, *hi;
  void *agg, *z, *y, *ftab;
  float *out32, *inv, *partial, *wsplit;
  int n, h, tile, width, gw, t0, tg, n_spill, has_super, has_spill, skip,
      emit;
  Drop d;
};

template <typename T>
cudaError_t fwd(const FwdArgs& a, cudaStream_t st) {
  BandP p = {};
  p.x = a.x;
  p.band = a.band;
  if (a.has_spill) {
    p.msgs = a.msgs;
    p.off = a.off;
    p.lo = a.lo;
    p.hi = a.hi;
  }
  if (a.has_super) {
    p.code = a.code;
    p.gwin = a.gwin;
    p.table = a.table;
  }
  p.out = a.agg;
  p.n = a.n;
  p.h = a.h;
  p.tile = a.tile;
  p.width = a.width;
  p.n_spill = a.n_spill;
  p.tg = a.tg;
  p.gw = a.gw;
  p.t0 = a.t0;
  cudaError_t e = launch_band<T, T>(p, st);
  if (e != cudaSuccess) return e;
  // [W_l; W_r] pre-split, then out = agg @ W_l + x @ W_r + b_l on the weight
  // tile
  WJobs js = {};
  add_wjob<T>(&js, static_cast<const T*>(a.w_l), a.h, a.h,
              static_cast<const T*>(a.w_r), a.h, a.h, a.h, a.wsplit);
  e = wsplit<T>(js, st);
  if (e != cudaSuccess) return e;
  Gemm g = {};
  g.a0 = a.agg;
  g.a1 = a.x;
  g.lda0 = g.lda1 = a.h;
  g.k0 = g.k1 = a.h;
  g.m = a.n;
  g.n = a.h;
  g.bias = a.b_l;
  g.c = a.out32;
  g.ldc = a.h;
  g.c_f32 = 1;
  e = wgemm<T>(g, a.wsplit, st);
  if (e != cudaSuccess) return e;
  fwd_rows_kernel<T><<<(a.n + ROW_WARPS - 1) / ROW_WARPS, ROW_WARPS * 32, 0,
                       st>>>(a.out32, static_cast<const T*>(a.x),
                             static_cast<T*>(a.z), static_cast<T*>(a.y),
                             a.inv, a.n, a.h, a.skip, a.d);
  e = cudaGetLastError();
  if (e != cudaSuccess || !a.emit) return e;
  // the emitted table of z: the code sums in one pass over each block
  e = code_sums_once<T>(static_cast<const T*>(a.z), a.acc_code, a.partial,
                        2 * a.gw, a.n, a.h, st);
  if (e != cudaSuccess) return e;
  return table_reduce(a.partial, a.gwin, static_cast<float*>(a.ftab), a.n,
                      a.h, a.tile, a.gw, a.t0, a.tg, st);
}

struct BwdArgs {
  const void *dz, *y, *agg, *x, *w_l, *w_r, *table_prev;
  const float* inv;
  const int8_t* band;  // merged: the band pass; null: the tile kernel
  const int *code, *gwin, *acc_code;
  void *dout, *dagg, *dxp, *dx;
  float *dout32, *dzeff, *dw_part, *dwl, *dwr, *db_part, *dbl, *t_part,
      *town, *wsplit, *dsplit;
  int n, h, tile, width, gw, t0, tg, has_super, skip, ksplit;
  Drop d;
};

// dagg | dxp = dout @ [W_l^T | W_r^T]: C's columns [0, H) stored to g.c
// (dagg), the rest to dxp at column - H with the add (dz_eff under the
// skip), both in T
struct DaggDxp {
  void* dxp;
  const float* add;
  int h;
  template <typename T>
  __device__ __forceinline__ void operator()(const Gemm& g,
                                             const Rows& f) const {
    Gemm gs = g;
    Rows fs = f;
    if (f.n0 >= h) {
      gs.c = dxp;
      gs.add = add;
      fs.n0 -= h;
    }
    Store<>{}.template operator()<T>(gs, fs);
  }
};

// [dW_l; dW_r]'s chunk partials: C's rows [0, H) to dW_l's partials at g.c,
// the rest to dW_r's, ``hstride`` floats further, at row - H
struct DwParts {
  size_t hstride;
  int h;
  template <typename T>
  __device__ __forceinline__ void operator()(const Gemm& g,
                                             const Rows& f) const {
    Gemm gs = g;
    Rows fs = f;
    if (f.base >= h) {
      gs.c = static_cast<float*>(g.c) + hstride;
      fs.base -= h;
    }
    Store<>{}.template operator()<T>(gs, fs);
  }
};

// the weight pass's chunk of rows for ``ksplit`` chunks: whole 64-row
// blocks
inline int wpass_chunk(int n, int ksplit) {
  const int kchunk = (n + ksplit - 1) / ksplit;
  return (kchunk + HALF - 1) / HALF * HALF;
}

template <typename T>
cudaError_t bwd(const BwdArgs& a, cudaStream_t st) {
  const int n = a.n, h = a.h;
  const bool merged = a.band != nullptr;
  bwd_rows_kernel<T><<<(n + ROW_WARPS - 1) / ROW_WARPS, ROW_WARPS * 32, 0,
                       st>>>(
      static_cast<const T*>(a.dz), static_cast<const T*>(a.y), a.inv,
      static_cast<const T*>(a.table_prev), a.code, a.gwin, a.tile, a.gw, a.t0,
      a.tg, static_cast<T*>(a.dout), a.dout32, a.skip ? a.dzeff : nullptr, n,
      h, a.d);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  // [W_l^T | W_r^T] and dout pre-split: W's rows are B's columns, split
  // along them; dout [N, H] as the weight pass's B, in tdepth order
  const T* dout = static_cast<const T*>(a.dout);
  WJobs js = {};
  const size_t wps = (size_t)2 * h * h;
  add_wtjob<T>(&js, static_cast<const T*>(a.w_l), h, h, a.wsplit, wps);
  add_wtjob<T>(&js, static_cast<const T*>(a.w_r), h, h,
               a.wsplit + (size_t)h * h, wps);
  e = wsplit<T>(js, st);
  if (e != cudaSuccess) return e;
  e = asplit<T>(dout, n, h, a.dsplit, st);
  if (e != cudaSuccess) return e;
  // dagg | dxp = dout @ [W_l^T | W_r^T] (+ dz_eff on dxp), one launch of
  // the weight tile
  Gemm g = {};
  g.a0 = a.dout;
  g.lda0 = h;
  g.k0 = h;
  g.m = n;
  g.n = 2 * h;
  g.ldc = h;
  g.c = a.dagg;
  e = wgemm<T>(g, a.wsplit, st,
               DaggDxp{a.dxp, a.skip ? a.dzeff : nullptr, h});
  if (e != cudaSuccess) return e;
  // [dW_l; dW_r] = [agg | x]^T @ dout in row chunks (partials [2, nz, H,
  // H]), then each in chunk order
  const int kchunk = wpass_chunk(n, a.ksplit);
  const int nz = (n + kchunk - 1) / kchunk;
  const size_t hh = (size_t)h * h;
  Gemm gw = {};
  gw.a0 = a.agg;
  gw.a1 = a.x;
  gw.lda0 = gw.lda1 = h;
  gw.m = 2 * h;
  gw.n = h;
  gw.c = a.dw_part;
  gw.ldc = h;
  gw.c_f32 = 1;
  gw.zstride = hh;
  int nzk = 0;
  e = wgemm_at<T>(gw, h, n, kchunk, a.dsplit, st, DwParts{nz * hh, h}, &nzk);
  if (e != cudaSuccess) return e;
  if (nzk != nz) return cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((hh + 255) / 256);
  sum_parts_kernel<DwParts><<<blocks, 256, 0, st>>>(a.dw_part, a.dwl, nz, hh);
  sum_parts_kernel<DwParts><<<blocks, 256, 0, st>>>(a.dw_part + nz * hh,
                                                    a.dwr, nz, hh);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  // db = colsum(dout) in f32
  const float* d32 = a.dout32 ? a.dout32 : static_cast<const float*>(a.dout);
  e = colsum(d32, a.db_part, a.dbl, n, h, st);
  if (e != cudaSuccess) return e;
  if (a.has_super) {
    // the own table of dagg: the local windows (merged) or the whole table
    // by global codes (the tile kernel)
    e = merged ? table_sum<T>(static_cast<const T*>(a.dagg), a.acc_code,
                              a.gwin, a.t_part, a.town, n, h, a.tile, a.gw,
                              a.t0, a.tg, 2 * a.gw, st)
               : table_sum<T>(static_cast<const T*>(a.dagg), a.acc_code,
                              nullptr, a.t_part, a.town, n, h, a.tile,
                              a.tg / 2, a.tg / 2, a.tg, a.tg, st);
    if (e != cudaSuccess) return e;
  }
  if (!merged) return cudaSuccess;
  // dx = T(band @ dagg slab + dxp)
  BandP p = {};
  p.x = a.dagg;
  p.band = a.band;
  p.acc = a.dxp;
  p.out = a.dx;
  p.n = n;
  p.h = h;
  p.tile = a.tile;
  p.width = a.width;
  return launch_band<T, T>(p, st);
}

}  // namespace simple

extern "C" int band_simple(const void* x, const void* band, const void* msgs,
                           const void* off, const void* lo, const void* hi,
                           const void* code, const void* gwin,
                           const void* table, const void* acc, void* out,
                           int n, int h, int tile, int width, int n_spill,
                           int tg, int gw, int t0, int bf16_in, int out_f32,
                           void* stream) {
  simple::BandP p = {};
  p.x = x;
  p.band = static_cast<const int8_t*>(band);
  p.msgs = msgs;
  p.off = static_cast<const int*>(off);
  p.lo = static_cast<const int*>(lo);
  p.hi = static_cast<const int*>(hi);
  p.code = static_cast<const int*>(code);
  p.gwin = static_cast<const int*>(gwin);
  p.table = table;
  p.acc = acc;
  p.out = out;
  p.n = n;
  p.h = h;
  p.tile = tile;
  p.width = width;
  p.n_spill = n_spill;
  p.tg = tg;
  p.gw = gw;
  p.t0 = t0;
  return (int)simple::band(p, bf16_in != 0, out_f32 != 0,
                           static_cast<cudaStream_t>(stream));
}

extern "C" int sage_fwd_simple(
    const void* x, const void* band, const void* w_l, const void* w_r,
    const void* b_l, const void* table, const void* code, const void* gwin,
    const void* acc_code, const void* msgs, const void* spill_off,
    const void* spill_lo, const void* spill_hi, void* agg, void* out32,
    void* z, void* y, void* inv, void* partial, void* ftab, void* wsplit,
    int n, int h,
    int tile, int width, int gw, int t0, int tg, int has_super, int skip,
    int emit, int n_spill, int has_spill, int dropout, unsigned int thr,
    unsigned int s0, unsigned int s1, float scale, int bf16_in,
    void* stream) {
  simple::FwdArgs a = {};
  a.x = x;
  a.band = static_cast<const int8_t*>(band);
  a.w_l = w_l;
  a.w_r = w_r;
  a.b_l = b_l;
  a.table = table;
  a.code = static_cast<const int*>(code);
  a.gwin = static_cast<const int*>(gwin);
  a.acc_code = static_cast<const int*>(acc_code);
  a.msgs = msgs;
  a.off = static_cast<const int*>(spill_off);
  a.lo = static_cast<const int*>(spill_lo);
  a.hi = static_cast<const int*>(spill_hi);
  a.agg = agg;
  a.out32 = static_cast<float*>(out32);
  a.z = z;
  a.y = y;
  a.inv = static_cast<float*>(inv);
  a.partial = static_cast<float*>(partial);
  a.ftab = ftab;
  a.wsplit = static_cast<float*>(wsplit);
  a.n = n;
  a.h = h;
  a.tile = tile;
  a.width = width;
  a.gw = gw;
  a.t0 = t0;
  a.tg = tg;
  a.n_spill = n_spill;
  a.has_super = has_super;
  a.has_spill = has_spill;
  a.skip = skip;
  a.emit = emit;
  a.d = {dropout, thr, s0, s1, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(bf16_in ? simple::fwd<simple::bf16>(a, st)
                       : simple::fwd<float>(a, st));
}

// #2's variant, the merged backward ending in the band pass for dx; with
// ``band`` null #3's, the split backward's tile kernel (no band pass, no
// next layer's table: the caller folds it into dz), its own table over
// the whole [tg, H] table by global codes. Scratch: wsplit [parts, 2H, H]
// and dsplit [parts, H, N] f32 (the pre-splits), dw_part [2, ksplit, H, H].
extern "C" int sage_bwd_simple(
    const void* dz, const void* y, const void* inv, const void* agg,
    const void* x, const void* w_l, const void* w_r, const void* band,
    const void* table_prev, const void* code, const void* gwin,
    const void* acc_code, void* dout, void* dout32, void* dzeff, void* dagg,
    void* dxp, void* dx, void* dw_part, void* dwl, void* dwr, void* db_part,
    void* dbl, void* t_part, void* town, void* wsplit, void* dsplit, int n,
    int h, int tile, int width, int gw, int t0, int tg, int has_super,
    int skip, int ksplit, int dropout, unsigned int thr, unsigned int s0,
    unsigned int s1, float scale, int bf16_in, void* stream) {
  simple::BwdArgs a = {};
  a.dz = dz;
  a.y = y;
  a.inv = static_cast<const float*>(inv);
  a.agg = agg;
  a.x = x;
  a.w_l = w_l;
  a.w_r = w_r;
  a.band = static_cast<const int8_t*>(band);
  a.table_prev = table_prev;
  a.code = static_cast<const int*>(code);
  a.gwin = static_cast<const int*>(gwin);
  a.acc_code = static_cast<const int*>(acc_code);
  a.dout = dout;
  a.dout32 = static_cast<float*>(dout32);
  a.dzeff = static_cast<float*>(dzeff);
  a.dagg = dagg;
  a.dxp = dxp;
  a.dx = dx;
  a.dw_part = static_cast<float*>(dw_part);
  a.dwl = static_cast<float*>(dwl);
  a.dwr = static_cast<float*>(dwr);
  a.db_part = static_cast<float*>(db_part);
  a.dbl = static_cast<float*>(dbl);
  a.t_part = static_cast<float*>(t_part);
  a.town = static_cast<float*>(town);
  a.wsplit = static_cast<float*>(wsplit);
  a.dsplit = static_cast<float*>(dsplit);
  a.n = n;
  a.h = h;
  a.tile = tile;
  a.width = width;
  a.gw = gw;
  a.t0 = t0;
  a.tg = tg;
  a.has_super = has_super;
  a.skip = skip;
  a.ksplit = ksplit;
  a.d = {dropout, thr, s0, s1, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(bf16_in ? simple::bwd<simple::bf16>(a, st)
                       : simple::bwd<float>(a, st));
}

// The weight tile alone (tests, tools/simple_tile_bench.py): wsplit [parts,
// n, k0 + k1] f32 = the pre-split of [W0; W1] (W0 [k0, n], W1 [k1, n], row
// stride ldw; w1 null when k1 is 0)
extern "C" int wtile_split(const void* w0, const void* w1, int ldw, int k0,
                           int k1, int n, void* wsplit, int bf16_in,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  simple::WJobs js = {};
  float* out = static_cast<float*>(wsplit);
  if (bf16_in) {
    simple::add_wjob<simple::bf16>(
        &js, static_cast<const simple::bf16*>(w0), ldw, k0,
        static_cast<const simple::bf16*>(w1), ldw, k1, n, out);
    return (int)simple::wsplit<simple::bf16>(js, st);
  }
  simple::add_wjob<float>(&js, static_cast<const float*>(w0), ldw, k0,
                          static_cast<const float*>(w1), ldw, k1, n, out);
  return (int)simple::wsplit<float>(js, st);
}

// c [m, n] f32 = a0 @ W0 (+ a1 @ W1) on the weight tile, from wsplit
// (wtile_split), rows of a0 and a1 ``lda`` apart
extern "C" int wtile_gemm(const void* a0, const void* a1, int lda, int k0,
                          int k1, int m, int n, const void* wsplit, void* c,
                          int bf16_in, void* stream) {
  simple::Gemm g = {};
  g.a0 = a0;
  g.a1 = a1;
  g.lda0 = g.lda1 = lda;
  g.k0 = k0;
  g.k1 = k1;
  g.m = m;
  g.n = n;
  g.c = c;
  g.ldc = n;
  g.c_f32 = 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(wsplit);
  return (int)(bf16_in ? simple::wgemm<simple::bf16>(g, w, st)
                       : simple::wgemm<float>(g, w, st));
}

// The backward's pre-splits alone (tests, tools/simple_tile_bench.py):
// wsplit [parts, n0 + n1, k] f32 = the pre-split of B = [W0^T | W1^T] (W0
// [n0, k], W1 [n1, k] as stored, w1 null when n1 is 0), for wtile_gemm
extern "C" int wtile_split_t(const void* w0, const void* w1, int n0, int n1,
                             int k, void* wsplit, int bf16_in, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  simple::WJobs js = {};
  float* out = static_cast<float*>(wsplit);
  const size_t ps = (size_t)(n0 + n1) * k;
  if (bf16_in) {
    using B = simple::bf16;
    simple::add_wtjob<B>(&js, static_cast<const B*>(w0), n0, k, out, ps);
    if (w1)
      simple::add_wtjob<B>(&js, static_cast<const B*>(w1), n1, k,
                           out + (size_t)n0 * k, ps);
    return (int)simple::wsplit<B>(js, st);
  }
  simple::add_wtjob<float>(&js, static_cast<const float*>(w0), n0, k, out,
                           ps);
  if (w1)
    simple::add_wtjob<float>(&js, static_cast<const float*>(w1), n1, k,
                             out + (size_t)n0 * k, ps);
  return (int)simple::wsplit<float>(js, st);
}

// wsplit [parts, n, k0 + k1] f32 = the pre-split of B = [W0^T; W1^T]
// stacked in depth (W0 [n, k0], W1 [n, k1] as stored; ea_simple.cu's dx =
// [r_de1 | s] @ [W_er^T; W_sp^T]), for wtile_gemm
extern "C" int wtile_split_tk(const void* w0, const void* w1, int n, int k0,
                              int k1, void* wsplit, int bf16_in,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  simple::WJobs js = {};
  float* out = static_cast<float*>(wsplit);
  if (bf16_in) {
    using B = simple::bf16;
    simple::add_wtjob<B>(&js, static_cast<const B*>(w0), n, k0, out, 0,
                         static_cast<const B*>(w1), k1);
    return (int)simple::wsplit<B>(js, st);
  }
  simple::add_wtjob<float>(&js, static_cast<const float*>(w0), n, k0, out, 0,
                           static_cast<const float*>(w1), k1);
  return (int)simple::wsplit<float>(js, st);
}

// dsplit [parts, n, rows rounded up to 32] f32 = the weight pass's
// pre-split of B = b [rows, n] (tdepth order, depths past rows zero)
extern "C" int wtile_split_act(const void* b, int rows, int n, void* dsplit,
                               int bf16_in, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(dsplit);
  if (bf16_in)
    return (int)simple::asplit<simple::bf16>(
        static_cast<const simple::bf16*>(b), rows, n, out, st);
  return (int)simple::asplit<float>(
      static_cast<const float*>(b), rows, n, out, st);
}

// The weight pass alone: c0 [m0, n] = A0^T @ B and (a1 not null) c1 [m0,
// n] = A1^T @ B over ``rows`` rows (A0, A1 [rows, m0], m0 % 128 == 0;
// dsplit: wtile_split_act of B [rows, n]) in chunks of kchunk rows (a
// multiple of 64), part [2, chunks, m0, n] f32 scratch, as #2s and #3s run
// dW_l and dW_r
extern "C" int wtile_gemm_at(const void* a0, const void* a1, int m0, int n,
                             int rows, int kchunk, const void* dsplit,
                             void* part, void* c0, void* c1, int bf16_in,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  simple::Gemm g = {};
  g.a0 = a0;
  g.a1 = a1;
  g.lda0 = g.lda1 = m0;
  g.m = a1 ? 2 * m0 : m0;
  g.n = n;
  g.c = part;
  g.ldc = n;
  g.c_f32 = 1;
  const size_t mn = (size_t)m0 * n;
  g.zstride = mn;
  const int nz = (rows + kchunk - 1) / kchunk;
  const simple::DwParts epi = {nz * mn, m0};
  const float* b = static_cast<const float*>(dsplit);
  int nzk = 0;
  cudaError_t e =
      bf16_in ? simple::wgemm_at<simple::bf16>(g, m0, rows, kchunk, b, st,
                                               epi, &nzk)
              : simple::wgemm_at<float>(g, m0, rows, kchunk, b, st, epi,
                                        &nzk);
  if (e != cudaSuccess) return (int)e;
  if (nzk != nz) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((mn + 255) / 256);
  float* p = static_cast<float*>(part);
  simple::sum_parts_kernel<simple::DwParts><<<blocks, 256, 0, st>>>(
      p, static_cast<float*>(c0), nz, mn);
  if (a1)
    simple::sum_parts_kernel<simple::DwParts><<<blocks, 256, 0, st>>>(
        p + nz * mn, static_cast<float*>(c1), nz, mn);
  return (int)cudaGetLastError();
}
