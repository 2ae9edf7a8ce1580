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
// kernels take their products from simple.cuh's tile instead, which splits
// float32 operands for 3xTF32 wgmma as it loads them (float32 accuracy).
//
// What each computes is what the engine kernel computes (their headers say
// it in full), with the same slab start s_t = clip(t*T - W/2, 0, N - (T+W)),
// spill window start (sage_common.cuh::spill_window_start), dropout words
// (sage_common.cuh::dropout_bits: keep when the word < thr, scale by
// `scale`, after relu and the skip) and star-table codes. Each TPU kernel
// becomes a few launches of four pieces:
//  - band_kernel: acc = band_t @ x[s_t : s_t+T+W] + the row's spill run
//    [lo, hi) of its message window + table[code] + acc_in, cast once to
//    the output type. One warp per row, lanes across 4-column groups: the
//    warp finds the row's nonzero band counts by ballot and adds count *
//    x[s_t + k] for those alone (the int8 counts are exact in either type),
//    so it does the data's multiply-adds, not the dense [T, T+W] product.
//    Sums run in the plain version's order of terms: band, spill, table,
//    acc. #4 alone; #1's phase 1 (agg = x_dtype(acc)); #2's band pass (dx =
//    x_dtype(band @ dagg slab + dxp)).
//  - the two product tiles, on the tensor cores in 3xTF32 (bf16 operands in
//    one tf32 pass), 128 x 128 tiles of C: #1's out = agg @ W_l + x @ W_r +
//    b_l (f32) on wtile.cuh's weight tile, [W_l; W_r] pre-split once a call
//    into the wrapper's scratch (``wsplit``), A and the weight's parts by
//    TMA, A's fragments from registers; the backward's dagg = dout @ W_l^T
//    and dxp = dout @ W_r^T (+ dz_eff), and dW = [agg | x]^T @ dout split
//    over row chunks (blockIdx.z) into f32 partials that sum_parts adds in
//    chunk order, on simple.cuh's gemm_kernel (a producer warpgroup
//    splitting 32-deep slices into a ring, two wgmma warpgroups).
//  - row passes, one warp per row, looping over the row's columns, so any
//    H fits: #1's epilogue (sum of squares, inv, y, relu, skip, dropout,
//    z) and the backward's norm backward (dz_eff with the next layer's
//    star and the dropout mask, dy, s = rowsum(dy * y), dout). The row-wide
//    norm is split from the products because a row of H = 1024 f32 sums
//    does not fit one block's registers beside a product tile.
//  - code sums: per 64-row block, the sums of a [N, H] tensor's rows by
//    code (each code's rows in row order), the partials that
//    sage_common.cuh::table_reduce_kernel adds in block order: #1's emitted
//    table (of z) by code_sums_once_kernel, one pass over the block's rows
//    into per-code sums in shared memory; #2's own table (of dagg) and #3's
//    (of dagg, global codes) by code_sums_kernel, a pass over the rows for
//    each code (the same adds in the same order: the same bits). colsum_*
//    adds db = colsum(dout) the same way, in two fixed-order passes.
// No float atomics: two runs give the same bits.
//
// What bounds them on an H100: at the flagship shape (N = 103,424, H = 512,
// T + W = 320) #1 is 4 N H^2 = 108 GFLOP of f32 products, 3 tf32 products
// each (0.66 ms at the 495 TFLOP/s TF32 rate) beside the band's few
// nonzeros a row, and the backward twice that, so they are bound by
// operations; the band kernel alone is bound by bytes (x, the band, acc and
// out), the code sums by z's bytes and the partials'. The row passes, the
// band and the code sums are separate launches that read and write device
// memory (PERF.md has the times).

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

constexpr int GROUP = 8;      // 128-column chunks a warp sums at once

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

template <typename T, typename O>
__global__ void __launch_bounds__(ROW_WARPS * 32) band_kernel(BandP p) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * ROW_WARPS + (threadIdx.x >> 5);
  if (r >= p.n) return;
  const int s_len = p.tile + p.width;
  const int t = r / p.tile;
  const int hi_start = p.n - s_len > 0 ? p.n - s_len : 0;
  const int start = min(max(t * p.tile - p.width / 2, 0), hi_start);
  const T* x = static_cast<const T*>(p.x);
  const int8_t* brow = p.band + (size_t)r * s_len;
  int ws = 0, mlo = 0, mhi = 0;
  if (p.msgs) {
    ws = sage::spill_window_start(p.off[t], p.n_spill);
    mlo = p.lo[r];
    mhi = p.hi[r];
  }
  const int trow = p.code ? table_row(p.code[r], p.gwin, t, p.gw, p.t0, p.tg)
                          : -1;
  for (int c0 = 0; c0 < p.h; c0 += GROUP * 128) {
    const int nch = min(GROUP, (p.h - c0) / 128);
    const int col = c0 + lane * 4;
    float acc[GROUP][4];
#pragma unroll
    for (int q = 0; q < GROUP; ++q)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[q][i] = 0.f;
    for (int k0 = 0; k0 < s_len; k0 += 32) {
      const int k = k0 + lane;
      const int v = k < s_len ? (int)brow[k] : 0;
      unsigned m = __ballot_sync(0xFFFFFFFFu, v != 0);
      while (m) {
        const int j = __ffs(m) - 1;
        m &= m - 1;
        const float cnt = (float)__shfl_sync(0xFFFFFFFFu, v, j);
        const T* xr = x + (size_t)(start + k0 + j) * p.h + col;
#pragma unroll
        for (int q = 0; q < GROUP; ++q) {
          if (q < nch) {
            float xv[4];
            ld4(xr + q * 128, xv);
#pragma unroll
            for (int i = 0; i < 4; ++i)
              acc[q][i] = fmaf(cnt, xv[i], acc[q][i]);
          }
        }
      }
    }
    if (mhi > mlo) {
      // the row's spill run, summed on its own in message order
      const T* msgs = static_cast<const T*>(p.msgs);
      float sp[GROUP][4];
#pragma unroll
      for (int q = 0; q < GROUP; ++q)
#pragma unroll
        for (int i = 0; i < 4; ++i) sp[q][i] = 0.f;
      for (int mm = mlo; mm < mhi; ++mm) {
        const T* mr = msgs + (size_t)(ws + mm) * p.h + col;
#pragma unroll
        for (int q = 0; q < GROUP; ++q) {
          if (q < nch) {
            float mv[4];
            ld4(mr + q * 128, mv);
#pragma unroll
            for (int i = 0; i < 4; ++i) sp[q][i] += mv[i];
          }
        }
      }
#pragma unroll
      for (int q = 0; q < GROUP; ++q)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[q][i] += sp[q][i];
    }
    O* out = static_cast<O*>(p.out) + (size_t)r * p.h + col;
#pragma unroll
    for (int q = 0; q < GROUP; ++q) {
      if (q < nch) {
        float v[4];
        if (trow >= 0) {
          ld4(static_cast<const T*>(p.table) + (size_t)trow * p.h + col +
                  q * 128, v);
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[q][i] += v[i];
        }
        if (p.acc) {
          ld4(static_cast<const T*>(p.acc) + (size_t)r * p.h + col + q * 128,
              v);
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[q][i] += v[i];
        }
        st4(out + q * 128, acc[q]);
      }
    }
  }
}

template <typename T, typename O>
cudaError_t launch_band(const BandP& p, cudaStream_t st) {
  band_kernel<T, O><<<(p.n + ROW_WARPS - 1) / ROW_WARPS, ROW_WARPS * 32, 0,
                      st>>>(p);
  return cudaGetLastError();
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

// the table of a code sum: partials by block, then table_reduce's fixed
// order over the tiles whose window holds each table row
template <typename T>
cudaError_t table_sum(const T* v, const int* codes, const int* gwin,
                      float* part, float* table, int n, int h, int tile,
                      int gw, int t0, int tg, int ncode, cudaStream_t st) {
  code_sums_kernel<T><<<dim3(n / CB, h / 128), 128, 0, st>>>(v, codes, part,
                                                             ncode, h);
  cudaError_t e = cudaGetLastError();
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
      *town;
  int n, h, tile, width, gw, t0, tg, has_super, skip, ksplit;
  Drop d;
};

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
  // dagg = dout @ W_l^T, dxp = dout @ W_r^T (+ dz_eff)
  Gemm g = {};
  g.a0 = a.dout;
  g.lda0 = g.ldb0 = h;
  g.k0 = g.kchunk = h;
  g.m = n;
  g.n = h;
  g.ldc = h;
  g.b0 = a.w_l;
  g.c = a.dagg;
  e = gemm<T, false, true>(g, 1, st);
  if (e != cudaSuccess) return e;
  g.b0 = a.w_r;
  g.add = a.skip ? a.dzeff : nullptr;
  g.c = a.dxp;
  e = gemm<T, false, true>(g, 1, st);
  if (e != cudaSuccess) return e;
  // dW_l = agg^T @ dout, dW_r = x^T @ dout, db = colsum(dout) in f32
  const T* dout = static_cast<const T*>(a.dout);
  e = atb<T>(static_cast<const T*>(a.agg), dout, a.dw_part, a.dwl, n, h,
             a.ksplit, st);
  if (e != cudaSuccess) return e;
  e = atb<T>(static_cast<const T*>(a.x), dout, a.dw_part, a.dwr, n, h,
             a.ksplit, st);
  if (e != cudaSuccess) return e;
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
// the whole [tg, H] table by global codes
extern "C" int sage_bwd_simple(
    const void* dz, const void* y, const void* inv, const void* agg,
    const void* x, const void* w_l, const void* w_r, const void* band,
    const void* table_prev, const void* code, const void* gwin,
    const void* acc_code, void* dout, void* dout32, void* dzeff, void* dagg,
    void* dxp, void* dx, void* dw_part, void* dwl, void* dwr, void* db_part,
    void* dbl, void* t_part, void* town, int n, int h, int tile, int width,
    int gw, int t0, int tg, int has_super, int skip, int ksplit, int dropout,
    unsigned int thr, unsigned int s0, unsigned int s1, float scale,
    int bf16_in, void* stream) {
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
