// The float32 and any-width variants of the fused EA block's kernels for
// Hopper (sm_90a): the block forward (#5) and backward (#6) in float32 or
// bf16 at any H % 128 == 0, with f32 accumulation.
//
// Replace, for every (dtype, H) that the product engine does not take
// (ops/banded_matmul.py::kernel_variant: the engine takes bf16 at H in
// {128, 256, 512}), the TPU kernels
//   #5 buckgnn_tpu/ops/pallas_ea_block.py::_fwd_kernel (ea_block_fwd_simple)
//   #6 buckgnn_tpu/ops/pallas_ea_block.py::_bwd_kernel with _fold_dx and
//      _far_cotangents (ea_block_bwd_simple),
// which compute in x's dtype at any H % 128 == 0 (pallas_ea_block.py:912-
// 923, 962). The engine kernels (ea_block_fwd.cu, ea_block_bwd.cu) stream
// bf16 operands MN-major into wgmma, which takes tf32 only K-major, and one
// pass of TF32 keeps three digits, so these take their products from the
// 3xTF32 tiles instead (float32 operands split into tf32 hi and lo parts,
// float32 accuracy): every product whose B is a weight on wtile.cuh's
// weight tile, from the weights pre-split once a call into the scratch:
// as stored (`WS`: all of #5's, and #6's recomputed forward chain: the
// node chain, the encoder and e2, so that #6's relu masks are the bits #5
// computed) and transposed (`WT`: #6's dz @ W^T, W's rows split); the
// weight pass on simple.cuh's gemm_kernel.
//
// What each computes is the engine kernels' function, cast point for cast
// point: the chain of ops/ea_block.py's module docstring, step by step as
// ea_block_fwd_plain and ea_block_bwd_plain (every rounding to the element
// type where they round), with the same geometry (send, recv, the receiver
// runs [rlo, rhi), the sender-sorted slots sorder[soff[n]:soff[n+1]]), the
// encoder mode (the raw [E, 8] window, 8 -> 128 -> 128 -> H with zero-padded
// weights and bias rows 8-10) and the dropout words (sage_common.cuh: edge
// rows 0..E-1, node rows E..E+N-1). The appended far rows of 'hybrid' and
// 'autodiff' are rows like any other. Each pass of the engine kernels
// (FWD_PASSES, BWD_PASSES of ops/ea_block.py) is a few launches of four
// pieces, every kernel's name carrying its pass (profiles):
//  - the weight tile (simple::wtile_kernel, 128-row tiles of two 64-row
//    halves) with this file's epilogue `Epi` (`Halves`: two of them, one
//    for each half of C's columns),
//    each product's instance compiled with its own terms only (`E_*`):
//    gathered projection rows by slot (p_r[recv], p_s[send], p_p
//    [send]; id < 0 adds nothing), the bias row or the mean's (v + cnt *
//    b_p1) / max(cnt, 1), an f32 addend, a dropped addend (dz_e, dz_x), a
//    relu mask from a stored tensor, relu, per-64-row-block column sums of
//    the result (the bias gradients, cnt-weighted for b_p1), stores in f32
//    and the element type, and the skip and dropout before the block's
//    outputs;
//  - run_sums_kernel: a warp a node, the f32 sum in slot order over its
//    receiver run (sm, r_de1) or its sender-sorted slots (s = [de1 | dzm],
//    the halo and the far folds in one pass);
//  - ew_kernel: a 64-row block of 128 columns, one thread a column, for
//    dz_x's dropout (dx2) and dzm = where(m1 > 0, dsm[recv], 0), with the
//    block's column sums; enc_first_kernel: the encoder's K = 8 first layer
//    as FMAs;
//  - the weight pass: every dW = A^T @ B over node or slot rows in
//    2,048-row chunks (dW's error grows with a chunk's rows) into f32
//    partials summed in chunk order (simple::atb_rows, on gemm_kernel),
//    dW_en0 ([8, 128])
//    by its own chunked kernel, and the bias rows from the column-sum
//    partials in block order.
// No float atomics: two runs give the same bits.
//
// What bounds them on an H100: at the ea-virtual shape (224,650 valid slots
// of E = 239,168, N = 51,712, H = 512) ops/ea_block.py::pass_flops counts
// 597 GFLOP for #5 and 1,448 for #6 of float32 products, 3 tf32 products
// each: 3.6 and 8.8 ms at the 495 TFLOP/s TF32 rate, bound by operations.
// This version stores every intermediate (the engine keeps the chain in
// shared memory), and each tile's epilogue (the gathers above all) runs
// beside no products (PERF.md has the times).

#include "wtile.cuh"

namespace ea_simple {

using simple::bf16;
using simple::Drop;
using simple::Gemm;
using simple::ld4;
using simple::ld4c;
using simple::Rows;
using simple::st4;

// the passes, named in every kernel they launch
struct fwd_proj {};
struct fwd_edge {};
struct fwd_node {};
struct bwd_node1 {};
struct bwd_edge {};
struct bwd_node2 {};
struct bwd_weights {};

constexpr int ENC_IN = 8;     // raw edge-feature lanes (zero-padded)
constexpr int ENC_HID = 128;  // the edge encoder's padded hidden width
constexpr int CHUNK = 2048;   // rows of a weight-gradient chunk
constexpr int RB = simple::HALF;  // rows of a column-sum block

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float dropped(const Drop& d, uint32_t rk, int col,
                                         float v) {
  return sage::dropout_bits(rk, d.s1, (uint32_t)col) < d.thr ? v * d.scale
                                                             : 0.f;
}

// The product tile's epilogue, in this order on each f32 sum v (row r,
// column c; every [rows, N] tensor of row stride ldc): v += g0[ids0[r]],
// g1[ids1[r]] (id < 0: nothing); v = (v + cnt[r] * bias) / max(cnt[r], 1)
// with cnt, else v += bias; v += add32; v += dropout(dadd) (d.on, rows
// row0 + r); v = mask > 0 ? v : 0; relu; the column sums of v (cnt[r] * v
// with cs_cnt) over each 64-row block b into colsum[b, N]; out_f = v, out_t
// = T(v); out2 = T(dropout(v (+ skip))).
// ``F`` names the terms a call site may set (E_* bits; null pointers still
// skip theirs): the code of the others is compiled out, so that each
// product's epilogue is as short as its work. The weight tile walks many
// tiles a block, and there the code of every term in every product's
// epilogue slowed #5 by about a third (NVIDIA H100 80GB HBM3, 700 W;
// PERF.md).
enum : int {
  E_G0 = 1, E_G1 = 2, E_CNT = 4, E_ADD = 8, E_DADD = 16, E_MASK = 32,
  E_COLSUM = 64, E_OUTF = 128, E_OUTT = 256, E_OUT2 = 512
};

template <typename T, class Pass, int F>
struct Epi {
  __host__ __device__ static constexpr bool has(int f) {
    return (F & f) != 0;
  }
  const T* g0;
  const int* ids0;
  int ld0;
  const T* g1;
  const int* ids1;
  int ld1;
  const float* bias;
  const float* cnt;
  const float* add32;
  const T* dadd;
  const T* mask;
  int relu;
  float* colsum;
  int cs_cnt;
  float* out_f;
  T* out_t;
  const T* skip;
  T* out2;
  Drop d;
  int row0;

  // a batch of rows' loads are issued before any is used: the gathers
  // and masks of BATCH rows in flight at once
  template <typename U>
  __device__ __forceinline__ void operator()(const Gemm& g,
                                             const Rows& f) const {
    constexpr int B = simple::BATCH;
    const int mv = g.rows ? g.rows : g.m;
    const int ld = g.ldc;
    const int col = f.col();
    float bb[4] = {0.f, 0.f, 0.f, 0.f};
    if (bias) ld4(bias + col, bb);
    float cs[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 1
    for (int i0 = 0; i0 < RB / 4; i0 += B) {
      int row[B];
      bool ok[B];
      float v[B][4], x0[B][4], x1[B][4], xa[B][4], xd[B][4], xm[B][4],
          xs[B][4], cn[B];
#pragma unroll
      for (int u = 0; u < B; ++u) {
        row[u] = f.row(i0 + u);
        ok[u] = row[u] < mv;
        f.sums(i0 + u, v[u]);
        cn[u] = has(E_CNT) && cnt && ok[u] ? cnt[row[u]] : 0.f;
      }
      if constexpr (has(E_G0)) gather(g0, ids0, ld0, row, ok, col, x0);
      if constexpr (has(E_G1)) gather(g1, ids1, ld1, row, ok, col, x1);
#pragma unroll
      for (int u = 0; u < B; ++u) {
        const size_t ro = (size_t)row[u] * ld + col;
        if (has(E_ADD) && add32 && ok[u]) ld4c(add32 + ro, xa[u]);
        if (has(E_DADD) && dadd && ok[u]) ld4(dadd + ro, xd[u]);
        if (has(E_MASK) && mask && ok[u]) ld4(mask + ro, xm[u]);
        if (has(E_OUT2) && out2 && skip && ok[u]) ld4(skip + ro, xs[u]);
      }
#pragma unroll
      for (int u = 0; u < B; ++u) {
        if (!ok[u]) continue;
        const uint32_t rk = (has(E_DADD) || has(E_OUT2)) && d.on
                                ? sage::row_key(d.s0, (uint32_t)(row0 + row[u]))
                                : 0u;
        const size_t ro = (size_t)row[u] * ld + col;
        float* x = v[u];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (has(E_G0) && g0) x[q] += x0[u][q];
          if (has(E_G1) && g1) x[q] += x1[u][q];
          if (has(E_CNT) && cnt) {
            x[q] = (x[q] + cn[u] * bb[q]) / fmaxf(cn[u], 1.f);
          } else {
            x[q] += bb[q];
          }
          if (has(E_ADD) && add32) x[q] += xa[u][q];
          if (has(E_DADD) && dadd)
            x[q] += d.on ? dropped(d, rk, col + q, xd[u][q]) : xd[u][q];
          if (has(E_MASK) && mask) x[q] = xm[u][q] > 0.f ? x[q] : 0.f;
          if (relu) x[q] = fmaxf(x[q], 0.f);
          if (has(E_COLSUM) && colsum)
            cs[q] += cs_cnt ? cn[u] * x[q] : x[q];
        }
        if (has(E_OUTF) && out_f) st4(out_f + ro, v[u]);
        if (has(E_OUTT) && out_t) st4(out_t + ro, v[u]);
        if (has(E_OUT2) && out2) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (skip) x[q] += xs[u][q];
            if (d.on) x[q] = dropped(d, rk, col + q, x[q]);
          }
          st4(out2 + ro, v[u]);
        }
      }
    }
    // the 64-row block's column sums (a half past the rows has none)
    if (has(E_COLSUM) && colsum && f.base < mv)
      simple::half_colsum(cs, f,
                          colsum + (size_t)(f.base / RB) * g.n + f.n0);
  }

  // x[u] = gp[ids[row[u]]] at 4 columns (zeros for id < 0 or a row past
  // the rows), the ids of the batch first, then its gathers
  __device__ __forceinline__ void gather(const T* gp, const int* ids, int ldg,
                                         const int (&row)[simple::BATCH],
                                         const bool (&ok)[simple::BATCH],
                                         int col,
                                         float (&x)[simple::BATCH][4]) const {
    if (!gp) return;
    int id[simple::BATCH];
#pragma unroll
    for (int u = 0; u < simple::BATCH; ++u) id[u] = ok[u] ? ids[row[u]] : -1;
#pragma unroll
    for (int u = 0; u < simple::BATCH; ++u) {
      if (id[u] >= 0) {
        ld4(gp + (size_t)id[u] * ldg + col, x[u]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) x[u][q] = 0.f;
      }
    }
  }
};

// C = [C0 | C1] in two H-wide halves, each through its own epilogue
// (dxacc | dagg = dzg @ W_g0^T): a 128-column tile lies in one half, and
// both see N = H, C1's columns as [0, H)
template <class E0, class E1>
struct Halves {
  E0 lo;
  E1 hi;
  int h;
  template <typename U>
  __device__ __forceinline__ void operator()(const Gemm& g,
                                             const Rows& f) const {
    Gemm gh = g;
    gh.n = h;
    if (f.n0 < h) {
      lo.template operator()<U>(gh, f);
    } else {
      Rows fh = f;
      fh.n0 -= h;
      hi.template operator()<U>(gh, fh);
    }
  }
};

// out = the epilogue of A0 @ W0 (+ A1 @ W1) over ``rows`` rows, N columns,
// row stride ldc, on the weight tile: ``w`` the pre-split [W0; W1]
// (wtile.cuh) of weights as stored or transposed
template <typename T, class E>
cudaError_t wprod(const T* a0, int lda0, int k0, const T* a1, int lda1,
                  int k1, const float* w, int rows, int n, int ldc,
                  const E& epi, cudaStream_t st) {
  Gemm g = {};
  g.a0 = a0;
  g.a1 = a1;
  g.lda0 = lda0;
  g.lda1 = lda1;
  g.k0 = k0;
  g.k1 = k1;
  g.m = (rows + RB - 1) / RB * RB;
  g.rows = rows;
  g.n = n;
  g.ldc = ldc;
  return simple::wgemm<T, E>(g, w, st, epi);
}

template <typename T, class E>
cudaError_t wprod(const T* a, int lda, int k, const float* w, int rows,
                  int n, const E& epi, cudaStream_t st) {
  return wprod<T>(a, lda, k, nullptr, 0, 0, w, rows, n, n, epi, st);
}

// out rows r < n (row stride ld_out) = T(the f32 sum, in slot order, of
// the src rows (ids ? ids[k] : k) for k in [lo[r], hi[r])); a warp a row
template <typename T, class Pass>
__global__ void __launch_bounds__(simple::ROW_WARPS * 32) run_sums_kernel(
    const T* src, int ld_src, const int* lo, const int* hi, const int* ids,
    T* out, int ld_out, int n, int h) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * simple::ROW_WARPS + (threadIdx.x >> 5);
  if (r >= n) return;
  const int a = lo[r], b = hi[r];
  for (int c = lane * 4; c < h; c += 128) {
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k = a; k < b; ++k) {
      const int row = ids ? __ldg(ids + k) : k;
      float v[4];
      ld4(src + (size_t)row * ld_src + c, v);
#pragma unroll
      for (int j = 0; j < 4; ++j) s[j] += v[j];
    }
    st4(out + (size_t)r * ld_out + c, s);
  }
}

template <typename T, class Pass>
cudaError_t run_sums(const T* src, int ld_src, const int* lo, const int* hi,
                     const int* ids, T* out, int ld_out, int n, int h,
                     cudaStream_t st) {
  constexpr int RW = simple::ROW_WARPS;
  run_sums_kernel<T, Pass><<<(n + RW - 1) / RW, RW * 32, 0, st>>>(
      src, ld_src, lo, hi, ids, out, ld_out, n, h);
  return cudaGetLastError();
}

// rows of a 64-row block, one thread a column: v = src[ids ? ids[r] : r]
// (zero for id < 0), v = mask > 0 ? v : 0, v = dropout(v) (d.on, rows row0
// + r); out_f = v, out_t = T(v); the block's column sums of v
template <typename T, class Pass>
__global__ void __launch_bounds__(128) ew_kernel(
    const T* src, const int* ids, const T* mask, Drop d, int row0,
    float* out_f, T* out_t, float* colsum, int rows, int h) {
  const int col = blockIdx.y * 128 + threadIdx.x;
  const int r0 = blockIdx.x * RB;
  const int r1 = min(rows, r0 + RB);
  float s = 0.f;
  for (int r = r0; r < r1; ++r) {
    const int id = ids ? ids[r] : r;
    float v = id >= 0 ? simple::to_f(src[(size_t)id * h + col]) : 0.f;
    if (mask && !(simple::to_f(mask[(size_t)r * h + col]) > 0.f)) v = 0.f;
    if (d.on) {
      v = dropped(d, sage::row_key(d.s0, (uint32_t)(row0 + r)), col, v);
    }
    s += v;
    if (out_f) out_f[(size_t)r * h + col] = v;
    out_t[(size_t)r * h + col] = from_f<T>(v);
  }
  colsum[(size_t)blockIdx.x * h + col] = s;
}

template <typename T, class Pass>
cudaError_t ew(const T* src, const int* ids, const T* mask, Drop d, int row0,
               float* out_f, T* out_t, float* colsum, int rows, int h,
               cudaStream_t st) {
  ew_kernel<T, Pass><<<dim3((rows + RB - 1) / RB, h / 128), 128, 0, st>>>(
      src, ids, mask, d, row0, out_f, out_t, colsum, rows, h);
  return cudaGetLastError();
}

// h1 = T(relu(raw @ wen0 + b8)) [E, 128], the encoder's first layer (K =
// 8, f32 FMAs in k order); one thread a column
template <typename T, class Pass>
__global__ void __launch_bounds__(ENC_HID) enc_first_kernel(
    const T* raw, const T* wen0, const float* b8, T* h1, int e) {
  const int c = threadIdx.x;
  float w[ENC_IN];
#pragma unroll
  for (int k = 0; k < ENC_IN; ++k) w[k] = simple::to_f(wen0[k * ENC_HID + c]);
  const float b = b8[c];
  const int r0 = blockIdx.x * RB;
  const int r1 = min(e, r0 + RB);
  for (int r = r0; r < r1; ++r) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < ENC_IN; ++k)
      s = fmaf(simple::to_f(raw[(size_t)r * ENC_IN + k]), w[k], s);
    h1[(size_t)r * ENC_HID + c] = from_f<T>(fmaxf(s + b, 0.f));
  }
}

template <typename T, class Pass>
cudaError_t enc_first(const T* raw, const T* wen0, const float* b8, T* h1,
                      int e, cudaStream_t st) {
  enc_first_kernel<T, Pass><<<(e + RB - 1) / RB, ENC_HID, 0, st>>>(
      raw, wen0, b8, h1, e);
  return cudaGetLastError();
}

// the partials of dW_en0 [8, 128] = raw^T @ dz1, one CHUNK of slot rows a
// block, one thread an entry
template <typename T, class Pass>
__global__ void __launch_bounds__(ENC_IN * ENC_HID) wen0_part_kernel(
    const T* raw, const T* dz1, float* part, int e) {
  const int k = threadIdx.x / ENC_HID, c = threadIdx.x % ENC_HID;
  const int r0 = blockIdx.x * CHUNK;
  const int r1 = min(e, r0 + CHUNK);
  float s = 0.f;
  for (int r = r0; r < r1; ++r)
    s = fmaf(simple::to_f(raw[(size_t)r * ENC_IN + k]),
             simple::to_f(dz1[(size_t)r * ENC_HID + c]), s);
  part[(size_t)blockIdx.x * ENC_IN * ENC_HID + threadIdx.x] = s;
}

// dbias rows from their per-block column-sum partials, in block order
struct BiasParts {
  const float* part[11];
  int blocks[11];
  int width[11];
};

template <class Pass>
__global__ void bias_reduce_kernel(BiasParts p, float* dbias, int h) {
  const int row = blockIdx.y;
  const int col = blockIdx.x * 128 + threadIdx.x;
  if (col >= h) return;
  float s = 0.f;
  const int w = p.width[row];
  if (col < w)
    for (int b = 0; b < p.blocks[row]; ++b)
      s += p.part[row][(size_t)b * w + col];
  dbias[(size_t)row * h + col] = s;
}

// ---- scratch -------------------------------------------------------------

size_t align256(size_t b) { return (b + 255) / 256 * 256; }

struct Carver {
  unsigned char* base;
  size_t off = 0;
  void* take(size_t bytes) {
    unsigned char* p = base ? base + off : nullptr;
    off += align256(bytes);
    return p;
  }
};

size_t blocks(int rows) { return (size_t)(rows + RB - 1) / RB; }

size_t chunks(int rows) { return (size_t)(rows + CHUNK - 1) / CHUNK; }

// the pre-split weights (wtile.cuh) that a call's weight-tile products
// read: every weight in the forward, the recomputed chain's in the
// backward; null where not read
struct WS {
  float *wsp, *wer, *wee, *we1, *wpe, *wp1, *wg0, *wg1, *wb0, *wb1, *wen1,
      *wen2;
};

// the backward's pre-split transposed weights, B = W^T of each dz @ W^T:
// [W_er^T; W_sp^T] stacked in depth [3H, H] (dx), W_g0^T [H, 2H] (dxacc |
// dagg), the others [H, H]; the encoder's W_en2^T [H, 128] and W_en1^T
struct WT {
  float *wx, *wb1, *wb0, *wg1, *wg0, *wp1, *wpe, *we1, *wee, *wen2, *wen1;
};

// scratch for a [k, n] B pre-split
template <typename T>
float* wtake(Carver& c, int k, int n) {
  return static_cast<float*>(c.take(simple::wsplit_floats<T>(k, n) * 4));
}

template <typename T>
void carve_ws(Carver& c, int h, int enc, bool fwd, WS* s) {
  auto take = [&](int k, int n) { return wtake<T>(c, k, n); };
  *s = {};
  if (fwd) {
    s->wsp = take(h, 2 * h);
    float** sq[] = {&s->wer, &s->wee, &s->wpe, &s->wb1};
    for (float** q : sq) *q = take(h, h);
  }
  float** sq[] = {&s->we1, &s->wp1, &s->wg1, &s->wb0};
  for (float** q : sq) *q = take(h, h);
  s->wg0 = take(2 * h, h);
  if (enc) {
    s->wen1 = take(ENC_HID, ENC_HID);
    s->wen2 = take(ENC_HID, h);
  }
}

template <typename T>
void carve_wt(Carver& c, int h, int enc, WT* s) {
  *s = {};
  s->wx = wtake<T>(c, 3 * h, h);
  float** sq[] = {&s->wb1, &s->wb0, &s->wg1, &s->wp1, &s->wpe, &s->we1,
                  &s->wee};
  for (float** q : sq) *q = wtake<T>(c, h, h);
  s->wg0 = wtake<T>(c, h, 2 * h);
  if (enc) {
    s->wen2 = wtake<T>(c, h, ENC_HID);
    s->wen1 = wtake<T>(c, ENC_HID, ENC_HID);
  }
}

template <typename T>
struct FwdScratch {
  T *proj, *h1, *h2, *ein, *e2, *sm, *agg, *g1, *x1, *b1;
  float* x1f;
  WS ws;
};

template <typename T>
size_t carve_fwd(unsigned char* base, int n, int e, int h, int enc,
                 FwdScratch<T>* s) {
  Carver c{base};
  const size_t nh = (size_t)n * h * sizeof(T), eh = (size_t)e * h * sizeof(T);
  s->proj = static_cast<T*>(c.take(3 * nh));
  s->h1 = s->h2 = s->ein = nullptr;
  if (enc) {
    const size_t e128 = (size_t)e * ENC_HID * sizeof(T);
    s->h1 = static_cast<T*>(c.take(e128));
    s->h2 = static_cast<T*>(c.take(e128));
    s->ein = static_cast<T*>(c.take(eh));
  }
  s->e2 = static_cast<T*>(c.take(eh));
  T** node[] = {&s->sm, &s->agg, &s->g1, &s->x1, &s->b1};
  for (T** q : node) *q = static_cast<T*>(c.take(nh));
  s->x1f = static_cast<float*>(c.take((size_t)n * h * 4));
  carve_ws<T>(c, h, enc, true, &s->ws);
  return c.off;
}

template <typename T>
struct BwdScratch {
  // [N, H] in T
  T *sm, *agg, *g1, *x1, *b1, *dx2c, *dzb, *dx1c, *dzg, *daggc, *dsm, *rde1;
  T* snode;  // [N, 2H]
  T *e2, *dzm, *de2c, *de1;  // [E, H]
  T *ein, *deoc, *hen1, *hen2, *dz2, *dz1;  // encoder mode
  float *dx2, *dxacc;  // [N, H]
  float *nsum, *esum;  // column-sum partials: 5 node rows, 6 slot rows
  float* part;         // weight-gradient partials
  WS ws;
  WT wt;
};

size_t part_floats(int n, int e, int h, int enc) {
  size_t f = chunks(n) * 2 * (size_t)h * h;  // dW_sp, the widest
  const size_t fe = chunks(e) * (size_t)h * h;
  f = fe > f ? fe : f;
  if (enc) {
    const size_t f0 = chunks(e) * ENC_IN * ENC_HID;
    f = f0 > f ? f0 : f;
  }
  return f;
}

template <typename T>
size_t carve_bwd(unsigned char* base, int n, int e, int h, int enc,
                 BwdScratch<T>* s) {
  Carver c{base};
  const size_t nh = (size_t)n * h * sizeof(T), eh = (size_t)e * h * sizeof(T);
  T** node[] = {&s->sm, &s->agg, &s->g1, &s->x1, &s->b1, &s->dx2c,
                &s->dzb, &s->dx1c, &s->dzg, &s->daggc, &s->dsm, &s->rde1};
  for (T** q : node) *q = static_cast<T*>(c.take(nh));
  s->snode = static_cast<T*>(c.take(2 * nh));
  T** edge[] = {&s->e2, &s->dzm, &s->de2c, &s->de1};
  for (T** q : edge) *q = static_cast<T*>(c.take(eh));
  s->ein = s->deoc = s->hen1 = s->hen2 = s->dz2 = s->dz1 = nullptr;
  if (enc) {
    const size_t e128 = (size_t)e * ENC_HID * sizeof(T);
    s->ein = static_cast<T*>(c.take(eh));
    s->deoc = static_cast<T*>(c.take(eh));
    T** small[] = {&s->hen1, &s->hen2, &s->dz2, &s->dz1};
    for (T** q : small) *q = static_cast<T*>(c.take(e128));
  }
  s->dx2 = static_cast<float*>(c.take((size_t)n * h * 4));
  s->dxacc = static_cast<float*>(c.take((size_t)n * h * 4));
  s->nsum = static_cast<float*>(c.take(5 * blocks(n) * h * 4));
  s->esum = static_cast<float*>(c.take(6 * blocks(e) * h * 4));
  s->part = static_cast<float*>(c.take(part_floats(n, e, h, enc) * 4));
  carve_ws<T>(c, h, enc, false, &s->ws);
  carve_wt<T>(c, h, enc, &s->wt);
  return c.off;
}

// ---- the block -----------------------------------------------------------

template <typename T>
struct W {
  const T *wer, *wee, *wsp, *we1, *wpe, *wp1, *wg0, *wg1, *wb0, *wb1, *wen0,
      *wen1, *wen2;
};

// the pre-split of every weight that ``s`` holds a place for
template <typename T>
simple::WJobs ws_jobs(const W<T>& w, const WS& s, int h) {
  simple::WJobs js = {};
  auto job = [&](const T* b, int ldb, int k, int n, float* out) {
    if (out) simple::add_wjob<T>(&js, b, ldb, k, nullptr, 0, 0, n, out);
  };
  job(w.wsp, 2 * h, h, 2 * h, s.wsp);
  job(w.wer, h, h, h, s.wer);
  job(w.wee, h, h, h, s.wee);
  job(w.we1, h, h, h, s.we1);
  job(w.wpe, h, h, h, s.wpe);
  job(w.wp1, h, h, h, s.wp1);
  job(w.wg0, h, 2 * h, h, s.wg0);
  job(w.wg1, h, h, h, s.wg1);
  job(w.wb0, h, h, h, s.wb0);
  job(w.wb1, h, h, h, s.wb1);
  job(w.wen1, ENC_HID, ENC_HID, ENC_HID, s.wen1);
  job(w.wen2, h, ENC_HID, h, s.wen2);
  return js;
}

// the pre-split of every transposed weight that ``s`` holds a place for
template <typename T>
simple::WJobs wt_jobs(const W<T>& w, const WT& s, int h) {
  simple::WJobs js = {};
  auto job = [&](const T* b, int n, int k, float* out) {
    if (out) simple::add_wtjob<T>(&js, b, n, k, out, 0);
  };
  simple::add_wtjob<T>(&js, w.wer, h, h, s.wx, 0, w.wsp, 2 * h);
  job(w.wb1, h, h, s.wb1);
  job(w.wb0, h, h, s.wb0);
  job(w.wg1, h, h, s.wg1);
  job(w.wg0, 2 * h, h, s.wg0);
  job(w.wp1, h, h, s.wp1);
  job(w.wpe, h, h, s.wpe);
  job(w.we1, h, h, s.we1);
  job(w.wee, h, h, s.wee);
  job(w.wen2, ENC_HID, h, s.wen2);
  job(w.wen1, ENC_HID, ENC_HID, s.wen1);
  return js;
}

struct Geo {
  const int *send, *recv, *rlo, *rhi, *sorder, *soff;
  const float* cnt;
};

#define TRY(x)                               \
  do {                                       \
    cudaError_t err_ = (x);                  \
    if (err_ != cudaSuccess) return err_;    \
  } while (0)

// h1, h2 and e_in = T(h2 @ W_en2 + b10) of the encoder mode
template <typename T, class Pass>
cudaError_t encoder(const T* raw, const W<T>& w, const WS& ws,
                    const float* bias, T* h1, T* h2, T* ein, int e, int h,
                    cudaStream_t st) {
  TRY((enc_first<T, Pass>(raw, w.wen0, bias + 8 * h, h1, e, st)));
  Epi<T, Pass, E_OUTT> ep = {};
  ep.bias = bias + 9 * h;
  ep.relu = 1;
  ep.out_t = h2;
  TRY((wprod<T>(h1, ENC_HID, ENC_HID, ws.wen1, e, ENC_HID, ep, st)));
  ep = {};
  ep.bias = bias + 10 * h;
  ep.out_t = ein;
  return wprod<T>(h2, ENC_HID, ENC_HID, ws.wen2, e, h, ep, st);
}

// the node chain's agg, g1, x1 (and x1f) and b1 from sm
template <typename T, class Pass>
cudaError_t node_chain(const T* x, const T* sm, const WS& ws,
                       const float* bias, const float* cnt, T* agg, T* g1,
                       float* x1f, T* x1, T* b1, int n, int h,
                       cudaStream_t st) {
  // agg = T((sm @ W_p1 + cnt * b_p1) / max(cnt, 1))
  Epi<T, Pass, E_CNT | E_OUTT> ap = {};
  ap.cnt = cnt;
  ap.bias = bias + 3 * h;
  ap.out_t = agg;
  TRY((wprod<T>(sm, h, h, ws.wp1, n, h, ap, st)));
  // g1 = T(relu(x @ W_g0[:H] + agg @ W_g0[H:] + b_g0))
  Epi<T, Pass, E_OUTT> ep = {};
  ep.bias = bias + 4 * h;
  ep.relu = 1;
  ep.out_t = g1;
  TRY((wprod<T>(x, h, h, agg, h, h, ws.wg0, n, h, h, ep, st)));
  // x1f = g1 @ W_g1 + b_g1, x1 = T(x1f)
  Epi<T, Pass, E_OUTF | E_OUTT> xp = {};
  xp.bias = bias + 5 * h;
  xp.out_f = x1f;
  xp.out_t = x1;
  TRY((wprod<T>(g1, h, h, ws.wg1, n, h, xp, st)));
  // b1 = T(relu(x1 @ W_b0 + b_b0))
  ep = {};
  ep.bias = bias + 6 * h;
  ep.relu = 1;
  ep.out_t = b1;
  return wprod<T>(x1, h, h, ws.wb0, n, h, ep, st);
}

template <typename T>
struct FwdArgs {
  const T *x, *e_in;
  W<T> w;
  const float* bias;
  Geo geo;
  unsigned char* scratch;
  T *zx, *ze, *e1s, *m1s;
  int n, e, h, enc, skip;
  Drop d;
};

template <typename T>
cudaError_t fwd(const FwdArgs<T>& a, cudaStream_t st) {
  const int n = a.n, e = a.e, h = a.h;
  const W<T>& w = a.w;
  const float* bias = a.bias;
  FwdScratch<T> s;
  carve_fwd<T>(a.scratch, n, e, h, a.enc, &s);

  // pass 1: every weight pre-split, then p = T(x @ [W_sp | W_er]) [N, 3H]
  TRY((simple::wsplit<T, fwd_proj>(ws_jobs<T>(w, s.ws, h), st)));
  Epi<T, fwd_proj, E_OUTT> pp = {};
  pp.out_t = s.proj;
  TRY((wprod<T>(a.x, h, h, nullptr, 0, 0, s.ws.wsp, n, 2 * h, 3 * h, pp,
                st)));
  pp.out_t = s.proj + 2 * h;
  TRY((wprod<T>(a.x, h, h, nullptr, 0, 0, s.ws.wer, n, h, 3 * h, pp, st)));

  // pass 2: the edge chain
  const T* ein = a.e_in;
  if (a.enc) {
    TRY((encoder<T, fwd_edge>(a.e_in, w, s.ws, bias, s.h1, s.h2, s.ein, e, h,
                              st)));
    ein = s.ein;
  }
  // e1 = T(relu(e_in @ W_ee + p_r[recv] + p_s[send] + b_e0))
  Epi<T, fwd_edge, E_G0 | E_G1 | E_OUTT> ep = {};
  ep.g0 = s.proj + 2 * h;
  ep.ids0 = a.geo.recv;
  ep.ld0 = 3 * h;
  ep.g1 = s.proj;
  ep.ids1 = a.geo.send;
  ep.ld1 = 3 * h;
  ep.bias = bias;
  ep.relu = 1;
  ep.out_t = a.e1s;
  TRY((wprod<T>(ein, h, h, s.ws.wee, e, h, ep, st)));
  // e2f = e1 @ W_e1 + b_e1: e2 = T(e2f), ze = T(dropout(e2f (+ e_in)))
  Epi<T, fwd_edge, E_OUTT | E_OUT2> e2p = {};
  e2p.bias = bias + h;
  e2p.out_t = s.e2;
  e2p.skip = a.skip ? ein : nullptr;
  e2p.out2 = a.ze;
  e2p.d = a.d;
  TRY((wprod<T>(a.e1s, h, h, s.ws.we1, e, h, e2p, st)));
  // m1 = T(relu(e2 @ W_pe + p_p[send] + b_p0))
  Epi<T, fwd_edge, E_G1 | E_OUTT> mp = {};
  mp.g1 = s.proj + h;
  mp.ids1 = a.geo.send;
  mp.ld1 = 3 * h;
  mp.bias = bias + 2 * h;
  mp.relu = 1;
  mp.out_t = a.m1s;
  TRY((wprod<T>(s.e2, h, h, s.ws.wpe, e, h, mp, st)));

  // pass 3: the node chain; sm = T(each node's run of m1 rows)
  TRY((run_sums<T, fwd_node>(a.m1s, h, a.geo.rlo, a.geo.rhi, nullptr, s.sm, h,
                             n, h, st)));
  TRY((node_chain<T, fwd_node>(a.x, s.sm, s.ws, bias, a.geo.cnt, s.agg,
                               s.g1, s.x1f, s.x1, s.b1, n, h, st)));
  // zx = T(dropout(x1f + b1 @ W_b1 + b_b1 (+ x))), node rows E..E+N-1
  Epi<T, fwd_node, E_ADD | E_OUT2> np = {};
  np.bias = bias + 7 * h;
  np.add32 = s.x1f;
  np.skip = a.skip ? a.x : nullptr;
  np.out2 = a.zx;
  np.d = a.d;
  np.row0 = e;
  return wprod<T>(s.b1, h, h, s.ws.wb1, n, h, np, st);
}

template <typename T>
struct BwdArgs {
  const T *dzx, *dze, *e1s, *m1s, *x, *e_in;
  W<T> w;
  const float* bias;
  Geo geo;
  unsigned char* scratch;
  T *dx, *de_win;
  float *dwer, *dwee, *dwsp, *dwe1, *dwpe, *dwp1, *dwg0, *dwg1, *dwb0, *dwb1,
      *dwen0, *dwen1, *dwen2, *dbias;
  int n, e, h, enc, skip;
  Drop d;
};

template <typename T>
cudaError_t bwd(const BwdArgs<T>& a, cudaStream_t st) {
  const int n = a.n, e = a.e, h = a.h;
  const W<T>& w = a.w;
  const float* bias = a.bias;
  const Drop none = {};
  BwdScratch<T> s;
  carve_bwd<T>(a.scratch, n, e, h, a.enc, &s);
  const size_t nb = blocks(n) * h, ebk = blocks(e) * h;
  float* nsum[5];  // bias rows 3-7
  for (int i = 0; i < 5; ++i) nsum[i] = s.nsum + i * nb;
  float* esum[6];  // bias rows 0-2, 8-10
  for (int i = 0; i < 6; ++i) esum[i] = s.esum + i * ebk;

  // ---- pass 1: node side: the recomputed chain's weights and the
  // transposed weights pre-split, recompute sm, agg, g1, x1, b1 (on the
  // forward's tile: the same relu masks), then beta, gamma, the mean and
  // phi's second layer backward
  TRY((simple::wsplit<T, bwd_node1>(ws_jobs<T>(w, s.ws, h), st)));
  TRY((simple::wsplit<T, bwd_node1>(wt_jobs<T>(w, s.wt, h), st)));
  TRY((run_sums<T, bwd_node1>(a.m1s, h, a.geo.rlo, a.geo.rhi, nullptr, s.sm,
                              h, n, h, st)));
  // x1f is not needed: dxacc's buffer holds it until dxacc is written
  TRY((node_chain<T, bwd_node1>(a.x, s.sm, s.ws, bias, a.geo.cnt, s.agg,
                                s.g1, s.dxacc, s.x1, s.b1, n, h, st)));
  // dx2 = dropout(dz_x) (f32), dx2c = T(dx2); b_b1's column sums
  TRY((ew<T, bwd_node1>(a.dzx, nullptr, nullptr, a.d, e, s.dx2, s.dx2c,
                        nsum[4], n, h, st)));
  // dzb = T(where(b1 > 0, dx2c @ W_b1^T, 0)); b_b0
  Epi<T, bwd_node1, E_MASK | E_COLSUM | E_OUTT> mp = {};
  mp.mask = s.b1;
  mp.colsum = nsum[3];
  mp.out_t = s.dzb;
  TRY((wprod<T>(s.dx2c, h, h, s.wt.wb1, n, h, mp, st)));
  // dx1 = dx2 + dzb @ W_b0^T, dx1c = T(dx1); b_g1
  Epi<T, bwd_node1, E_ADD | E_COLSUM | E_OUTT> ap = {};
  ap.add32 = s.dx2;
  ap.colsum = nsum[2];
  ap.out_t = s.dx1c;
  TRY((wprod<T>(s.dzb, h, h, s.wt.wb0, n, h, ap, st)));
  // dzg = T(where(g1 > 0, dx1c @ W_g1^T, 0)); b_g0
  mp = {};
  mp.mask = s.g1;
  mp.colsum = nsum[1];
  mp.out_t = s.dzg;
  TRY((wprod<T>(s.dx1c, h, h, s.wt.wg1, n, h, mp, st)));
  // dzg @ W_g0^T in one launch: dxacc = its columns [0, H) (+ dx2 with the
  // skip), f32; dagg = its columns [H, 2H) / max(cnt, 1), daggc =
  // T(dagg); b_p1 sums cnt * dagg
  Epi<T, bwd_node1, E_ADD | E_OUTF> xp = {};
  xp.add32 = a.skip ? s.dx2 : nullptr;
  xp.out_f = s.dxacc;
  Epi<T, bwd_node1, E_CNT | E_COLSUM | E_OUTT> gp = {};
  gp.cnt = a.geo.cnt;
  gp.colsum = nsum[0];
  gp.cs_cnt = 1;
  gp.out_t = s.daggc;
  TRY((wprod<T>(s.dzg, h, h, nullptr, 0, 0, s.wt.wg0, n, 2 * h, h,
                Halves<decltype(xp), decltype(gp)>{xp, gp, h}, st)));
  // dsm = T(daggc @ W_p1^T)
  Epi<T, bwd_node1, E_OUTT> op = {};
  op.out_t = s.dsm;
  TRY((wprod<T>(s.daggc, h, h, s.wt.wp1, n, h, op, st)));

  // ---- pass 2: slot side
  const T* ein = a.e_in;
  if (a.enc) {
    TRY((encoder<T, bwd_edge>(a.e_in, w, s.ws, bias, s.hen1, s.hen2, s.ein, e,
                              h, st)));
    ein = s.ein;
  }
  // e2 = T(e1 @ W_e1 + b_e1), for dW_pe
  Epi<T, bwd_edge, E_OUTT> e2p = {};
  e2p.bias = bias + h;
  e2p.out_t = s.e2;
  TRY((wprod<T>(a.e1s, h, h, s.ws.we1, e, h, e2p, st)));
  // dzm = T(where(m1 > 0, dsm[recv], 0)); b_p0
  TRY((ew<T, bwd_edge>(s.dsm, a.geo.recv, a.m1s, none, 0, nullptr, s.dzm,
                       esum[2], e, h, st)));
  // de2 = dropout(dz_e) + dzm @ W_pe^T, de2c = T(de2); b_e1
  Epi<T, bwd_edge, E_DADD | E_COLSUM | E_OUTT> dp = {};
  dp.dadd = a.dze;
  dp.d = a.d;
  dp.colsum = esum[1];
  dp.out_t = s.de2c;
  TRY((wprod<T>(s.dzm, h, h, s.wt.wpe, e, h, dp, st)));
  // de1 = T(where(e1 > 0, de2c @ W_e1^T, 0)); b_e0
  Epi<T, bwd_edge, E_MASK | E_COLSUM | E_OUTT> ep = {};
  ep.mask = a.e1s;
  ep.colsum = esum[0];
  ep.out_t = s.de1;
  TRY((wprod<T>(s.de2c, h, h, s.wt.we1, e, h, ep, st)));
  // deo = de1 @ W_ee^T (+ dropout(dz_e) with the skip): de_win = T(deo),
  // or in encoder mode deoc = T(deo), b_en2, and the encoder's backward
  dp = {};
  dp.dadd = a.skip ? a.dze : nullptr;
  dp.d = a.d;
  if (a.enc) {
    dp.colsum = esum[5];
    dp.out_t = s.deoc;
  } else {
    dp.out_t = a.de_win;
  }
  TRY((wprod<T>(s.de1, h, h, s.wt.wee, e, h, dp, st)));
  if (a.enc) {
    // dz2 = T(where(h2 > 0, deoc @ W_en2^T, 0)) [E, 128]; b_en1
    ep = {};
    ep.mask = s.hen2;
    ep.colsum = esum[4];
    ep.out_t = s.dz2;
    TRY((wprod<T>(s.deoc, h, h, s.wt.wen2, e, ENC_HID, ep, st)));
    // dz1 = T(where(h1 > 0, dz2 @ W_en1^T, 0)); b_en0
    ep = {};
    ep.mask = s.hen1;
    ep.colsum = esum[3];
    ep.out_t = s.dz1;
    TRY((wprod<T>(s.dz2, ENC_HID, ENC_HID, s.wt.wen1, e, ENC_HID, ep, st)));
  }

  // ---- pass 3: the receiver and sender folds into dx
  TRY((run_sums<T, bwd_node2>(s.de1, h, a.geo.rlo, a.geo.rhi, nullptr, s.rde1,
                              h, n, h, st)));
  TRY((run_sums<T, bwd_node2>(s.de1, h, a.geo.soff, a.geo.soff + 1,
                              a.geo.sorder, s.snode, 2 * h, n, h, st)));
  TRY((run_sums<T, bwd_node2>(s.dzm, h, a.geo.soff, a.geo.soff + 1,
                              a.geo.sorder, s.snode + h, 2 * h, n, h, st)));
  // dx = T(r_de1 @ W_er^T + s @ W_sp^T + dxacc), one product on
  // [W_er^T; W_sp^T]
  Epi<T, bwd_node2, E_ADD | E_OUTT> dxp = {};
  dxp.add32 = s.dxacc;
  dxp.out_t = a.dx;
  TRY((wprod<T>(s.rde1, h, h, s.snode, 2 * h, 2 * h, s.wt.wx, n, h, h, dxp,
                st)));

  // ---- pass 4: the weight gradients and the bias rows
  struct Job {
    const T* a;
    int lda, m;
    const T* b;
    int ldb, nn, rows;
    float* dw;
  };
  const Job jobs[] = {
      {s.b1, h, h, s.dx2c, h, h, n, a.dwb1},
      {s.x1, h, h, s.dzb, h, h, n, a.dwb0},
      {s.g1, h, h, s.dx1c, h, h, n, a.dwg1},
      {a.x, h, h, s.dzg, h, h, n, a.dwg0},
      {s.agg, h, h, s.dzg, h, h, n, a.dwg0 + (size_t)h * h},
      {s.sm, h, h, s.daggc, h, h, n, a.dwp1},
      {a.x, h, h, s.rde1, h, h, n, a.dwer},
      {a.x, h, h, s.snode, 2 * h, 2 * h, n, a.dwsp},
      {s.e2, h, h, s.dzm, h, h, e, a.dwpe},
      {a.e1s, h, h, s.de2c, h, h, e, a.dwe1},
      {ein, h, h, s.de1, h, h, e, a.dwee},
      {s.hen2, ENC_HID, ENC_HID, s.deoc, h, h, e, a.dwen2},
      {s.hen1, ENC_HID, ENC_HID, s.dz2, ENC_HID, ENC_HID, e, a.dwen1},
  };
  const int n_jobs = a.enc ? 13 : 11;
  for (int i = 0; i < n_jobs; ++i) {
    const Job& j = jobs[i];
    TRY((simple::atb_rows<T, bwd_weights>(j.a, j.lda, j.m, j.b, j.ldb, j.nn,
                                          j.rows, CHUNK, s.part, j.dw, st)));
  }
  if (a.enc) {
    const int nz = (int)chunks(e);
    wen0_part_kernel<T, bwd_weights><<<nz, ENC_IN * ENC_HID, 0, st>>>(
        a.e_in, s.dz1, s.part, e);
    TRY(cudaGetLastError());
    simple::sum_parts_kernel<bwd_weights><<<(ENC_IN * ENC_HID + 255) / 256,
                                            256, 0, st>>>(
        s.part, a.dwen0, nz, (size_t)ENC_IN * ENC_HID);
    TRY(cudaGetLastError());
  }
  BiasParts bp = {};
  const int nbk = (int)blocks(n), ebn = (int)blocks(e);
  const float* rows[11] = {esum[0], esum[1], esum[2], nsum[0], nsum[1],
                           nsum[2], nsum[3], nsum[4], esum[3], esum[4],
                           esum[5]};
  const int n_rows = a.enc ? 11 : 8;
  for (int r = 0; r < n_rows; ++r) {
    const bool node = r >= 3 && r <= 7;
    bp.part[r] = rows[r];
    bp.blocks[r] = node ? nbk : ebn;
    bp.width[r] = (r == 8 || r == 9) ? ENC_HID : h;
  }
  bias_reduce_kernel<bwd_weights><<<dim3((h + 127) / 128, n_rows), 128, 0,
                                     st>>>(bp, a.dbias, h);
  return cudaGetLastError();
}

bool shapes_ok(int n, int e, int h) {
  return n > 0 && e > 0 && n % RB == 0 && h > 0 && h % 128 == 0;
}

template <typename T>
W<T> weights(const void* const* p) {
  return {static_cast<const T*>(p[0]),  static_cast<const T*>(p[1]),
          static_cast<const T*>(p[2]),  static_cast<const T*>(p[3]),
          static_cast<const T*>(p[4]),  static_cast<const T*>(p[5]),
          static_cast<const T*>(p[6]),  static_cast<const T*>(p[7]),
          static_cast<const T*>(p[8]),  static_cast<const T*>(p[9]),
          static_cast<const T*>(p[10]), static_cast<const T*>(p[11]),
          static_cast<const T*>(p[12])};
}

template <typename T>
int run_fwd(const void* x, const void* e_in, const void* const* w,
            const void* bias, const Geo& geo, void* scratch, void* zx,
            void* ze, void* e1s, void* m1s, int n, int e, int h, int enc,
            int skip, Drop d, cudaStream_t st) {
  FwdArgs<T> a;
  a.x = static_cast<const T*>(x);
  a.e_in = static_cast<const T*>(e_in);
  a.w = weights<T>(w);
  a.bias = static_cast<const float*>(bias);
  a.geo = geo;
  a.scratch = static_cast<unsigned char*>(scratch);
  a.zx = static_cast<T*>(zx);
  a.ze = static_cast<T*>(ze);
  a.e1s = static_cast<T*>(e1s);
  a.m1s = static_cast<T*>(m1s);
  a.n = n;
  a.e = e;
  a.h = h;
  a.enc = enc;
  a.skip = skip;
  a.d = d;
  return (int)fwd<T>(a, st);
}

template <typename T>
int run_bwd(const void* const* act, const void* const* w, const void* bias,
            const Geo& geo, void* scratch, void* dx, void* de_win,
            void* const* dw, void* dbias, int n, int e, int h, int enc,
            int skip, Drop d, cudaStream_t st) {
  BwdArgs<T> a;
  a.dzx = static_cast<const T*>(act[0]);
  a.dze = static_cast<const T*>(act[1]);
  a.e1s = static_cast<const T*>(act[2]);
  a.m1s = static_cast<const T*>(act[3]);
  a.x = static_cast<const T*>(act[4]);
  a.e_in = static_cast<const T*>(act[5]);
  a.w = weights<T>(w);
  a.bias = static_cast<const float*>(bias);
  a.geo = geo;
  a.scratch = static_cast<unsigned char*>(scratch);
  a.dx = static_cast<T*>(dx);
  a.de_win = static_cast<T*>(de_win);
  float** g[] = {&a.dwer, &a.dwee, &a.dwsp, &a.dwe1, &a.dwpe, &a.dwp1,
                 &a.dwg0, &a.dwg1, &a.dwb0, &a.dwb1, &a.dwen0, &a.dwen1,
                 &a.dwen2};
  for (int i = 0; i < 13; ++i) *g[i] = static_cast<float*>(dw[i]);
  a.dbias = static_cast<float*>(dbias);
  a.n = n;
  a.e = e;
  a.h = h;
  a.enc = enc;
  a.skip = skip;
  a.d = d;
  return (int)bwd<T>(a, st);
}

}  // namespace ea_simple

extern "C" long long ea_block_fwd_simple_scratch_bytes(int n, int e, int h,
                                                       int enc, int bf16_in) {
  if (bf16_in) {
    ea_simple::FwdScratch<ea_simple::bf16> s;
    return (long long)ea_simple::carve_fwd(nullptr, n, e, h, enc, &s);
  }
  ea_simple::FwdScratch<float> s;
  return (long long)ea_simple::carve_fwd(nullptr, n, e, h, enc, &s);
}

extern "C" long long ea_block_bwd_simple_scratch_bytes(int n, int e, int h,
                                                       int enc, int bf16_in) {
  if (bf16_in) {
    ea_simple::BwdScratch<ea_simple::bf16> s;
    return (long long)ea_simple::carve_bwd(nullptr, n, e, h, enc, &s);
  }
  ea_simple::BwdScratch<float> s;
  return (long long)ea_simple::carve_bwd(nullptr, n, e, h, enc, &s);
}

// the arguments of ea_block_fwd (ea_block_fwd.cu) without save_res (e1s is
// always written), and the element type
extern "C" int ea_block_fwd_simple(
    const void* x, const void* e_in, const void* wer, const void* wee,
    const void* wsp, const void* we1, const void* wpe, const void* wp1,
    const void* wg0, const void* wg1, const void* wb0, const void* wb1,
    const void* wen0, const void* wen1, const void* wen2, const void* bias,
    const void* send, const void* recv, const void* rlo, const void* rhi,
    const void* cnt, void* scratch, void* zx, void* ze, void* e1s, void* m1s,
    int n, int e, int h, int enc, int skip, int dropout, unsigned int thr,
    unsigned int s0, unsigned int s1, float scale, int bf16_in,
    void* stream) {
  if (!ea_simple::shapes_ok(n, e, h)) return (int)cudaErrorInvalidValue;
  const void* w[] = {wer, wee, wsp, we1, wpe, wp1, wg0,
                     wg1, wb0, wb1, wen0, wen1, wen2};
  ea_simple::Geo geo = {static_cast<const int*>(send),
                        static_cast<const int*>(recv),
                        static_cast<const int*>(rlo),
                        static_cast<const int*>(rhi), nullptr, nullptr,
                        static_cast<const float*>(cnt)};
  const simple::Drop d = {dropout, thr, s0, s1, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16_in ? ea_simple::run_fwd<ea_simple::bf16>(
                       x, e_in, w, bias, geo, scratch, zx, ze, e1s, m1s, n,
                       e, h, enc, skip, d, st)
                 : ea_simple::run_fwd<float>(x, e_in, w, bias, geo, scratch,
                                             zx, ze, e1s, m1s, n, e, h, enc,
                                             skip, d, st);
}

// the arguments of ea_block_bwd (ea_block_bwd.cu) and the element type
extern "C" int ea_block_bwd_simple(
    const void* dzx, const void* dze, const void* e1s, const void* m1s,
    const void* x, const void* e_in, const void* wer, const void* wee,
    const void* wsp, const void* we1, const void* wpe, const void* wp1,
    const void* wg0, const void* wg1, const void* wb0, const void* wb1,
    const void* wen0, const void* wen1, const void* wen2, const void* bias,
    const void* recv, const void* rlo, const void* rhi, const void* sorder,
    const void* soff, const void* cnt, void* scratch, void* dx, void* de_win,
    void* dwer, void* dwee, void* dwsp, void* dwe1, void* dwpe, void* dwp1,
    void* dwg0, void* dwg1, void* dwb0, void* dwb1, void* dwen0, void* dwen1,
    void* dwen2, void* dbias, int n, int e, int h, int enc, int skip,
    int dropout, unsigned int thr, unsigned int s0, unsigned int s1,
    float scale, int bf16_in, void* stream) {
  if (!ea_simple::shapes_ok(n, e, h)) return (int)cudaErrorInvalidValue;
  const void* act[] = {dzx, dze, e1s, m1s, x, e_in};
  const void* w[] = {wer, wee, wsp, we1, wpe, wp1, wg0,
                     wg1, wb0, wb1, wen0, wen1, wen2};
  void* dw[] = {dwer, dwee, dwsp, dwe1, dwpe, dwp1, dwg0,
                dwg1, dwb0, dwb1, dwen0, dwen1, dwen2};
  ea_simple::Geo geo = {nullptr,
                        static_cast<const int*>(recv),
                        static_cast<const int*>(rlo),
                        static_cast<const int*>(rhi),
                        static_cast<const int*>(sorder),
                        static_cast<const int*>(soff),
                        static_cast<const float*>(cnt)};
  const simple::Drop d = {dropout, thr, s0, s1, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16_in ? ea_simple::run_bwd<ea_simple::bf16>(
                       act, w, bias, geo, scratch, dx, de_win, dw, dbias, n,
                       e, h, enc, skip, d, st)
                 : ea_simple::run_bwd<float>(act, w, bias, geo, scratch, dx,
                                             de_win, dw, dbias, n, e, h, enc,
                                             skip, d, st);
}
