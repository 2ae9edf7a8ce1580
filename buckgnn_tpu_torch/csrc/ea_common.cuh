// The fused EA block's own pieces on the product engine (engine.cuh):
// the edge encoder's first layer, the receiver run sums and the row
// gathers by id. Rows gathered by id (projections, dsm, sender runs) come
// by cp.async 16-byte copies into a staging tile, issued before the product
// that hides them. Shared memory (H = 512): the edge passes take 3 ring
// slices and a 64 KB staging tile beside the row tile (224 KB of 227), the
// node passes 4 slices and their bias rows (208-224 KB).

#pragma once

#include "engine.cuh"

namespace ea {

using namespace eng;

constexpr int ENC_IN = 8;     // raw edge-feature lanes (zero-padded)
constexpr int ENC_HID = 128;  // the edge encoder's padded hidden width

// rows r < 64 of the tile (and of g, global [., ld] at column col0, when
// given) = bf16 of the f32 sum, in order, of the src rows (ld_src, from
// column src_col) listed by the run: rows ids[k] for k in [lo, hi) (ids
// null: rows k themselves). lo/hi per block row; 8-column chunks, a warp
// per row.
template <int H>
__device__ __forceinline__ void run_sums(unsigned char* tile, bf16* g, int ld,
                                         int col0, const bf16* src,
                                         int ld_src, int src_col,
                                         const int* lo, const int* hi,
                                         const int* ids, int row0,
                                         int nvalid) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int NC = H / 8;
  for (int r = warp; r < BM; r += NCONS / 32) {
    const int rr = row_or0(row0, r, nvalid);
    const int lo_r = lo[rr], hi_r = hi[rr];
    const int a = r < nvalid ? lo_r : 0;
    const int b = r < nvalid ? hi_r : 0;
#pragma unroll
    for (int u = 0; u < (NC + 31) / 32; ++u) {
      const int ch = lane + 32 * u;
      if (ch >= NC) break;
      float acc[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = 0.f;
#pragma unroll 4
      for (int k = a; k < b; ++k) {
        const int row = ids ? __ldg(ids + k) : k;
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(
            src + (size_t)row * ld_src + src_col + ch * 8));
        const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[2 * j] += __bfloat162float(p[j].x);
          acc[2 * j + 1] += __bfloat162float(p[j].y);
        }
      }
      uint4 o;
      __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
      for (int j = 0; j < 4; ++j) q[j] = __floats2bfloat162_rn(acc[2 * j], acc[2 * j + 1]);
      *reinterpret_cast<uint4*>(tile + tile_off(r, ch * 8)) = o;
      if (g && r < nvalid)
        *reinterpret_cast<uint4*>(g + (size_t)(row0 + r) * ld + col0 + ch * 8) = o;
    }
  }
}

// cp.async: tile rows r < 64 = src rows ids[r] (ld, from column col0), H
// columns; zero rows where ids[r] < 0. Committed, not waited.
template <int H>
__device__ __forceinline__ void gather_rows(unsigned char* tile,
                                            const bf16* src, int ld, int col0,
                                            const int* ids) {
  constexpr int NC = H / 8;
  for (int i = threadIdx.x; i < BM * NC; i += NCONS) {
    const int r = i / NC, ch = i % NC;
    const int id = ids[r];
    hop::cp16(tile + tile_off(r, ch * 8),
              src + (size_t)(id < 0 ? 0 : id) * ld + col0 + ch * 8, id >= 0);
  }
  hop::cp_commit();
}

// h1 = relu(raw @ wen0 + b8), the edge encoder's first layer (K = 8, f32
// FMAs in k order) in the layout of a width-HW warpgroup: the thread's two
// raw rows come in one 16-byte load each (zeros past nvalid)
template <int HW>
__device__ __forceinline__ void encoder_first(float (&h)[HW / 2],
                                              const bf16* raw, int f0,
                                              int nvalid, const bf16* wen0,
                                              const float* b8, const Thr& t) {
  float x[2][ENC_IN];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = t.r0 + 8 * hh;
    const bool ok = r < nvalid;
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(
        raw + (size_t)(ok ? f0 + r : 0) * ENC_IN));
    const uint32_t* u = reinterpret_cast<const uint32_t*>(&v);
#pragma unroll
    for (int k = 0; k < ENC_IN / 2; ++k) {
      const float2 f = unpack(u[k]);
      x[hh][2 * k] = ok ? f.x : 0.f;
      x[hh][2 * k + 1] = ok ? f.y : 0.f;
    }
  }
  pairs<HW>(t, [&](int i, int r, int c) {
    const float* xr = x[(i / 2) % 2];
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int k = 0; k < ENC_IN; ++k) {
      const float2 w = ld2(wen0 + k * ENC_HID + c);
      s0 += xr[k] * w.x;
      s1 += xr[k] * w.y;
    }
    const float2 b = __ldg(reinterpret_cast<const float2*>(b8 + c));
    h[i] = fmaxf(s0 + b.x, 0.f);
    h[i + 1] = fmaxf(s1 + b.y, 0.f);
  });
}

}  // namespace ea
