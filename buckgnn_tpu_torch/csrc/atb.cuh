// Weight-gradient products A^T @ B of the backward kernels, split over a
// fixed number of row chunks (split-K), and the fixed-order reductions of
// their partials and of per-block bias partials. Shared by
// sage_layer_bwd.cu (dW_l, dW_r, db_l) and ea_block_bwd.cu (every weight
// and bias gradient of the EA block). No float atomics: the partials are
// summed in a fixed order, so two runs give the same bits.
//
// The product pass on Hopper: a block owns a 128 x 128 tile of dW and one
// row chunk. Its producer warp streams 32-row slices of both operands by
// TMA (128-byte swizzle) through a ring of STAGES slices with mbarriers;
// A [M, I] and B [M, J] are row-major, so both are read MN-major: A^T by
// the wgmma descriptor's major-ness, not by a transposed copy. Two
// consumer warpgroups each issue wgmma m64n128k16 on 64 rows of the tile
// (64 f32 sums a thread) and store their sums as the chunk's partial.
// TMA fills zeros past the end of A and B, so ragged I, J (the encoder's
// 8 input lanes) and M need no masks; chunks are whole slices. Shared
// memory: 4 slices of 16 KB. Bound on an H100: operations (2 M I J per
// product) once the slices stream; a launch takes at most 8 products, so
// that its tensor maps stay within the 4 KB of kernel parameters.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace splitk {

typedef __nv_bfloat16 bf16;

constexpr int NWARP = 8;  // warps of the reduction kernels
constexpr int KSPLIT = 16;  // row chunks of a product
constexpr int TI = 128, TJ = 128, TK = 32;
constexpr int STAGES = 4;
constexpr int ATB_THREADS = 288;  // two consumer warpgroups, one producer warp
constexpr int SLICE = (TI + TJ) * TK * 2;  // bytes of a ring slice

// One product dw = A^T @ B: A [M, I] (lda), B [M, J] (ldb), I and J
// multiples of 8, dw [I, J] float32, and its partials part
// [KSPLIT, IP, JP] (I and J rounded up to 128) at float offset ``off`` of
// the launch's partials buffer.
struct Job {
  const bf16* a;
  const bf16* b;
  float* dw;
  float* part;
  size_t off;
  int lda, ldb, i, j, m, ip, jp;
};

constexpr int MAX_JOBS = 16;
constexpr int LAUNCH_JOBS = 8;

// the products of one launch
struct Jobs {
  Job job[MAX_JOBS];
  int n = 0;
  int ip_max = 0, jp_max = 0;
  size_t part_floats = 0;  // partials of all jobs

  // queue dw = A^T @ B; its partials follow the previous job's
  __host__ bool add(const bf16* a, int lda, int i, const bf16* b, int ldb,
                    int j, int m, float* dw) {
    if (n == MAX_JOBS) return false;
    Job& jb = job[n++];
    jb = {a, b, dw, nullptr, part_floats, lda, ldb, i, j, m,
          (i + TI - 1) / TI * TI, (j + TJ - 1) / TJ * TJ};
    part_floats += (size_t)KSPLIT * jb.ip * jb.jp;
    ip_max = jb.ip > ip_max ? jb.ip : ip_max;
    jp_max = jb.jp > jp_max ? jb.jp : jp_max;
    return true;
  }
};

// the kernel's view of up to LAUNCH_JOBS products
struct Launch {
  CUtensorMap a[LAUNCH_JOBS], b[LAUNCH_JOBS];
  float* part[LAUNCH_JOBS];
  int m[LAUNCH_JOBS], ip[LAUNCH_JOBS], jp[LAUNCH_JOBS];
};

// part[chunk, i, j] = sum over rows k of the chunk of A[k, i] * B[k, j],
// for job blockIdx.z / KSPLIT and chunk blockIdx.z % KSPLIT
__global__ void __launch_bounds__(ATB_THREADS, 2)
    atb_kernel(const __grid_constant__ Launch L) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + STAGES;
  unsigned char* ring = smem + 1024;
  const int job = blockIdx.z / KSPLIT;
  const int chunk = blockIdx.z % KSPLIT;
  const int i0 = blockIdx.x * TI;
  const int j0 = blockIdx.y * TJ;
  const int jp = L.jp[job];
  if (i0 >= L.ip[job] || j0 >= jp) return;
  const int M = L.m[job];
  const int kc = ((M + KSPLIT * TK - 1) / (KSPLIT * TK)) * TK;
  const int kb = chunk * kc;
  const int nk = max(0, (min(M, kb + kc) - kb + TK - 1) / TK);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], 8);
    }
    hop::fence_barrier_init();
  }
  __syncthreads();
  hop::Ring r;
  r.full = full;
  r.empty = empty;
  r.base = ring;
  r.stride = SLICE;
  r.stages = STAGES;
  if (threadIdx.x >= 256) {
    if (threadIdx.x == 256) {
      for (int s = 0; s < nk; ++s) {
        hop::mbar_wait(&r.empty[r.stage], r.phase ^ 1);
        uint64_t* f = &r.full[r.stage];
        hop::mbar_expect_tx(f, SLICE);
        unsigned char* slot = r.slot();
        const int k = kb + s * TK;
        for (int x = 0; x < TI / 64; ++x)
          hop::tma_load(slot + x * 4096, &L.a[job], f, i0 + 64 * x, k);
        for (int x = 0; x < TJ / 64; ++x)
          hop::tma_load(slot + TI * TK * 2 + x * 4096, &L.b[job], f,
                        j0 + 64 * x, k);
        r.advance();
      }
    }
    return;
  }
  const int wg = threadIdx.x / 128;
  float acc[TJ / 2];
#pragma unroll
  for (int q = 0; q < TJ / 2; ++q) acc[q] = 0.f;
  int prev = -1;
  hop::fence_regs(acc);
  for (int s = 0; s < nk; ++s) {
    hop::mbar_wait(&r.full[r.stage], r.phase);
    const uint32_t slot = hop::smem_u32(r.slot());
    const uint32_t a = slot + hop::mn_col(64 * wg);  // A^T rows 64 wg..
    const uint32_t b = slot + TI * TK * 2;
    hop::wg_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      hop::wgmma<1, 1>(acc, hop::desc_mn(a, kk), hop::desc_mn(b, kk), 1);
    hop::wg_commit();
    if (prev >= 0) {
      hop::wg_wait<1>();
      if (threadIdx.x % 32 == 0) hop::mbar_arrive(&r.empty[prev]);
    }
    prev = r.stage;
    r.advance();
  }
  hop::wg_wait<0>();
  hop::fence_regs(acc);
  const int lane = threadIdx.x % 32;
  const int row = i0 + 64 * wg + 16 * ((threadIdx.x / 32) % 4) + lane / 4;
  float* out = L.part[job] + (size_t)chunk * L.ip[job] * jp;
#pragma unroll
  for (int q = 0; q < TJ / 8; ++q)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(out + (size_t)(row + 8 * h) * jp + j0 +
                                 8 * q + 2 * (lane % 4)) =
          make_float2(acc[4 * q + 2 * h], acc[4 * q + 2 * h + 1]);
}

// dw[i * J + j] = sum over chunks in order of part[chunk, i, j], for job
// blockIdx.y
__global__ void atb_reduce_kernel(const __grid_constant__ Jobs jobs) {
  const Job& jb = jobs.job[blockIdx.y];
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= jb.i * jb.j) return;
  const int i = e / jb.j, j = e % jb.j;
  float s = 0.f;
  for (int k = 0; k < KSPLIT; ++k)
    s += jb.part[((size_t)k * jb.ip + i) * jb.jp + j];
  jb.dw[e] = s;
}

// every queued dw = A^T @ B in float32, through partials in ``part``
// (jobs.part_floats floats): one product launch per LAUNCH_JOBS products
// and one reduction launch. Each element's sum runs over the same chunks
// in the same order however the products are grouped into launches.
inline cudaError_t atb(Jobs jobs, float* part, cudaStream_t st) {
  const int smem = 2048 + STAGES * SLICE;
  cudaError_t err = cudaFuncSetAttribute(
      atb_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int ij_max = 0;
  for (int k0 = 0; k0 < jobs.n; k0 += LAUNCH_JOBS) {
    Launch L;
    int ip_max = 0, jp_max = 0;
    const int nj = jobs.n - k0 < LAUNCH_JOBS ? jobs.n - k0 : LAUNCH_JOBS;
    for (int k = 0; k < nj; ++k) {
      Job& jb = jobs.job[k0 + k];
      jb.part = part + jb.off;
      if (!hop::make_map(&L.a[k], jb.a, jb.i, jb.m, jb.lda, 64, 32) ||
          !hop::make_map(&L.b[k], jb.b, jb.j, jb.m, jb.ldb, 64, 32))
        return cudaErrorInvalidValue;
      L.part[k] = jb.part;
      L.m[k] = jb.m;
      L.ip[k] = jb.ip;
      L.jp[k] = jb.jp;
      ip_max = jb.ip > ip_max ? jb.ip : ip_max;
      jp_max = jb.jp > jp_max ? jb.jp : jp_max;
      ij_max = jb.i * jb.j > ij_max ? jb.i * jb.j : ij_max;
    }
    const dim3 grid(ip_max / TI, jp_max / TJ, KSPLIT * nj);
    atb_kernel<<<grid, ATB_THREADS, smem, st>>>(L);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  for (int k = 0; k < jobs.n; ++k)
    jobs.job[k].part = part + jobs.job[k].off;
  atb_reduce_kernel<<<dim3((ij_max + 255) / 256, jobs.n), 256, 0, st>>>(jobs);
  return cudaGetLastError();
}

// the output row of each bias slot
struct BiasRows {
  int r[8];
};

// dbias[rows.r[slot], c] = sum over blocks of sums[b, slot, c]: 8 warps each
// take every 8th block in order for 32 columns, then the 8 sums are added
// in warp order
__global__ void bias_reduce_kernel(const float* sums, int n_blocks, int nslot,
                                   BiasRows rows, int h, float* dbias) {
  __shared__ float acc[NWARP][32];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int slot = blockIdx.y;
  const int c = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (c < h)
    for (int b = warp; b < n_blocks; b += NWARP)
      s += sums[((size_t)b * nslot + slot) * h + c];
  acc[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && c < h) {
    float t = 0.f;
    for (int w = 0; w < NWARP; ++w) t += acc[w][lane];
    dbias[(size_t)rows.r[slot] * h + c] = t;
  }
}

// bias slots [0, n_out) of per-block sums [n_blocks, nslot, h] into their
// rows of dbias
inline cudaError_t bias_reduce(const float* sums, int n_blocks, int nslot,
                               int n_out, BiasRows rows, int h,
                               float* dbias, cudaStream_t st) {
  bias_reduce_kernel<<<dim3((h + 31) / 32, n_out), NWARP * 32, 0, st>>>(
      sums, n_blocks, nslot, rows, h, dbias);
  return cudaGetLastError();
}

}  // namespace splitk
