// Weight-gradient products A^T @ B of the backward kernels, split over a
// fixed number of row chunks (split-K), and the fixed-order reductions of
// their partials and of per-block bias partials. Shared by
// sage_layer_bwd.cu (dW_l, dW_r, db_l) and ea_block_bwd.cu (every weight
// and bias gradient of the EA block). No float atomics: the partials are
// summed in a fixed order, so two runs give the same bits.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace splitk {

typedef __nv_bfloat16 bf16;

constexpr int NWARP = 8;
constexpr int NTHREADS = NWARP * 32;
constexpr int KSPLIT = 16;  // row chunks of a product
constexpr int TI = 128, TJ = 128, TK = 32;

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

// part[chunk, i, j] = sum over rows k of the chunk of A[k, i] * B[k, j],
// for job blockIdx.z / KSPLIT and chunk blockIdx.z % KSPLIT. Blocks of 8
// warps own a 128 x 128 tile; K-steps of 32 rows are staged in shared
// memory with 16-byte loads. EDGES: some job has a partial tile (I or J
// not a multiple of 128) or a partial K-step (M not a multiple of 32),
// whose loads are masked to zeros.
template <bool EDGES>
__global__ void __launch_bounds__(NTHREADS) atb_kernel(
    const __grid_constant__ Jobs jobs) {
  using namespace nvcuda;
  __shared__ __align__(128) bf16 sa[TK][TI + 8];
  __shared__ __align__(128) bf16 sb[TK][TJ + 8];
  const Job& jb = jobs.job[blockIdx.z / KSPLIT];
  const int chunk = blockIdx.z % KSPLIT;
  const int i0 = blockIdx.x * TI;
  const int j0 = blockIdx.y * TJ;
  if (i0 >= jb.ip || j0 >= jb.jp) return;
  const bf16* A = jb.a;
  const bf16* B = jb.b;
  const int I = jb.i, J = jb.j, M = jb.m, lda = jb.lda, ldb = jb.ldb;
  const int jp = jb.jp;
  const int kc = ((M + KSPLIT * TK - 1) / (KSPLIT * TK)) * TK;
  const int kb = chunk * kc;
  const int ke = min(M, kb + kc);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wi = warp / 4;  // 2 x 4 warps, each 64 x 32
  const int wj = warp % 4;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  for (int k0 = kb; k0 < ke; k0 += TK) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int el = (tid + u * NTHREADS) * 8;  // 8 bf16 per 16-byte load
      const int r = el / TI;
      const int c = el % TI;
      uint4 va = make_uint4(0, 0, 0, 0), vb = make_uint4(0, 0, 0, 0);
      if (!EDGES || k0 + r < ke) {
        if (!EDGES || i0 + c < I)
          va = *reinterpret_cast<const uint4*>(A + (size_t)(k0 + r) * lda +
                                               i0 + c);
        if (!EDGES || j0 + c < J)
          vb = *reinterpret_cast<const uint4*>(B + (size_t)(k0 + r) * ldb +
                                               j0 + c);
      }
      *reinterpret_cast<uint4*>(&sa[r][c]) = va;
      *reinterpret_cast<uint4*>(&sb[r][c]) = vb;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; kk += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], &sb[kk][wj * 32 + j * 16], TJ + 8);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // A^T(i, k) = sa[k][i]: column-major with leading dimension TI + 8
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
        wmma::load_matrix_sync(a, &sa[kk][wi * 64 + i * 16], TI + 8);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a, b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
  float* out = jb.part + (size_t)chunk * jb.ip * jp;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(
          out + (size_t)(i0 + wi * 64 + i * 16) * jp + j0 + wj * 32 + j * 16,
          acc[i][j], jp, wmma::mem_row_major);
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
// (jobs.part_floats floats): two launches for all of them. Each element's
// sum runs over the same chunks in the same order however the products
// are grouped into launches.
inline cudaError_t atb(Jobs jobs, float* part, cudaStream_t st) {
  int ij_max = 0;
  bool edges = false;
  for (int k = 0; k < jobs.n; ++k) {
    Job& jb = jobs.job[k];
    jb.part = part + jb.off;
    ij_max = jb.i * jb.j > ij_max ? jb.i * jb.j : ij_max;
    edges |= jb.i % TI != 0 || jb.j % TJ != 0 || jb.m % TK != 0;
  }
  const dim3 grid(jobs.ip_max / TI, jobs.jp_max / TJ, KSPLIT * jobs.n);
  if (edges)
    atb_kernel<true><<<grid, NTHREADS, 0, st>>>(jobs);
  else
    atb_kernel<false><<<grid, NTHREADS, 0, st>>>(jobs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
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
  bias_reduce_kernel<<<dim3((h + 31) / 32, n_out), NTHREADS, 0, st>>>(
      sums, n_blocks, nslot, rows, h, dbias);
  return cudaGetLastError();
}

}  // namespace splitk
