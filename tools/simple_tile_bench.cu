// C entry for tools/simple_tile_bench.py: the product tile of
// buckgnn_tpu_torch/csrc/simple.cuh alone, C[z] = op(A) @ op(B) in f32
// (split-K chunks of 2,048 rows for A^T, as the weight pass runs them).
// The weight tile (wtile.cuh) is timed through sage_simple.cu's own
// entries.
#include "../buckgnn_tpu_torch/csrc/simple.cuh"

template <typename T, bool TA, bool TB>
int run(const void* a, const void* b, void* c, int m, int n, int k, int lda,
        int ldb, cudaStream_t st) {
  simple::Gemm g = {};
  g.a0 = a;
  g.b0 = b;
  g.lda0 = lda;
  g.ldb0 = ldb;
  g.k0 = k;
  g.kchunk = TA ? 2048 : k;
  g.m = m;
  g.n = n;
  g.c = c;
  g.ldc = n;
  g.c_f32 = 1;
  g.zstride = (size_t)m * n;
  return (int)simple::gemm<T, TA, TB>(g, TA ? (k + 2047) / 2048 : 1, st);
}

template <typename T>
int run_t(const void* a, const void* b, void* c, int m, int n, int k, int lda,
          int ldb, int ta, int tb, cudaStream_t st) {
  if (ta) {
    return tb ? run<T, true, true>(a, b, c, m, n, k, lda, ldb, st)
              : run<T, true, false>(a, b, c, m, n, k, lda, ldb, st);
  }
  return tb ? run<T, false, true>(a, b, c, m, n, k, lda, ldb, st)
            : run<T, false, false>(a, b, c, m, n, k, lda, ldb, st);
}

extern "C" int tile_gemm(const void* a, const void* b, void* c, int m, int n,
                         int k, int lda, int ldb, int ta, int tb, int bf16_in,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16_in
             ? run_t<simple::bf16>(a, b, c, m, n, k, lda, ldb, ta, tb, st)
             : run_t<float>(a, b, c, m, n, k, lda, ldb, ta, tb, st);
}
