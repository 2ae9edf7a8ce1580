// Hopper (sm_90a) building blocks of the port's products: mbarriers, TMA
// tensor copies (plain and multicast to a 2-block cluster), wgmma with its
// shared-memory descriptors, cp.async row copies, 1-D bulk copies, named
// barriers and the host-side tensor maps. Used by the product engine
// (engine.cuh), the split-K weight pass (atb.cuh), the 3xTF32 product tiles
// (simple.cuh, wtile.cuh) and the float32 band kernel (sage_simple.cu).
//
// Layout: operand tiles in shared memory come in slices 32 bf16 deep along
// K, in one of two swizzles:
//  - K-major (A tiles, and B = W^T read from W [n, k]), 64-byte swizzle
//    (CU_TENSOR_MAP_SWIZZLE_64B): a slice is [rows, 32] with 64-byte rows;
//    element (r, k) sits at r * 64 + ((k / 8) ^ ((r >> 1) & 3)) * 16 + (k %
//    8) * 2. Descriptor: SBO 512 (8 rows), LBO unused; the second k16 step
//    starts 32 bytes in.
//  - MN-major (B = W read from W [k, n], and the weight pass's A^T),
//    128-byte swizzle: a slice is 64-column chunks of [32 k, 64 n] (4 KB
//    each, half as many TMA boxes as 64-byte rows would take), k-rows of
//    128 bytes. Descriptor: LBO 4096 (next chunk of 64 along M or N), SBO
//    1024 (next 8 k-rows); the second k16 step starts 2048 bytes in, and
//    columns 32-63 of a chunk 64 bytes in (the swizzle is a function of
//    the address, so TMA's and wgmma's agree).
// Epilogues that write a K-major tile from registers use `sw64`.
// tf32 operands (the 3xTF32 tiles of simple.cuh and wtile.cuh): wgmma
// takes them K-major only, here in the 128-byte swizzle: a slice is [rows,
// 32] tf32 with 128-byte rows; element (r, k) sits at r * 128 + ((k / 4) ^
// (r & 7)) * 16 + (k % 4) * 4 (`sw128`), as a TMA box of 32 f32 wide lands
// with CU_TENSOR_MAP_SWIZZLE_128B (`make_map_f32`). Descriptor: SBO 1024 (8
// rows), LBO unused; each k8 step starts 32 bytes further in. A may come
// from registers instead (`wgmma_tf32_rs_n128`, RS mode). An operand read
// transposed (wtile.cuh's A^T) comes in row-major boxes of [32 k, 128
// bytes] in the same swizzle, k-rows of 128 bytes: element (k, m) at k *
// 128 + ((m * size / 16) ^ (k & 7)) * 16 + (m * size) % 16 (`make_map_f32`
// with a 32-row box, or `make_map` with a 64-wide bf16 box).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace hop {

typedef __nv_bfloat16 bf16;

// byte offset of element (r, k) in a K-major 64-byte-swizzled slice
__host__ __device__ constexpr uint32_t sw64(int r, int k) {
  return (uint32_t)(r * 64 + (((k >> 3) ^ ((r >> 1) & 3)) << 4) + (k & 7) * 2);
}

// byte offset of the 16-byte chunk ``c`` (tf32 k = 4c..4c+3) of row ``r``
// in a K-major 128-byte-swizzled tf32 slice
__host__ __device__ constexpr uint32_t sw128(int r, int c) {
  return (uint32_t)(r * 128 + ((c ^ (r & 7)) << 4));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// ---- mbarriers ---------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// arrive on the barrier at the same offset in cluster block ``cta``
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar,
                                                    uint32_t cta) {
  asm volatile(
      "{\n.reg .b32 ra;\n"
      "mapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\n}" ::"r"(
          smem_u32(bar)),
      "r"(cta)
      : "memory");
}

__device__ __forceinline__ uint64_t globaltimer() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t addr, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}"
      : "=r"(ok)
      : "r"(addr), "r"(parity)
      : "memory");
  return ok != 0;
}

// wait until the phase of parity ``parity`` has completed. A wait longer
// than 4 s is a fault of the kernel (a lost arrival or copy): trap, so that
// the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  if (mbar_try_wait(a, parity)) return;
  const uint64_t t0 = globaltimer();
  while (!mbar_try_wait(a, parity))
    if (globaltimer() - t0 > 4000000000ull) __trap();
}

// ---- clusters -------------------------------------------------------------
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;" ::
          : "memory");
}

// ---- TMA --------------------------------------------------------------------
// 2-D box at coordinates (c0 inner, c1 outer) into this block's shared memory
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// the same box into the same offset of every block in ``mask`` of the
// cluster, each block's barrier at the same offset told of its bytes
__device__ __forceinline__ void tma_load_mc(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes.multicast::cluster [%0], [%1, {%4, %5}], [%2], %3;" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "h"(mask),
      "r"(c0), "r"(c1)
      : "memory");
}

// ``bytes`` (a multiple of 16) contiguous bytes from device memory at
// ``src`` into this block's shared memory at ``dst`` (both 16-byte
// aligned), the barrier told of them: a 1-D bulk copy (the band kernel's
// slab rows)
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---- prefetches ------------------------------------------------------------
// the 128-byte lines [p, p + bytes) into L1 (i0, stride: this thread's
// share of the lines)
__device__ __forceinline__ void prefetch_l1(const void* p, int bytes, int i0,
                                            int stride) {
  for (int i = i0; i < bytes / 128; i += stride)
    asm volatile("prefetch.global.L1 [%0];" ::"l"(
        static_cast<const char*>(p) + (size_t)i * 128));
}

// the same into L2
__device__ __forceinline__ void prefetch_l2(const void* p, size_t bytes,
                                            int i0, int stride) {
  for (size_t i = i0; i < bytes / 128; i += stride)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(
        static_cast<const char*>(p) + i * 128));
}

// ---- cp.async (row gathers) ------------------------------------------------
// 16 bytes from src to shared dst; zeros when ``valid`` is false
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// generic-proxy writes to shared memory (st.shared, cp.async) made visible
// to the async proxy (wgmma, TMA)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int nthreads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(nthreads) : "memory");
}

// ---- wgmma --------------------------------------------------------------------
// descriptor layout types
constexpr uint64_t SW128_MODE = 1;  // 128-byte swizzle
constexpr uint64_t SW64_MODE = 2;   // 64-byte swizzle

// shared-memory matrix descriptor: start address, leading and stride byte
// offsets, swizzle
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, uint64_t mode) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (mode << 62);
}

// descriptor of a K-major slice at addr (k16 step ``kk``)
__device__ __forceinline__ uint64_t desc_k(uint32_t addr, int kk) {
  return desc(addr + kk * 32, 16, 512, SW64_MODE);
}

// descriptor of an MN-major slice at addr (k16 step ``kk``)
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr, int kk) {
  return desc(addr + kk * 2048, 4096, 1024, SW128_MODE);
}

// descriptor of a K-major 128-byte-swizzled tf32 slice at addr (k8 step
// ``kk``)
__device__ __forceinline__ uint64_t desc_k128(uint32_t addr, int kk) {
  return desc(addr + kk * 32, 16, 1024, SW128_MODE);
}

// byte offset of column (M or N) ``c`` in an MN-major slice
__host__ __device__ constexpr uint32_t mn_col(int c) {
  return (uint32_t)((c / 64) * 4096 + (c % 64) * 2);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// the warpgroup's register budget, raised (consumers) or lowered (the
// producer); a single if/else per role keeps ptxas from ignoring it
template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}

// keep the compiler from moving accumulator reads or writes across the
// asynchronous products (before the first and after the last wait only:
// inside the pipeline it would serialise the wgmmas)
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d[16] (+)= A[64, 16] @ B[16, 32]: bf16 in, f32 sums; scale_d 0
// overwrites d. TA / TB: 1 for an MN-major operand, 0 for K-major.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// d[32] (+)= A[64, 16] @ B[16, 64]: bf16 in, f32 sums; scale_d 0
// overwrites d. TA / TB: 1 for an MN-major operand, 0 for K-major.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// d[64] (+)= A[64, 16] @ B[16, 128]: bf16 in, f32 sums; scale_d 0
// overwrites d. TA / TB: 1 for an MN-major operand, 0 for K-major.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// d[128] (+)= A[64, 16] @ B[16, 256]: bf16 in, f32 sums; scale_d 0
// overwrites d. TA / TB: 1 for an MN-major operand, 0 for K-major.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}


// d (+)= A[64, 16] @ B[16, 2R]
template <int TA, int TB, int R>
__device__ __forceinline__ void wgmma(float (&d)[R], uint64_t da, uint64_t db,
                                      int scale_d) {
  if constexpr (R == 16)
    wgmma_n32<TA, TB>(d, da, db, scale_d);
  else if constexpr (R == 32)
    wgmma_n64<TA, TB>(d, da, db, scale_d);
  else if constexpr (R == 64)
    wgmma_n128<TA, TB>(d, da, db, scale_d);
  else
    wgmma_n256<TA, TB>(d, da, db, scale_d);
}

// d[64] (+)= A[64, 8] @ B[8, 128]: tf32 in (both K-major), f32 sums;
// scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[64], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64] (+)= A[64, 8] @ B[8, 128]: tf32 in, A from registers (a: this
// thread's fragment, rows 16 w + l / 4 (+ 8) of warp w, lane l, at depths
// l % 4 (a[0], a[1]) and l % 4 + 4 (a[2], a[3]); tf32 bits in b32), B K-major
// in shared memory; scale_d 0 overwrites d. The registers of ``a`` are read
// after the call returns: they stay unchanged until wg_wait (fence_regs).
__device__ __forceinline__ void wgmma_tf32_rs_n128(float (&d)[64],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %68, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %69, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d), "l"(db));
}

// the tf32 value nearest x (ties away from zero), in f32 bits with the low
// 13 zero: the hi or lo part of a 3xTF32 operand
__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// ---- the weight ring -----------------------------------------------------
// STAGES slices in shared memory, each with a "full" barrier (the producer's
// expect_tx and the TMA bytes) and an "empty" barrier (one arrival from
// each consumer warp of every block that reads the slice). Producer and
// consumers walk the same sequence of slices; the phase flips at each wrap.
struct Ring {
  uint64_t* full;
  uint64_t* empty;
  unsigned char* base;  // slice 0
  uint32_t stride;      // bytes per slice
  int stages;
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ unsigned char* slot() const {
    return base + (size_t)stage * stride;
  }
  __device__ __forceinline__ void advance() {
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// ---- host: tensor maps ----------------------------------------------------
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    if (lib) fn = (EncodeTiled)dlsym(lib, "cuTensorMapEncodeTiled");
  }
  return fn;
}

// a 2-D bf16 tensor map over rows of ``inner`` elements (row stride ``ld``
// elements, ``outer`` rows), boxes of [box_outer, box_inner] with the
// 64-byte swizzle (box_inner 32) or the 128-byte one (box_inner 64); reads
// past the end fill zeros. False on failure.
inline bool make_map(CUtensorMap* map, const void* ptr, int inner, int outer,
                     int ld, int box_inner, int box_outer) {
  EncodeTiled fn = encode_fn();
  if (!fn) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            box_inner == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                            : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a 2-D f32 tensor map over rows of ``inner`` elements (``outer`` rows,
// row stride ``ld`` elements), boxes of [box_outer, 32] with the 128-byte
// swizzle: a box lands K-major as sw128 lays out a tf32 slice; reads past
// the end fill zeros. False on failure.
inline bool make_map_f32(CUtensorMap* map, const float* ptr, int inner,
                         int outer, int ld, int box_outer) {
  EncodeTiled fn = encode_fn();
  if (!fn) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 4};
  const cuuint32_t box[2] = {32, (cuuint32_t)box_outer};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(ptr),
            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a 2-D byte tensor map (int8 rows of ``inner`` bytes, ``outer`` rows, the
// row stride ``inner``), boxes of [box_outer, box_inner] without a swizzle
// (a box lands as box_outer rows of box_inner bytes); reads past the end
// fill zeros. False on failure.
inline bool make_map_bytes(CUtensorMap* map, const void* ptr, int inner,
                           int outer, int box_inner, int box_outer) {
  EncodeTiled fn = encode_fn();
  if (!fn) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr),
            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hop
