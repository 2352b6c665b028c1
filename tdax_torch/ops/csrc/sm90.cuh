// Hopper (sm_90a) building blocks shared by the port's kernels.
//
// - mbarrier: init, arrive, arrive with an expected transaction count,
//   wait on a phase parity;
// - TMA: 2-D and 4-D tiled loads into shared memory that complete on an
//   mbarrier, 2-D and 4-D tiled stores from shared memory, and the host-side
//   encoding of tensor maps (a 4-D bf16 one and a 2-D one of any element
//   type; cuTensorMapEncodeTiled, fetched from the driver through the
//   runtime's cudaGetDriverEntryPointByVersion, so the library links no
//   -lcuda);
// - wgmma: the shared-memory matrix descriptor for 128-byte swizzled
//   tiles, fence / commit / wait, and the bf16 and tf32 products with f32
//   accumulators that the kernels use;
// - setmaxnreg, named barriers and the async-proxy fence.
//
// A tile loaded by TMA with CU_TENSOR_MAP_SWIZZLE_128B holds rows of 64
// bf16 (128 bytes); eight rows form a 1024-byte swizzle atom, and a tile
// must start on a 1024-byte boundary.  A wider row arrives as several
// 64-column boxes, one tile region each.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------ mbarrier ---

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// after the inits, before any thread uses the barriers
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// one arrival, and `bytes` more to come by TMA before the phase completes
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.  A fresh barrier
// is in phase 0: waiting on parity 1 returns at once, on parity 0 it
// blocks until the first phase completes.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// ----------------------------------------------------------------- TMA ---

// box at coordinates (c0 innermost .. c3) into shared memory; completes
// its bytes on `bar`.  Out-of-bounds elements arrive as zeros.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// box at coordinates (c0 innermost, c1) into shared memory; completes its
// bytes on `bar`.  Out-of-bounds elements arrive as zeros.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// fetch a tensor map into the cache before its first use
__device__ __forceinline__ void prefetch_tensormap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// shared memory to the box at (c0 .. c3); elements out of bounds are not
// written.  Commit, then wait before the shared memory is reused or the
// block exits.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// shared memory to the box at (c0 innermost, c1), as tma_store_4d
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_store_commit_and_wait() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// generic-proxy writes to shared memory made visible to TMA / wgmma
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_barrier_sync(uint32_t id, uint32_t threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_barrier_arrive(uint32_t id, uint32_t threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---------------------------------------------------------- setmaxnreg ---

template <uint32_t REGS>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

template <uint32_t REGS>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

// --------------------------------------------------------------- wgmma ---

// Matrix descriptor of a 128-byte swizzled operand at shared address
// `addr` (inside a 1024-aligned tile).  K-major (the reduction dimension
// contiguous): sbo = 1024, the stride of 8-row groups; lbo unused.  MN-major
// (read with the transpose bit): lbo = the stride between 64-element
// chunks of the MN dimension, sbo = 1024 between groups of 8 K rows.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// pins registers in place between volatile asm statements: keeps reads of
// an accumulator after a wait, and writes of an operand before a fence
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define SM90_ACC8(d, i)                                                                    \
  "+f"(d[i + 0]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),          \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

#define SM90_OUT8(d, i)                                                                    \
  "=f"(d[i + 0]), "=f"(d[i + 1]), "=f"(d[i + 2]), "=f"(d[i + 3]), "=f"(d[i + 4]),          \
      "=f"(d[i + 5]), "=f"(d[i + 6]), "=f"(d[i + 7])

#define SM90_M64N128K16_SS(acc, zero)                                                      \
  asm volatile(                                                                            \
      "{\n"                                                                                \
      ".reg .pred p;\n"                                                                    \
      "setp.ne.b32 p, %66, 0;\n"                                                           \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "                             \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "            \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "   \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "   \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "  \
      "%64, %65, p, 1, 1, 0, 0;\n"                                                         \
      "}\n"                                                                                \
      : acc(d, 0), acc(d, 8), acc(d, 16), acc(d, 24), acc(d, 32), acc(d, 40), acc(d, 48),  \
        acc(d, 56)                                                                         \
      : "l"(da), "l"(db), "r"(zero ? 0 : 1))

// d[64] = A[64 x 16] B[16 x 128]: A and B from shared memory, both
// K-major.  Writes d without reading it, so the compiler keeps no old
// value of d alive across the product.
__device__ __forceinline__ void wgmma_m64n128k16_ss_first(float (&d)[64], uint64_t da,
                                                          uint64_t db) {
  SM90_M64N128K16_SS(SM90_OUT8, true);
}

// d[64] += A[64 x 16] B[16 x 128], as above
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t da, uint64_t db) {
  SM90_M64N128K16_SS(SM90_ACC8, false);
}

#undef SM90_M64N128K16_SS

#define SM90_M64N128K16_SS_TB(acc, zero)                                                   \
  asm volatile(                                                                            \
      "{\n"                                                                                \
      ".reg .pred p;\n"                                                                    \
      "setp.ne.b32 p, %66, 0;\n"                                                           \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "                             \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "            \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "   \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "   \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "  \
      "%64, %65, p, 1, 1, 0, 1;\n"                                                         \
      "}\n"                                                                                \
      : acc(d, 0), acc(d, 8), acc(d, 16), acc(d, 24), acc(d, 32), acc(d, 40), acc(d, 48),  \
        acc(d, 56)                                                                         \
      : "l"(da), "l"(db), "r"(zero ? 0 : 1))

// d[64] = A[64 x 16] B[16 x 128]: A and B from shared memory, A K-major,
// B MN-major (the transpose bit; qmm_sm90.cu's bf16 weight tile [K rows,
// N contiguous]).  Writes d without reading it.
__device__ __forceinline__ void wgmma_m64n128k16_ss_tb_first(float (&d)[64], uint64_t da,
                                                             uint64_t db) {
  SM90_M64N128K16_SS_TB(SM90_OUT8, true);
}

// d[64] += A[64 x 16] B[16 x 128], as above
__device__ __forceinline__ void wgmma_m64n128k16_ss_tb(float (&d)[64], uint64_t da, uint64_t db) {
  SM90_M64N128K16_SS_TB(SM90_ACC8, false);
}

#undef SM90_M64N128K16_SS_TB

#define SM90_M64N64K16_SS(acc, zero)                                                       \
  asm volatile(                                                                            \
      "{\n"                                                                                \
      ".reg .pred p;\n"                                                                    \
      "setp.ne.b32 p, %34, 0;\n"                                                           \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "                              \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "            \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "  \
      "%32, %33, p, 1, 1, 0, 0;\n"                                                         \
      "}\n"                                                                                \
      : acc(d, 0), acc(d, 8), acc(d, 16), acc(d, 24)                                       \
      : "l"(da), "l"(db), "r"(zero ? 0 : 1))

// d[32] = A[64 x 16] B[16 x 64]: A and B from shared memory, both K-major
// (the backward's S = Q K^T and dP = dO V^T over 64-key or 64-row tiles).
// Writes d without reading it.
__device__ __forceinline__ void wgmma_m64n64k16_ss_first(float (&d)[32], uint64_t da,
                                                         uint64_t db) {
  SM90_M64N64K16_SS(SM90_OUT8, true);
}

// d[32] += A[64 x 16] B[16 x 64], as above
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t da, uint64_t db) {
  SM90_M64N64K16_SS(SM90_ACC8, false);
}

#undef SM90_M64N64K16_SS

// tf32 takes no transpose bits: both operands are K-major.
#define SM90_M64N128K8_TF32_SS(acc, zero)                                                  \
  asm volatile(                                                                            \
      "{\n"                                                                                \
      ".reg .pred p;\n"                                                                    \
      "setp.ne.b32 p, %66, 0;\n"                                                           \
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "                              \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "            \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "   \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "   \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "  \
      "%64, %65, p, 1, 1;\n"                                                               \
      "}\n"                                                                                \
      : acc(d, 0), acc(d, 8), acc(d, 16), acc(d, 24), acc(d, 32), acc(d, 40), acc(d, 48),  \
        acc(d, 56)                                                                         \
      : "l"(da), "l"(db), "r"(zero ? 0 : 1))

// d[64] = A[64 x 8] B[8 x 128] in tf32 (the low 13 bits of each f32
// operand are ignored): A and B from shared memory, both K-major, as f32
// rows of 128 bytes in the 128-byte swizzle (a k8 step is 32 bytes).
// Writes d without reading it.
__device__ __forceinline__ void wgmma_m64n128k8_tf32_ss_first(float (&d)[64], uint64_t da,
                                                              uint64_t db) {
  SM90_M64N128K8_TF32_SS(SM90_OUT8, true);
}

// d[64] += A[64 x 8] B[8 x 128] in tf32, as above
__device__ __forceinline__ void wgmma_m64n128k8_tf32_ss(float (&d)[64], uint64_t da,
                                                        uint64_t db) {
  SM90_M64N128K8_TF32_SS(SM90_ACC8, false);
}

#undef SM90_M64N128K8_TF32_SS
#undef SM90_OUT8

// d[64] += A[64 x 16] B[16 x 128]: A from registers (the bf16 fragments
// of mma.sync's m16n8k16 A operand, one 16-row slice per warp), B from
// shared memory, MN-major (transposed).
__device__ __forceinline__ void wgmma_m64n128k16_rs_tb(float (&d)[64], const uint32_t* a,
                                                       uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : SM90_ACC8(d, 0), SM90_ACC8(d, 8), SM90_ACC8(d, 16), SM90_ACC8(d, 24), SM90_ACC8(d, 32),
        SM90_ACC8(d, 40), SM90_ACC8(d, 48), SM90_ACC8(d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// the same with N = 104
__device__ __forceinline__ void wgmma_m64n104k16_rs_tb(float (&d)[52], const uint32_t* a,
                                                       uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %57, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n104k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51}, "
      "{%52, %53, %54, %55}, %56, p, 1, 1, 1;\n"
      "}\n"
      : SM90_ACC8(d, 0), SM90_ACC8(d, 8), SM90_ACC8(d, 16), SM90_ACC8(d, 24), SM90_ACC8(d, 32),
        SM90_ACC8(d, 40), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// the same with N = 64
__device__ __forceinline__ void wgmma_m64n64k16_rs_tb(float (&d)[32], const uint32_t* a,
                                                      uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : SM90_ACC8(d, 0), SM90_ACC8(d, 8), SM90_ACC8(d, 16), SM90_ACC8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef SM90_ACC8

// ---------------------------------------------------------------- host ---

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// A 4-D bf16 tensor map over dims[0] (innermost, contiguous) .. dims[3],
// with the byte strides of dims 1..3, boxes of box0 x 1 x box2 x 1
// elements, 128-byte swizzle, zeros out of bounds.  TMA needs the base
// and every stride 16-byte aligned and box0 * 2 <= 128.
inline cudaError_t encode_bf16_4d(CUtensorMap* map, const void* base, const uint64_t dims[4],
                                  const uint64_t strides[3], uint32_t box0, uint32_t box2) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t gdim[4] = {dims[0], dims[1], dims[2], dims[3]};
  const cuuint64_t gstride[3] = {strides[0], strides[1], strides[2]};
  const cuuint32_t box[4] = {box0, 1, box2, 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), gdim, gstride,
                  box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A 2-D tensor map of `type` over dim0 (innermost, contiguous) x dim1, dim1
// `stride1` bytes apart, boxes of box0 x box1 elements, zeros out of
// bounds.  TMA needs the base and stride1 16-byte aligned, box0 times the
// element size a multiple of 16 bytes (at most 128 with the 128-byte
// swizzle) and each box side at most 256.
inline cudaError_t encode_2d(CUtensorMap* map, CUtensorMapDataType type, const void* base,
                             uint64_t dim0, uint64_t dim1, uint64_t stride1, uint32_t box0,
                             uint32_t box1, CUtensorMapSwizzle swizzle) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t gdim[2] = {dim0, dim1};
  const cuuint64_t gstride[1] = {stride1};
  const cuuint32_t box[2] = {box0, box1};
  const cuuint32_t estride[2] = {1, 1};
  CUresult r = fn(map, type, 2, const_cast<void*>(base), gdim, gstride, box, estride,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace sm90
