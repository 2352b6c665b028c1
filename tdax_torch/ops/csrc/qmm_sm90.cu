// Weight-only int8 matrix product for Hopper (sm_90a): TMA, an mbarrier
// ring, the int8 -> bf16 conversion in shared memory and wgmma in a
// warp-specialised block.  Plain C interface.
//
// Replaces the Pallas TPU kernel tdax/ops/quant_matmul.py::_qmm_kernel
// (tdax/ops/quant_matmul.py:40; driven there by _qmm_2d, quant_matmul and
// qdot) for bf16 products with at least 128 rows that TMA can read.  The
// function is qmm.cu's, unchanged:
//
//   out[m, n] = bf16( (sum_k x[m, k] * bf16(q[k, n])) * s[n] ),
//
// x [M, K] bf16 (contiguous rows, row stride ldx), q [K, N] int8 row-major,
// s [N] f32, out [M, N] bf16 contiguous.  The sum is f32; the conversion of
// q is exact (|q| <= 127 fits bf16's 8-bit significand); the scale is
// applied once, at the single write.  The weight crosses device memory as
// one byte per element: no bf16 copy of it is ever written there.  qmm.cu
// keeps f32, the decode step (M < 128) and the views TMA cannot read
// (tdax_torch/ops/quant_matmul.py::_route).
//
// What bounds it on an H100 (989 TFLOP/s bf16, 3.35 TB/s; ridge 295
// flop/byte): at the capture's and the prefill's shapes (M = 5120 or
// 16384, K and N 1664 to 12288) a product does thousands of flops per
// byte it must move, so the tensor cores bound it.
//
// The design:
// - A block owns a 256 x 128 output tile: 384 threads, a producer
//   warpgroup and two consumer warpgroups of 128 rows each (two of
//   wgmma's 64-row products).  Tiles are visited in groups of GROUP_M row
//   blocks by every column block, so a wave of blocks shares x row blocks
//   and weight column blocks in L2.
// - K streams in steps of 64.  Thread 0 of the producer (the warpgroup
//   gives its registers away with setmaxnreg.dec) loads, by TMA, the x
//   tile [256 rows, 64] bf16 (128-byte swizzle, K-major) and the raw int8
//   tile [64, 128] (unswizzled, 128 bytes a row) of a step into one stage
//   of a ring of A_STAGES, both completing on that stage's full barrier,
//   and runs ahead as far as the ring's empty barriers allow.  TMA
//   zero-fills rows past M, columns past N and K past K, so the main loop
//   has no masks.
// - The consumer warpgroups (setmaxnreg.inc) convert: while the tensor
//   cores run step kt's products, each of their 256 threads takes 2 of the
//   512 16-byte chunks of step kt + 1's int8 tile, turns each byte into
//   bf16 by the f32 magic number (2^23 + (b + 128), minus 2^23 + 128,
//   exact, then the upper half) and stores 32 bytes into a bf16 tile of a
//   second ring of B_STAGES, in the 128-byte swizzled MN-major layout
//   wgmma reads (one [64 K rows, 64 N] region of 8 KB per 64 columns;
//   16-byte unit u of row k at u ^ (k % 8)); no bank conflict on either
//   side.  Then the async-proxy fence and a named barrier over both
//   warpgroups, and each issues step kt + 1's products: per 16 of K, two
//   wgmma m64n128k16 (A: 64 of its rows of x, K-major; B: the bf16 tile
//   through the transpose bit) into 2 x 64 f32 accumulators a thread.  One
//   group stays in flight: before the barrier each waits for step kt - 1's
//   products and releases that step's x and int8 stage (one arrival a
//   warp).  The bf16 stage step kt + 1 overwrites held step kt - 2, which
//   both have waited for before the previous barrier.
// - The epilogue multiplies by s[n], rounds to bf16 once, writes each
//   warpgroup's 128 x 128 outputs into the x ring (free once both
//   warpgroups' products are in) as two 128-byte swizzled [128, 64] boxes
//   and stores them by TMA, which clips rows past M and columns past N.
//   Every output has one owner and sums in a fixed order: no atomics,
//   deterministic.
//
// Shared memory: A_STAGES = 4 x (32 KB x + 8 KB int8) + B_STAGES = 3 x
// 16 KB bf16 = 208 KB of the 227 KB a block may hold, plus 8 barriers;
// one block an SM.  Registers: the consumers hold a 128 x 128 f32
// accumulator, 128 a thread, and the conversion's ~20, and take
// CONSUMER_REGS = 232 by setmaxnreg; the producer gives its own down to
// PRODUCER_REGS = 40 (128 x 40 + 256 x 232 = 64512 of the SM's 65536).
//
// Shared-memory traffic per K step of a block, reckoned against the math
// (2 x 256 x 128 x 64 = 4.19 MFLOP, 1024 clocks of an SM's tensor cores at
// their peak): TMA writes 32 KB of x and 8 KB of int8; the conversion
// reads 8 KB and writes 16 KB; wgmma reads 2 KB of x and 4 KB of bf16 per
// 64-row product, 96 KB.  160 KB at the port's 128 bytes a clock take
// 1280 clocks: the shared-memory port, not the tensor cores, caps this
// design at ~80% of 989 TFLOP/s.
//
// Why 256 x 128 (probe_qmm.py on an H100, at the ViT's qkv product
// [16384, 1664] x [1664, 4992]): without the conversion a 128 x 256 tile
// ran at 73% of the bound, as fast as cuBLAS on bf16 weights; the
// conversion's arithmetic and stores hid under the products, but its
// shared loads did not (loads into registers compete with wgmma's operand
// reads, ~24% of that kernel, whether from the shared ring or straight
// from device memory).  A block of 256 rows loads the same int8 tile for
// twice the rows, half the loads a flop, and ran 4-10% faster by site.
// Tried and slower: converting in the producer warpgroup behind a
// "converted" barrier (its four warps took ~2.2 us a step), loading the
// int8 a step ahead or by its own TMA stream, a fifth x stage, and
// storing the epilogue straight from the accumulator fragment (30% slower
// at K = 1664).  Reading the weight as wgmma's register A operand of the
// transposed product (no bf16 tile, no shared loads of int8), a
// persistent grid and TMA multicast across a cluster are the levers left.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int BM = 256;   // output rows per block: two consumer warpgroups of 128
constexpr int BN = 128;   // output columns per block
constexpr int BK = 64;    // K per step: one 128-byte swizzled row of bf16 x
constexpr int A_STAGES = 4;
constexpr int B_STAGES = 3;
constexpr int THREADS = 384;
constexpr int GROUP_M = 8;  // row blocks per raster group
constexpr uint32_t PRODUCER_REGS = 40, CONSUMER_REGS = 232;

constexpr int X_BYTES = BM * BK * 2;          // 32 KB, 128-byte swizzled
constexpr int Q_BYTES = BK * BN;              // 8 KB int8, 128 bytes a row
constexpr int B_CHUNK = BK * 128;             // 8 KB: 64 K rows x 64 bf16 columns
constexpr int B_BYTES = (BN / 64) * B_CHUNK;  // 16 KB
constexpr int O_BOX = 128 * 128;              // 16 KB: 128 output rows x 64 bf16 columns

// shared memory, as offsets from a 1024-aligned base
constexpr int SM_X = 0;
constexpr int SM_Q = SM_X + A_STAGES * X_BYTES;
constexpr int SM_B = SM_Q + A_STAGES * Q_BYTES;
constexpr int SM_BAR = SM_B + B_STAGES * B_BYTES;
constexpr int SM_BYTES = SM_BAR + 2 * A_STAGES * 8;
constexpr int SM_ALLOC = SM_BYTES + 1024;  // room to align the base
static_assert(SM_ALLOC <= 232448, "shared memory");
static_assert(2 * (BN / 64) * O_BOX <= A_STAGES * X_BYTES, "epilogue staging");

struct Params {
  const float* s;
  int M, N, K;
  int m_blocks, n_blocks;
};

// 4 int8 (one word, the lowest column in the low byte) -> 4 bf16 as two
// words (the lower column in the low half).  Exact: 2^23 + (b + 128) is an
// f32 whose low mantissa byte is b + 128; subtracting 2^23 + 128 leaves b,
// and the upper half of an f32 that is an integer of at most 8 bits is its
// bf16.
__device__ __forceinline__ void i8x4_to_bf16(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;  // b + 128 per byte
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.f;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

// This thread's share of one stage's int8 tile [64, 128] -> bf16 [64, 128]
// in the 128-byte swizzled MN-major layout; `ct` is the thread's index
// over both consumer warpgroups (0 .. 255).  512 16-byte chunks, 2 a
// thread.  A warp covers four K rows whole, and each quarter-warp (the
// unit of a 16-byte shared access) the first 64 bytes of one row and the
// last 64 of its neighbour, so that its 8 loads fall in 8 distinct 16-byte
// bank groups and so do its 8 stores (the XOR with an even and an odd
// k % 8 makes the even and the odd units): no bank conflict.
__device__ __forceinline__ void convert_part(const unsigned char* q8, unsigned char* bt, int ct) {
  const int lane = ct % 32, quarter = lane / 8, half = (lane % 8) / 4;
  const int dk = 2 * (quarter / 2) + (half ^ (quarter % 2));  // which of the warp's 4 rows
  const int col16 = half * 4 + lane % 4;                      // 16-byte chunk of the row
  const int j = (col16 % 4) * 2;  // 16-byte unit of its first 8 columns in their 64
#pragma unroll
  for (int i = 0; i < BK * BN / 16 / 256; ++i) {
    const int k = 4 * (ct / 32 + 8 * i) + dk;  // 8 warps: rows 0..31, then 32..63
    const uint4 w = *reinterpret_cast<const uint4*>(q8 + k * BN + col16 * 16);
    uint4 v0, v1;
    i8x4_to_bf16(w.x, v0.x, v0.y);
    i8x4_to_bf16(w.y, v0.z, v0.w);
    i8x4_to_bf16(w.z, v1.x, v1.y);
    i8x4_to_bf16(w.w, v1.z, v1.w);
    unsigned char* row = bt + (col16 / 4) * B_CHUNK + k * 128;
    *reinterpret_cast<uint4*>(row + ((j ^ (k % 8)) << 4)) = v0;
    *reinterpret_cast<uint4*>(row + (((j + 1) ^ (k % 8)) << 4)) = v1;
  }
}

__global__ void __launch_bounds__(THREADS, 1)
qmm_sm90_kernel(const __grid_constant__ CUtensorMap map_x,
                const __grid_constant__ CUtensorMap map_q,
                const __grid_constant__ CUtensorMap map_o, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* a_full = reinterpret_cast<uint64_t*>(base + SM_BAR);  // x and int8 landed
  uint64_t* a_empty = a_full + A_STAGES;  // x read and int8 converted by both consumers

  // grouped raster: GROUP_M row blocks by every column block
  const int tile = blockIdx.x;
  const int per_group = GROUP_M * p.n_blocks;
  const int first_m = (tile / per_group) * GROUP_M;
  const int gm = min(p.m_blocks - first_m, GROUP_M);
  const int in_group = tile % per_group;
  const int m0 = (first_m + in_group % gm) * BM;
  const int n0 = (in_group / gm) * BN;
  const int nk = (p.K + BK - 1) / BK;
  const int tid = threadIdx.x;

  if (tid == 0) {
    prefetch_tensormap(&map_x);
    prefetch_tensormap(&map_q);
    prefetch_tensormap(&map_o);
    for (int s = 0; s < A_STAGES; ++s) {
      mbar_init(&a_full[s], 1);
      mbar_init(&a_empty[s], 8);  // one lane of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid < 128) {
    // ---------------------------------------------------- producer ---
    reg_dealloc<PRODUCER_REGS>();
    if (tid == 0) {
      for (int j = 0; j < nk; ++j) {
        const int s = j % A_STAGES;
        mbar_wait(&a_empty[s], ((j / A_STAGES) & 1) ^ 1);  // round 0 passes at once
        mbar_arrive_expect_tx(&a_full[s], X_BYTES + Q_BYTES);
        tma_load_2d(base + SM_X + s * X_BYTES, &map_x, &a_full[s], j * BK, m0);
        tma_load_2d(base + SM_Q + s * Q_BYTES, &map_q, &a_full[s], n0, j * BK);
      }
    }
  } else {
    // --------------------------------------------------- consumers ---
    reg_alloc<CONSUMER_REGS>();
    const int ct = tid - 128;      // 0 .. 255 over both consumer warpgroups
    const int cw = ct / 128;       // rows cw * 128 .. + 127 of the tile
    const int warp = (ct % 128) / 32, lane = ct % 32;
    const int g = lane / 4, t = lane % 4;
    const uint32_t x_off = cw * 128 * 128;

    // step j's int8 tile into bf16 stage j % B_STAGES, then both
    // warpgroups' shares visible to wgmma
    auto convert = [&](int j) {
      mbar_wait(&a_full[j % A_STAGES], (j / A_STAGES) & 1);
      convert_part(base + SM_Q + (j % A_STAGES) * Q_BYTES,
                   base + SM_B + (j % B_STAGES) * B_BYTES, ct);
      fence_proxy_async();
    };
    // step j's products: per 16 of K, rows + 0 and + 64 of the warpgroup's
    // 128 times the bf16 tile; FIRST writes the accumulators (step 0)
    float acc0[64], acc1[64];
    auto issue = [&](int j, auto first) {
      const uint32_t x_addr = smem_u32(base + SM_X + (j % A_STAGES) * X_BYTES) + x_off;
      const uint32_t b_addr = smem_u32(base + SM_B + (j % B_STAGES) * B_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t da0 = desc_sw128(x_addr + kk * 32, 0, 1024);
        const uint64_t da1 = desc_sw128(x_addr + 64 * 128 + kk * 32, 0, 1024);
        const uint64_t db = desc_sw128(b_addr + kk * 16 * 128, B_CHUNK, 1024);
        if (decltype(first)::value && kk == 0) {
          wgmma_m64n128k16_ss_tb_first(acc0, da0, db);
          wgmma_m64n128k16_ss_tb_first(acc1, da1, db);
        } else {
          wgmma_m64n128k16_ss_tb(acc0, da0, db);
          wgmma_m64n128k16_ss_tb(acc1, da1, db);
        }
      }
      wgmma_commit();
    };

    // Step kt + 1 is converted while step kt's products run.  Its bf16
    // stage last held step kt - 2, whose products both warpgroups waited
    // for before the previous named barrier.  Step kt - 1's stage is
    // released first, so the loads run up to three steps ahead.
    convert(0);
    named_barrier_sync(1, 256);
    issue(0, std::true_type{});
    for (int kt = 0; kt < nk; ++kt) {
      wgmma_wait<1>();  // step kt - 1's products are in: its x and int8 are free
      if (kt > 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&a_empty[(kt - 1) % A_STAGES]);
      }
      if (kt + 1 < nk) {
        convert(kt + 1);
        named_barrier_sync(1, 256);
        issue(kt + 1, std::false_type{});
      }
    }
    wgmma_wait<0>();
    fence_regs(acc0);
    fence_regs(acc1);

    // ------------------------------------------------------ epilogue ---
    // Once both warpgroups' products are in, the x ring is free (every
    // load has landed and been read): out = bf16(acc * s[n]) into this
    // warpgroup's 32 KB of it as two [128 rows, 64 columns] boxes in the
    // 128-byte swizzle, then stored by TMA, which clips rows past M and
    // columns past N.  accH[4 nb + 2 h + e] is row 64 H + warp * 16 + g +
    // 8 h, column nb * 8 + 2 t + e; a warp's 4-byte writes fall in 32
    // distinct banks.
    named_barrier_sync(1, 256);
    unsigned char* ot = base + SM_X + cw * (BN / 64) * O_BOX;
    auto stage_out = [&](const float (&a)[64], int r0) {
#pragma unroll
      for (int nb = 0; nb < BN / 8; ++nb) {
        const int col = n0 + nb * 8 + 2 * t;
        const float2 sc = col < p.N ? *reinterpret_cast<const float2*>(p.s + col)
                                    : make_float2(0.f, 0.f);  // N is even: col + 1 < N with col
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + warp * 16 + g + 8 * h;
          const int off = (nb / 8) * O_BOX + r * 128 + (((nb % 8) ^ (r % 8)) << 4) + t * 4;
          *reinterpret_cast<__nv_bfloat162*>(ot + off) =
              __floats2bfloat162_rn(a[4 * nb + 2 * h] * sc.x, a[4 * nb + 2 * h + 1] * sc.y);
        }
      }
    };
    stage_out(acc0, 0);
    stage_out(acc1, 64);
    fence_proxy_async();
    named_barrier_sync(2 + cw, 128);
    const int row0 = m0 + cw * 128;
    if (ct % 128 == 0 && row0 < p.M) {
      for (int c = 0; c < BN / 64 && n0 + c * 64 < p.N; ++c)
        tma_store_2d(&map_o, ot + c * O_BOX, n0 + c * 64, row0);
      tma_store_commit_and_wait();
    }
  }
}

}  // namespace

extern "C" {

// x [M, K] bf16 with row stride ldx (elements), q [K, N] int8 contiguous,
// s [N] f32, out [M, N] bf16 contiguous.  Needs K % 8 == 0, ldx % 8 == 0,
// N % 16 == 0 and the x, q and s bases 16-byte aligned (what TMA and the
// epilogue's paired loads read).  Returns the cudaError_t of the map
// encoding or the launch (0 = success).
int tdax_qmm_sm90(const void* x, const int8_t* q, const float* s, void* out, int M, int N, int K,
                  long long ldx, void* stream) {
  if (M < 1 || N < 1 || K < 1 || K % 8 || ldx % 8 || ldx < K || N % 16 ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(q) % 16 ||
      reinterpret_cast<uintptr_t>(s) % 16)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map_x, map_q, map_o;
  cudaError_t err = encode_2d(&map_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, (uint64_t)K,
                              (uint64_t)M, 2ull * ldx, BK, BM, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return (int)err;
  err = encode_2d(&map_q, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, (uint64_t)N, (uint64_t)K,
                  (uint64_t)N, BN, BK, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != cudaSuccess) return (int)err;
  err = encode_2d(&map_o, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, out, (uint64_t)N, (uint64_t)M,
                  2ull * N, 64, 128, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return (int)err;

  Params p{s, M, N, K, (M + BM - 1) / BM, (N + BN - 1) / BN};
  const long long tiles = (long long)p.m_blocks * p.n_blocks;
  if (tiles > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(qmm_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SM_ALLOC);
  if (err != cudaSuccess) return (int)err;
  qmm_sm90_kernel<<<(unsigned)tiles, THREADS, SM_ALLOC, static_cast<cudaStream_t>(stream)>>>(
      map_x, map_q, map_o, p);
  return (int)cudaGetLastError();
}

const char* tdax_qmm_sm90_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
