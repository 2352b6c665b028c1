// Weight-only int8 matrix product for few rows (the decode step, M <= 64)
// on Hopper (sm_90a): split-K, a TMA ring of int8 weight tiles, mma.sync.
// Plain C interface.
//
// Replaces the Pallas TPU kernel tdax/ops/quant_matmul.py::_qmm_kernel
// (tdax/ops/quant_matmul.py:40; driven there by _qmm_2d, quant_matmul and
// qdot) for bf16 products of at most 64 rows that TMA can read.  The
// function is qmm.cu's:
//
//   out[m, n] = bf16( (sum_k x[m, k] * bf16(q[k, n])) * s[n] ),
//
// x [M, K] bf16 (contiguous rows, row stride ldx), q [K, N] int8 row-major,
// s [N] f32, out [M, N] bf16 contiguous.  The conversion of q is exact
// (|q| <= 127 fits bf16's significand), the sum f32, the scale applied once
// after the whole K sum, then one cast.  Ragged M, N and K arrive as zeros
// from TMA and are masked at the write.
//
// What bounds it on an H100 (3.35 TB/s): at M = 16 a product does 32 flops
// per weight byte, far under the tensor cores' ridge (295), so reading the
// int8 weight once bounds it: 7.1 GB for a decode step's 161 products,
// 2.1 ms.  qmm.cu reached 23% of that: N / 32 blocks of 4 warps (128 at
// N = 4096, under one an SM) each streamed its whole K x 32 slab through a
// register double buffer, a few KB in flight an SM.
//
// The design:
// - Split K.  Block (n tile, split) owns 128 output columns and a range of
//   kt_per K tiles of 128 (the wrapper picks kt_per so that a product
//   launches ~2 blocks an SM, at least 4 K tiles a split; the LM head's
//   1187 column tiles need no split).
// - Thread 0 keeps a ring of STAGES = 3 stages loading by TMA, each
//   completing on its mbarrier: the int8 tile [128 K, 128 N] (16 KB,
//   unswizzled) and x's [MP = 16 * ceil(M / 16) rows, 128 K] bf16 as two
//   128-byte swizzled boxes.  x is read with the weight tile it meets, so
//   the weight is read once for all M rows.  At M = 16 a block holds 60
//   KB, three fit an SM: up to 144 KB of loads in flight there.
// - Measured on an H100 (variants of this source at a decode step's five
//   sites): 3 stages beat 4 and 6 (more blocks an SM), ~2 blocks an SM
//   beat 1, 4 and 8 (longer K ranges a block amortise the ring's fill and
//   the epilogue), within 1-2% of each other at 2-8 K tiles a split.
// - The four warps split each tile's eight 16-deep K steps between them
//   (MT <= 2: each warp all 128 columns; MT > 2: two warps a 64-column
//   half, to bound the accumulators).  Lane (g, t) reads CPT bytes of four
//   K rows (one 16- or 8-byte load each, conflict-free), converts them to
//   bf16 pairs (the f32 magic number: exact) and runs mma.sync m16n8k16:
//   n-tile j's column g is weight column g * CPT + j, so one vector load
//   feeds CPT products.  The accumulators are f32.
// - The warps' partial sums add in a fixed order through shared memory;
//   with one split the block scales, casts and writes; with several it
//   writes its f32 partial to the wrapper's scratch [splits, M, N], and
//   the last block of the column tile to arrive (an integer ticket; no
//   floating-point atomics) sums the splits in split order, scales, casts,
//   writes, and resets the ticket for the next call.  A repeat is bitwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int BN = 128;     // output columns a block
constexpr int BK = 128;     // K a stage: two 64-wide swizzled x boxes
constexpr int STAGES = 3;
constexpr int THREADS = 128;
constexpr int Q_BYTES = BK * BN;  // 16 KB int8, 128 bytes a row

struct Params {
  const float* s;
  __nv_bfloat16* out;
  float* part;  // [nsplit, M, N] f32, or null with one split
  int* ticket;  // [n tiles], zero between calls, or null with one split
  int M, N, K;
  int kt_per, nsplit;
};

template <int MT>
struct Layout {
  static constexpr int MP = 16 * MT;               // x rows staged
  static constexpr int X_BOX = MP * 128;           // one 64-wide swizzled box
  static constexpr int STAGE = 2 * X_BOX + Q_BYTES;
  static constexpr int SMEM = STAGES * STAGE + 1024;  // room to align the base
  static_assert(STAGE % 1024 == 0, "swizzled boxes start 1024-aligned");
};

// byte `j` of the word w (already xor 0x80808080: b + 128) as an f32
// holding the integer b exactly: 2^23 + (b + 128) - (2^23 + 128)
__device__ __forceinline__ uint32_t s8_f32(uint32_t w, int j) {
  return __float_as_uint(__uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440 | j)) -
                         8388736.f);
}

// two f32 integers of at most 8 bits -> bf16 pair (lo in the low half)
__device__ __forceinline__ uint32_t pack_hi(uint32_t lo, uint32_t hi) {
  return __byte_perm(lo, hi, 0x7632);
}

// D = A(16x16, row) * B(16x8, col) + D, bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int CPT>
__device__ __forceinline__ void load_row(const unsigned char* p, uint32_t* w) {
  if constexpr (CPT == 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x ^ 0x80808080u;
    w[1] = v.y ^ 0x80808080u;
    w[2] = v.z ^ 0x80808080u;
    w[3] = v.w ^ 0x80808080u;
  } else {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x ^ 0x80808080u;
    w[1] = v.y ^ 0x80808080u;
  }
}

// 8 consecutive output columns of one row: bf16 (scaled) or f32 partial
__device__ __forceinline__ void store8(const Params& p, int row, int col, const float* v,
                                       bool partial, int split) {
  if (partial) {
    float* dst = p.part + ((long long)split * p.M + row) * p.N + col;
    reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
    return;
  }
  const float4 s0 = *reinterpret_cast<const float4*>(p.s + col);
  const float4 s1 = *reinterpret_cast<const float4*>(p.s + col + 4);
  const float sc[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i] * sc[2 * i], v[2 * i + 1] * sc[2 * i + 1]);
    w[i] = *reinterpret_cast<uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p.out + (long long)row * p.N + col) =
      make_uint4(w[0], w[1], w[2], w[3]);
}

template <int MT, int CPT>
__global__ void __launch_bounds__(THREADS)
qmm_decode_kernel(const __grid_constant__ CUtensorMap map_x,
                  const __grid_constant__ CUtensorMap map_q, const Params p) {
  using L = Layout<MT>;
  constexpr int CG = BN / (8 * CPT);  // warps across the columns
  constexpr int KG = 4 / CG;          // warps across the K steps of a stage
  constexpr int NACC = MT * CPT * 4;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ int is_last;
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

  const int n0 = blockIdx.x * BN;
  const int split = blockIdx.y;
  const int nkt = (p.K + BK - 1) / BK;
  const int kt0 = split * p.kt_per;
  const int steps = min(kt0 + p.kt_per, nkt) - kt0;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int cg = warp % CG, kg = warp / CG;

  auto load_stage = [&](int slot, int kt) {
    unsigned char* st = base + slot * L::STAGE;
    mbar_arrive_expect_tx(&full[slot], L::STAGE);
    tma_load_2d(st, &map_x, &full[slot], kt * BK, 0);
    tma_load_2d(st + L::X_BOX, &map_x, &full[slot], kt * BK + 64, 0);
    tma_load_2d(st + 2 * L::X_BOX, &map_q, &full[slot], n0, kt * BK);
  };
  if (tid == 0) {
    prefetch_tensormap(&map_x);
    prefetch_tensormap(&map_q);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0)
    for (int s = 0; s < min(STAGES, steps); ++s) load_stage(s, kt0 + s);

  float acc[MT][CPT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < CPT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

  for (int i = 0; i < steps; ++i) {
    const int slot = i % STAGES;
    mbar_wait(&full[slot], (i / STAGES) & 1);
    const unsigned char* xs = base + slot * L::STAGE;
    const unsigned char* qs = xs + 2 * L::X_BOX + cg * 8 * CPT + g * CPT;
#pragma unroll
    for (int it = 0; it < BK / 16 / KG; ++it) {
      const int kk = kg + it * KG;
      // A: x rows mt * 16 + g (+ 8), K columns kk * 16 + 2t (+ 8), read
      // through the 128-byte swizzle (16-byte unit u of row r at u ^ r % 8)
      uint32_t a[MT][4];
      const unsigned char* xh = xs + (kk >> 2) * L::X_BOX;
      const int unit = (kk & 3) * 2;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r = mt * 16 + g;
        const unsigned char* r0 = xh + r * 128 + t * 4;
        const unsigned char* r8 = r0 + 8 * 128;
        a[mt][0] = *reinterpret_cast<const uint32_t*>(r0 + ((unit ^ (r & 7)) << 4));
        a[mt][1] = *reinterpret_cast<const uint32_t*>(r8 + ((unit ^ (r & 7)) << 4));
        a[mt][2] = *reinterpret_cast<const uint32_t*>(r0 + (((unit + 1) ^ (r & 7)) << 4));
        a[mt][3] = *reinterpret_cast<const uint32_t*>(r8 + (((unit + 1) ^ (r & 7)) << 4));
      }
      // B: K rows kk * 16 + 2t, +1, +8, +9; CPT columns from g * CPT
      const unsigned char* qr = qs + (kk * 16 + 2 * t) * BN;
      uint32_t w0[CPT / 4], w1[CPT / 4], w8[CPT / 4], w9[CPT / 4];
      load_row<CPT>(qr, w0);
      load_row<CPT>(qr + BN, w1);
      load_row<CPT>(qr + 8 * BN, w8);
      load_row<CPT>(qr + 9 * BN, w9);
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const uint32_t b0 = pack_hi(s8_f32(w0[j >> 2], j & 3), s8_f32(w1[j >> 2], j & 3));
        const uint32_t b1 = pack_hi(s8_f32(w8[j >> 2], j & 3), s8_f32(w9[j >> 2], j & 3));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][j], a[mt], b0, b1);
      }
    }
    __syncthreads();  // every warp is done with this stage
    if (tid == 0 && i + STAGES < steps) load_stage(slot, kt0 + i + STAGES);
  }

  // the K groups' sums, in K-group order, through the (now idle) ring:
  // [KG - 1][CG][NACC][32] f32, a warp's 32 lanes side by side
  float* red = reinterpret_cast<float*>(base);
  if (kg > 0) {
    float* dst = red + ((kg - 1) * CG + cg) * NACC * 32 + lane;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < CPT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dst[((mt * CPT + j) * 4 + e) * 32] = acc[mt][j][e];
  }
  __syncthreads();
  const bool partial = p.nsplit > 1;
  if (kg == 0) {
#pragma unroll
    for (int k = 1; k < KG; ++k) {
      const float* src = red + ((k - 1) * CG + cg) * NACC * 32 + lane;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < CPT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][j][e] += src[((mt * CPT + j) * 4 + e) * 32];
    }
    // lane (g, t) holds rows mt * 16 + g (+ 8) and, for each of its two
    // fragment columns c = 2t, 2t + 1, the CPT consecutive weight columns
    // from c * CPT
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = mt * 16 + g + 8 * (e >> 1);
        const int col = n0 + cg * 8 * CPT + (2 * t + (e & 1)) * CPT;
        if (row >= p.M || col >= p.N) continue;  // N % 16 == 0: a run is whole or absent
#pragma unroll
        for (int h = 0; h < CPT; h += 8) {
          float v[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) v[i] = acc[mt][h + i][e];
          store8(p, row, col + h, v, partial, split);
        }
      }
  }
  if (!partial) return;

  // the last block of this column tile to arrive sums the splits in order
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(&p.ticket[blockIdx.x], 1) == p.nsplit - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const int cols = min(BN, p.N - n0) / 8;
  for (int idx = tid; idx < p.M * cols; idx += THREADS) {
    const int row = idx / cols, col = n0 + (idx % cols) * 8;
    float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int sp = 0; sp < p.nsplit; ++sp) {
      const float4* src =
          reinterpret_cast<const float4*>(p.part + ((long long)sp * p.M + row) * p.N + col);
      const float4 lo = __ldcg(src), hi = __ldcg(src + 1);
      v[0] += lo.x; v[1] += lo.y; v[2] += lo.z; v[3] += lo.w;
      v[4] += hi.x; v[5] += hi.y; v[6] += hi.z; v[7] += hi.w;
    }
    store8(p, row, col, v, false, 0);
  }
  if (tid == 0) p.ticket[blockIdx.x] = 0;
}

template <int MT, int CPT>
cudaError_t launch(const CUtensorMap& mx, const CUtensorMap& mq, const Params& p, dim3 grid,
                   cudaStream_t stream) {
  constexpr int smem = Layout<MT>::SMEM;
  // the shared-memory limit, set once a device: a decode step launches this
  // kernel 161 times, and its host time is the step's
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !ready[dev]) {
    err = cudaFuncSetAttribute(qmm_decode_kernel<MT, CPT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    if (dev < 64) ready[dev] = true;
  }
  qmm_decode_kernel<MT, CPT><<<grid, THREADS, smem, stream>>>(mx, mq, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [M, K] bf16 with row stride ldx (elements), q [K, N] int8 contiguous,
// s [N] f32, out [M, N] bf16 contiguous; 1 <= M <= 64, K % 8 == 0, ldx % 8
// == 0, N % 16 == 0, the x, q and s bases 16-byte aligned.  The K tiles of
// 128 go kt_per to a split, nsplit splits (no split empty); with nsplit >
// 1, part is at least [nsplit, M, N] f32 scratch and ticket at least
// [ceil(N / 128)] int32, zero (the kernel leaves it zero).  Returns the cudaError_t of the map
// encoding or the launch (0 = success).
int tdax_qmm_decode_sm90(const void* x, const int8_t* q, const float* s, void* out, int M, int N,
                         int K, long long ldx, int kt_per, int nsplit, float* part, int* ticket,
                         void* stream) {
  const int nkt = (K + BK - 1) / BK;
  if (M < 1 || M > 64 || N < 1 || K < 1 || K % 8 || ldx % 8 || ldx < K || N % 16 ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(q) % 16 ||
      reinterpret_cast<uintptr_t>(s) % 16 || kt_per < 1 || nsplit < 1 || nsplit > 65535 ||
      (long long)kt_per * nsplit < nkt || (long long)kt_per * (nsplit - 1) >= nkt ||
      (nsplit > 1 && (part == nullptr || ticket == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int mt = (M + 15) / 16;
  CUtensorMap map_x, map_q;
  cudaError_t err = encode_2d(&map_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, (uint64_t)K,
                              (uint64_t)M, 2ull * ldx, 64, 16 * mt, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return (int)err;
  err = encode_2d(&map_q, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, (uint64_t)N, (uint64_t)K, (uint64_t)N,
                  BN, BK, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != cudaSuccess) return (int)err;
  const Params p{s, static_cast<__nv_bfloat16*>(out), part, ticket, M, N, K, kt_per, nsplit};
  const dim3 grid((N + BN - 1) / BN, nsplit);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mt == 1) return (int)launch<1, 16>(map_x, map_q, p, grid, st);
  if (mt == 2) return (int)launch<2, 16>(map_x, map_q, p, grid, st);
  if (mt == 3) return (int)launch<3, 8>(map_x, map_q, p, grid, st);
  return (int)launch<4, 8>(map_x, map_q, p, grid, st);
}

const char* tdax_qmm_decode_sm90_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
