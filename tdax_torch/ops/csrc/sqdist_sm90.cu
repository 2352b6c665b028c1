// Pairwise squared Euclidean distances for Hopper (sm_90a) in 3xTF32 on the
// tensor cores: TMA, an mbarrier ring, wgmma in a warp-specialised block,
// and only the tiles on and above the diagonal.  Plain C interface.
//
// Replaces the Pallas TPU kernel tdax/ops/pallas_distances.py::_sqdist_kernel
// (tdax/ops/pallas_distances.py:27; grid at :57, driven by
// pairwise_sq_euclidean_pallas and pairwise_euclidean_pallas) for f32 x
// of at least 128 rows, in any layout.  The function is sqdist.cu's,
// unchanged:
//
//   out[i, j] = max(sq[i] + sq[j] - 2 * (x_i . x_j), 0),
//
// x [n, d] f32 -> [n, n] f32, sq[i] = |x_i|^2 in true f32.  sqdist.cu keeps
// fewer rows (tdax_torch/ops/sqdist.py::_route).
//
// Why 3xTF32 stands for Precision.HIGHEST.  tdax asks for HIGHEST
// (pallas_distances.py:38), which on the TPU's matrix unit is f32 emulated
// by several bf16 passes, not an IEEE FMA chain.  Hopper's counterpart
// splits x into hi = tf32(x) and lo = tf32(x - hi) (both rounded to
// nearest, ties away, by cvt.rna: wgmma on tf32 only truncates) and sums
// hi.hi^T + hi.lo^T + lo.hi^T on the tensor cores with f32 accumulators.
// |x - hi - lo| <= 2^-22 |x|, and the dropped lo.lo^T term is of that
// size too, so the product carries about f32's error; the port's bound,
// 1e-5 (|x_i|^2 + |x_j|^2) against the plain version, is unchanged.  But
// the tensor cores' f32 accumulation truncates: one accumulator over all
// of d = 4096 (512 k8 steps) missed that bound on an H100 (2.6e-5 at
// [128, 4096] randn, the error growing with the number of steps on the
// diagonal, where the distance cancels to 0).  So each CHUNK = 32 of d
// is summed on the tensor cores into a fresh chunk, the two small terms
// first and hi.hi^T after them (their sum is then truncated once, not at
// every step), and the chunks are added in f32, rounded to nearest, into
// a total in registers.  On an H100 at the scale path's cloud the result
// lies within 8.3e-7 (|x_i|^2 + |x_j|^2) of the exact distances of the
// f32 inputs, where sqdist.cu and an f32 cuBLAS GEMM, one rounded chain
// over all of d, lie within 4.4e-6: the total's roundings, no longer the
// truncation, set the error, so 16-wide chunks or a separate accumulator
// for the small terms read no better (probe_sqdist.py; PERF.md).
//
// What bounds it on an H100 (495 TFLOP/s TF32 dense, 3.35 TB/s): the
// symmetric half, n (n + 1) / 2 pairs of 2 d flops, three times: at the
// scale path's [10000, 4096] 1.23e12 flops, 2.48 ms; the bytes (x read
// once, the [n, n] output written once, 0.56 GB) take 0.17 ms.  A tile
// streams 2 x 128 rows of hi and lo, 8.4 MB at d = 4096, for 48 flops a
// byte against a TF32 ridge of 148: without L2 reuse device memory would
// bound it (26.5 GB, 7.9 ms), so the tiles are walked in groups of
// GROUP row blocks, and a wave of blocks shares its row and column blocks
// in L2.
//
// The design:
// - A split pass (sqdist_split_kernel, one block a row) reads x once, in
//   any row stride and from any base, and writes hi and lo (contiguous
//   [n, dp], dp = d rounded up to 4, the pad columns zero; low 13 bits
//   zero) and sq, so the product's TMA reads only the split pass's
//   output.
// - The product: one block per 128 x 128 output tile (I, J) with J >= I,
//   384 threads.  Thread 0 of the producer warpgroup (setmaxnreg.dec)
//   loads, by TMA with the 128-byte swizzle, hi and lo of row block I and
//   of row block J, [128 rows, 32 f32] each, into one stage of a ring of
//   STAGES (64 KB a stage; 32 KB on a diagonal tile, which reads its rows
//   once), behind full and empty mbarriers.  TMA zero-fills rows past n
//   and columns past d (a zero hi and lo add nothing), so the loop has no
//   masks.
// - Two consumer warpgroups (setmaxnreg.inc), 64 rows of the tile each,
//   run per k8 step wgmma m64n128k8 tf32 three times, both operands
//   K-major from shared memory (a [rows, 32 f32] tile has the 128-byte rows
//   of the bf16 kernels' [rows, 64] tiles, so desc_sw128 applies with a
//   k8 step of 32 bytes): c = hi_I lo_J^T + lo_I hi_J^T + hi_I hi_J^T over
//   the stage's 32 of d.  Stages alternate between two chunks, so one
//   stage's products run while the one before is added into the total
//   and its ring stage released.
// - The epilogue: out = max(sq_i + sq_j - 2 total, 0), staged in
//   the freed ring as 128-byte swizzled [128 rows, 32] boxes, once as the
//   tile and once as its transpose, and stored by TMA at (I, J) and
//   (J, I); TMA clips rows and columns past n.
// - Symmetry is exact by construction: each unordered pair {i, j} is
//   computed once and written to both places.  On a diagonal tile the
//   entries (a, b) and (b, a) would sum different small terms (hi_a lo_b
//   against hi_b lo_a) in another order, so only a <= b is kept and
//   mirrored.  Every entry
//   has one owner and sums in a fixed order: bitwise repeatable.
//
// Shared memory: STAGES = 3 x 64 KB = 192 KB plus 6 barriers; one block an
// SM.  The epilogue's two 64 KB stagings fit in the ring.  Registers: the
// consumers hold two 64 x 128 f32 chunks and the total, 192 a thread, and
// take CONSUMER_REGS = 232; the producer gives its own down to PRODUCER_REGS =
// 40 (128 x 40 + 256 x 232 = 64512 of the SM's 65536).

#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int BM = 128;     // output tile rows and columns
constexpr int BK = 32;      // f32 of d per stage: one 128-byte swizzled row
constexpr int CHUNK = 32;   // f32 of d summed on the tensor cores into one chunk
constexpr int CPS = BK / CHUNK;  // chunks a stage
constexpr int STAGES = 3;
constexpr int THREADS = 384;
constexpr int GROUP = 8;    // row blocks per raster group
constexpr uint32_t PRODUCER_REGS = 40, CONSUMER_REGS = 232;

constexpr int TILE_BYTES = BM * BK * 4;          // 16 KB: [128 rows, 32 f32]
constexpr int STAGE_BYTES = 4 * TILE_BYTES;      // hi_I, lo_I, hi_J, lo_J
constexpr int SM_BAR = STAGES * STAGE_BYTES;
constexpr int SM_BYTES = SM_BAR + 2 * STAGES * 8;
constexpr int SM_ALLOC = SM_BYTES + 1024;  // room to align the base
static_assert(SM_ALLOC <= 232448, "shared memory");
static_assert(BK % CHUNK == 0 && CHUNK % 8 == 0, "chunks of whole k8 steps");
static_assert(2 * (BM / 32) * TILE_BYTES <= STAGES * STAGE_BYTES, "epilogue staging");

// tf32(v): round to nearest, ties away from zero; the low 13 bits zero
__device__ __forceinline__ float tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return __uint_as_float(r & 0xFFFFE000u);
}

__device__ __forceinline__ void split(float v, float& h, float& l) {
  h = tf32_rna(v);
  l = tf32_rna(v - h);  // exact difference
}

// One block of 256 threads a row: hi and lo (row stride dp = d rounded up
// to 4, the pad columns zero) and sq[row].  VEC reads x as float4 (d % 4
// == 0, ldx % 4 == 0, a 16-byte base); otherwise as floats, in the same
// groups of 4 columns and the same order, the columns past d read as 0
// (fmaf(0, 0, s) == s), so every layout of the same values gives the same
// bits.  hi and lo need 16-byte bases.
template <bool VEC>
__global__ void __launch_bounds__(256)
sqdist_split_kernel(const float* __restrict__ x, long long ldx, int d, float* __restrict__ hi,
                    float* __restrict__ lo, float* __restrict__ sq) {
  const long long row = blockIdx.x;
  const float* xr = x + row * ldx;
  const int groups = (d + 3) / 4;
  float4* hr = reinterpret_cast<float4*>(hi + row * 4ll * groups);
  float4* lr = reinterpret_cast<float4*>(lo + row * 4ll * groups);
  float s = 0.f;
  for (int q = threadIdx.x; q < groups; q += 256) {
    float4 v;
    if constexpr (VEC) {
      v = reinterpret_cast<const float4*>(xr)[q];
    } else {
      const int c = 4 * q;  // c < d
      v.x = xr[c];
      v.y = c + 1 < d ? xr[c + 1] : 0.f;
      v.z = c + 2 < d ? xr[c + 2] : 0.f;
      v.w = c + 3 < d ? xr[c + 3] : 0.f;
    }
    float4 h, l;
    split(v.x, h.x, l.x);
    split(v.y, h.y, l.y);
    split(v.z, h.z, l.z);
    split(v.w, h.w, l.w);
    hr[q] = h;
    lr[q] = l;
    s = fmaf(v.x, v.x, s);
    s = fmaf(v.y, v.y, s);
    s = fmaf(v.z, v.z, s);
    s = fmaf(v.w, v.w, s);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xFFFFFFFFu, s, o);
  __shared__ float part[8];
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) t += part[w];
    sq[row] = t;
  }
}

// Tile t of the triangle J >= I: groups of GROUP row blocks; in a group,
// column by column, the rows of the group at or above the diagonal.
__device__ __forceinline__ void tile_coords(int t, int nb, int& I, int& J) {
  for (int r0 = 0; r0 < nb; r0 += GROUP) {
    const int gm = min(GROUP, nb - r0);
    const int tri = gm * (gm + 1) / 2;
    const int count = tri + (nb - r0 - gm) * gm;
    if (t < count) {
      if (t < tri) {  // column r0 + c holds c + 1 tiles
        int c = 0;
        while (t > c) {
          t -= c + 1;
          ++c;
        }
        I = r0 + t;
        J = r0 + c;
      } else {
        t -= tri;
        I = r0 + t % gm;
        J = r0 + gm + t / gm;
      }
      return;
    }
    t -= count;
  }
  I = J = 0;  // not reached: the grid has exactly the triangle's tiles
}

// element (r, c) of a staged [128, 128] tile: four [128 rows, 32] boxes in
// the 128-byte swizzle (16-byte unit u of row r at u ^ (r % 8))
__device__ __forceinline__ float* staged(unsigned char* tile, int r, int c) {
  return reinterpret_cast<float*>(tile + (c / 32) * TILE_BYTES + r * 128 +
                                  ((((c % 32) / 4) ^ (r % 8)) << 4) + (c % 4) * 4);
}

struct Params {
  const float* sq;
  int n, d, nb;
};

__global__ void __launch_bounds__(THREADS, 1)
sqdist_sm90_kernel(const __grid_constant__ CUtensorMap map_hi,
                   const __grid_constant__ CUtensorMap map_lo,
                   const __grid_constant__ CUtensorMap map_o, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + SM_BAR);  // a stage landed
  uint64_t* empty = full + STAGES;                               // both consumers read it

  int I, J;
  tile_coords(blockIdx.x, p.nb, I, J);
  const bool diag = I == J;
  const int nk = (p.d + BK - 1) / BK;
  const int tid = threadIdx.x;

  if (tid == 0) {
    prefetch_tensormap(&map_hi);
    prefetch_tensormap(&map_lo);
    prefetch_tensormap(&map_o);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one lane of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid < 128) {
    // ---------------------------------------------------- producer ---
    reg_dealloc<PRODUCER_REGS>();
    if (tid == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES;
        unsigned char* st = base + s * STAGE_BYTES;
        mbar_wait(&empty[s], ((kt / STAGES) & 1) ^ 1);  // round 0 passes at once
        mbar_arrive_expect_tx(&full[s], (diag ? 2 : 4) * TILE_BYTES);
        tma_load_2d(st, &map_hi, &full[s], kt * BK, I * BM);
        tma_load_2d(st + TILE_BYTES, &map_lo, &full[s], kt * BK, I * BM);
        if (!diag) {
          tma_load_2d(st + 2 * TILE_BYTES, &map_hi, &full[s], kt * BK, J * BM);
          tma_load_2d(st + 3 * TILE_BYTES, &map_lo, &full[s], kt * BK, J * BM);
        }
      }
    }
  } else {
    // --------------------------------------------------- consumers ---
    reg_alloc<CONSUMER_REGS>();
    const int ct = tid - 128;  // 0 .. 255 over both consumer warpgroups
    const int cw = ct / 128;   // rows cw * 64 .. + 63 of the tile
    const int warp = (ct % 128) / 32, lane = ct % 32;
    const int g = lane / 4, t = lane % 4;

    // Chunk q (CHUNK of d, part q % CPS of stage q / CPS) into c, written
    // fresh (scale-d 0 at its first product): the two small terms first,
    // then hi.hi^T, so that the sum of the small ones is truncated once,
    // when the big products join it, and not at every step.
    auto issue = [&](int q, float (&c)[64]) {
      const int kt = q / CPS;
      if (q % CPS == 0) mbar_wait(&full[kt % STAGES], (kt / STAGES) & 1);
      const uint32_t st = smem_u32(base + (kt % STAGES) * STAGE_BYTES) + (q % CPS) * CHUNK * 4;
      const uint32_t a_hi = st + cw * 64 * 128, a_lo = a_hi + TILE_BYTES;
      const uint32_t b_hi = diag ? st : st + 2 * TILE_BYTES, b_lo = b_hi + TILE_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < CHUNK / 8; ++kk) {
        const uint64_t dah = desc_sw128(a_hi + kk * 32, 0, 1024);
        const uint64_t dbl = desc_sw128(b_lo + kk * 32, 0, 1024);
        if (kk == 0)
          wgmma_m64n128k8_tf32_ss_first(c, dah, dbl);
        else
          wgmma_m64n128k8_tf32_ss(c, dah, dbl);
        wgmma_m64n128k8_tf32_ss(c, desc_sw128(a_lo + kk * 32, 0, 1024),
                                desc_sw128(b_hi + kk * 32, 0, 1024));
      }
#pragma unroll
      for (int kk = 0; kk < CHUNK / 8; ++kk)
        wgmma_m64n128k8_tf32_ss(c, desc_sw128(a_hi + kk * 32, 0, 1024),
                                desc_sw128(b_hi + kk * 32, 0, 1024));
      wgmma_commit();
    };
    // chunk q's products are in c: release its stage after the stage's
    // last chunk, add c to the total (f32, rounded to nearest)
    float c0[64], c1[64], total[64];
    auto drain = [&](int q, float (&c)[64]) {
      fence_regs(c);
      if (q % CPS == CPS - 1) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[(q / CPS) % STAGES]);
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) total[i] += c[i];
    };
#pragma unroll
    for (int i = 0; i < 64; ++i) total[i] = 0.f;

    // One chunk in flight while the one before it is added: chunks
    // alternate between c0 (even) and c1 (odd).
    const int nq = nk * CPS;
    issue(0, c0);
    int q = 1;
    for (; q + 1 < nq; q += 2) {
      issue(q, c1);
      wgmma_wait<1>();
      drain(q - 1, c0);
      issue(q + 1, c0);
      wgmma_wait<1>();
      drain(q, c1);
    }
    if (q < nq) {  // an even count of chunks: the last one goes to c1
      issue(q, c1);
      wgmma_wait<1>();
      drain(q - 1, c0);
      wgmma_wait<0>();
      drain(q, c1);
    } else {
      wgmma_wait<0>();
      drain(q - 1, c0);
    }

    // ------------------------------------------------------ epilogue ---
    // Once both warpgroups' products are in, the ring is free (every load
    // has landed and been read).  total[4 nb + 2 h + e] is tile row cw * 64
    // + warp * 16 + g + 8 h, column nb * 8 + 2 t + e.  S is the tile, T
    // its transpose; a diagonal tile keeps r <= c and mirrors r < c into
    // S itself.  S's paired writes and T's single ones fall in distinct
    // banks across a warp.
    named_barrier_sync(1, 256);
    unsigned char* S = base;
    unsigned char* T = diag ? base : base + (BM / 32) * TILE_BYTES;
    const int row0 = I * BM, col0 = J * BM;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = cw * 64 + warp * 16 + g + 8 * h;
      const float sr = row0 + r < p.n ? p.sq[row0 + r] : 0.f;
#pragma unroll
      for (int nb = 0; nb < BM / 8; ++nb) {
        const int c = nb * 8 + 2 * t;
        const float sc0 = col0 + c < p.n ? p.sq[col0 + c] : 0.f;
        const float sc1 = col0 + c + 1 < p.n ? p.sq[col0 + c + 1] : 0.f;
        const int i = 4 * nb + 2 * h;
        // 2 * total is exact, so a contracted fma changes nothing
        const float v0 = fmaxf(sr + sc0 - 2.f * total[i], 0.f);
        const float v1 = fmaxf(sr + sc1 - 2.f * total[i + 1], 0.f);
        if (!diag) {
          *reinterpret_cast<float2*>(staged(S, r, c)) = make_float2(v0, v1);
          *staged(T, c, r) = v0;
          *staged(T, c + 1, r) = v1;
        } else {
          if (r <= c) *staged(S, r, c) = v0;
          if (r <= c + 1) *staged(S, r, c + 1) = v1;
          if (r < c) *staged(S, c, r) = v0;
          if (r < c + 1) *staged(S, c + 1, r) = v1;
        }
      }
    }
    fence_proxy_async();
    named_barrier_sync(1, 256);
    if (ct == 0) {
      for (int b = 0; b < BM / 32 && col0 + b * 32 < p.n; ++b)
        tma_store_2d(&map_o, S + b * TILE_BYTES, col0 + b * 32, row0);
      if (!diag)
        for (int b = 0; b < BM / 32 && row0 + b * 32 < p.n; ++b)
          tma_store_2d(&map_o, T + b * TILE_BYTES, row0 + b * 32, col0);
      tma_store_commit_and_wait();
    }
  }
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace

extern "C" {

// x [n, d] f32 with any row stride ldx >= 0 and any (4-byte) base -> hi,
// lo [n, dp] f32 contiguous, dp = d rounded up to 4 (tf32 values, the low
// 13 bits zero; the pad columns zero) and sq [n] = |x_i|^2.  hi and lo
// need 16-byte bases.  Returns the cudaError_t of the launch.
int tdax_sqdist_split(const float* x, long long ldx, int n, int d, float* hi, float* lo,
                      float* sq, void* stream) {
  if (n < 1 || d < 1 || ldx < 0 || reinterpret_cast<uintptr_t>(x) % 4 || !aligned16(hi) ||
      !aligned16(lo))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d % 4 == 0 && ldx % 4 == 0 && aligned16(x))
    sqdist_split_kernel<true><<<n, 256, 0, s>>>(x, ldx, d, hi, lo, sq);
  else
    sqdist_split_kernel<false><<<n, 256, 0, s>>>(x, ldx, d, hi, lo, sq);
  return (int)cudaGetLastError();
}

// hi, lo [n, d] contiguous and sq [n] from tdax_sqdist_split -> out [n, n]
// f32 with row stride ldo.  Needs d % 4 == 0, ldo % 4 == 0, ldo >= n and
// 16-byte bases (what TMA reads and writes).  Returns the cudaError_t of
// the map encoding or the launch (0 = success).
int tdax_sqdist_sm90(const float* hi, const float* lo, const float* sq, float* out, int n, int d,
                     long long ldo, void* stream) {
  if (n < 1 || d < 1 || d % 4 || ldo % 4 || ldo < n || !aligned16(hi) || !aligned16(lo) ||
      !aligned16(out))
    return (int)cudaErrorInvalidValue;
  CUtensorMap map_hi, map_lo, map_o;
  cudaError_t err = encode_2d(&map_hi, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, hi, (uint64_t)d,
                              (uint64_t)n, 4ull * d, BK, BM, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return (int)err;
  err = encode_2d(&map_lo, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, lo, (uint64_t)d, (uint64_t)n,
                  4ull * d, BK, BM, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return (int)err;
  err = encode_2d(&map_o, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, out, (uint64_t)n, (uint64_t)n,
                  4ull * ldo, 32, BM, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return (int)err;

  const int nb = (n + BM - 1) / BM;
  const long long tiles = (long long)nb * (nb + 1) / 2;
  if (tiles > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(sqdist_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SM_ALLOC);
  if (err != cudaSuccess) return (int)err;
  sqdist_sm90_kernel<<<(unsigned)tiles, THREADS, SM_ALLOC, static_cast<cudaStream_t>(stream)>>>(
      map_hi, map_lo, map_o, Params{sq, n, d, nb});
  return (int)cudaGetLastError();
}

const char* tdax_sqdist_sm90_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
