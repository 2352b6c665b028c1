// Pairwise squared Euclidean distances for Hopper (sm_90a), with a plain
// C interface.
//
// Replaces the Pallas TPU kernel tdax/ops/pallas_distances.py::_sqdist_kernel
// (driven there by pairwise_sq_euclidean_pallas and
// pairwise_euclidean_pallas).  Same function:
//
//   out[i, j] = max(sq[i] + sq[j] - 2 * (x_i . x_j), 0),
//
// x [n, d] f32 with row stride ldx, sq [n] f32 the row norms |x_i|^2
// (computed outside, as the TPU wrapper computes them outside its Pallas
// body), out [n, n] f32 with row stride ldo.  The product accumulates in
// true f32 (fmaf on the CUDA cores, never TF32: tdax pins
// Precision.HIGHEST), and the norms, the clamp and the store are fused
// into the epilogue, so no Gram matrix reaches device memory.
//
// What bounds it on an H100: 2*n*n*d flops on n*d*4 + n*n*4 bytes.  At
// the scale path's [10000, 4096] that is 8.2e11 flops against 0.56 GB,
// ~1450 flop/byte, far above the f32 ridge (67 TFLOP/s / 3.35 TB/s = 20
// flop/byte): the f32 FMA rate bounds it, 12.2 ms.
//
// Design: one block of 256 threads per 128 x 128 output tile; K advances
// in chunks of 8 that are staged through shared memory, transposed to
// [k][row] so the compute loop reads four consecutive rows as one float4,
// and double-buffered (the next chunk is read from device memory into
// registers while the current one is multiplied).  Each thread owns an
// 8 x 8 register micro-tile, rows {ty*4 .. ty*4+3, 64+ty*4 .. 64+ty*4+3}
// and the same for columns, which keeps the float4 shared-memory reads
// free of bank conflicts.  Ragged n and d are masked here (loads past
// the edge read 0, stores past it are skipped); no padded copy is made.
// Every output tile is computed, the symmetric half included, as the TPU
// kernel does; tiles (i, j) and (j, i) sum their products in the same
// order, so the output is exactly symmetric.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;       // output tile rows and columns
constexpr int BK = 8;         // contraction chunk
constexpr int THREADS = 256;  // 16 x 16 threads, each an 8 x 8 micro-tile

// Global -> registers: thread t loads 4 consecutive k of tile row t / 2,
// for the row block (a) and the column block (b).
template <bool VEC>
__device__ __forceinline__ void load_chunk(const float* __restrict__ x, int n, int d,
                                           long long ldx, int row0, int col0, int k0,
                                           int lr, int lk, float (&ra)[4], float (&rb)[4]) {
  const int ga = row0 + lr, gb = col0 + lr, k = k0 + lk;
  if (VEC) {  // d % 4 == 0, ldx % 4 == 0, x 16-byte aligned: k < d covers k..k+3
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 va = (ga < n && k < d) ? *reinterpret_cast<const float4*>(x + ga * ldx + k) : zero;
    const float4 vb = (gb < n && k < d) ? *reinterpret_cast<const float4*>(x + gb * ldx + k) : zero;
    ra[0] = va.x; ra[1] = va.y; ra[2] = va.z; ra[3] = va.w;
    rb[0] = vb.x; rb[1] = vb.y; rb[2] = vb.z; rb[3] = vb.w;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      ra[q] = (ga < n && k + q < d) ? x[ga * ldx + k + q] : 0.f;
      rb[q] = (gb < n && k + q < d) ? x[gb * ldx + k + q] : 0.f;
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
sqdist_kernel(const float* __restrict__ x, const float* __restrict__ sq, float* __restrict__ out,
              int n, int d, long long ldx, long long ldo) {
  __shared__ __align__(16) float As[2][BK][BM];
  __shared__ __align__(16) float Bs[2][BK][BM];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BM;
  const int lr = tid / 2, lk = (tid % 2) * 4;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  float ra[4], rb[4];
  const int nk = (d + BK - 1) / BK;
  load_chunk<VEC>(x, n, d, ldx, row0, col0, 0, lr, lk, ra, rb);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    As[0][lk + q][lr] = ra[q];
    Bs[0][lk + q][lr] = rb[q];
  }
  __syncthreads();

  for (int t = 0; t < nk; ++t) {
    const int cur = t & 1;
    if (t + 1 < nk) load_chunk<VEC>(x, n, d, ldx, row0, col0, (t + 1) * BK, lr, lk, ra, rb);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[8], b[8];
      *reinterpret_cast<float4*>(&a[0]) = *reinterpret_cast<const float4*>(&As[cur][kk][ty * 4]);
      *reinterpret_cast<float4*>(&a[4]) = *reinterpret_cast<const float4*>(&As[cur][kk][64 + ty * 4]);
      *reinterpret_cast<float4*>(&b[0]) = *reinterpret_cast<const float4*>(&Bs[cur][kk][tx * 4]);
      *reinterpret_cast<float4*>(&b[4]) = *reinterpret_cast<const float4*>(&Bs[cur][kk][64 + tx * 4]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (t + 1 < nk) {
      // the other buffer was last read in step t - 1, before the barrier
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        As[cur ^ 1][lk + q][lr] = ra[q];
        Bs[cur ^ 1][lk + q][lr] = rb[q];
      }
    }
    __syncthreads();
  }

  // epilogue: norms, clamp, store (2 * acc is exact, so a contracted
  // fma gives the same value as the separate multiply and subtract)
  float sc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = col0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
    sc[j] = c < n ? sq[c] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (r >= n) continue;
    const float sr = sq[r];
    float* orow = out + r * ldo;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = col0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (c < n) orow[c] = fmaxf(sr + sc[j] - 2.f * acc[i][j], 0.f);
    }
  }
}

}  // namespace

extern "C" {

// vec: 1 when d and ldx are multiples of 4 and x is 16-byte aligned.
// Returns the cudaError_t of the launch (0 = success).
int tdax_sqdist(const float* x, const float* sq, float* out, int n, int d, long long ldx,
                long long ldo, int vec, void* stream) {
  if (n < 1 || d < 1 || ldx < d || ldo < n) return (int)cudaErrorInvalidValue;
  const dim3 grid((n + BM - 1) / BM, (n + BM - 1) / BM);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    sqdist_kernel<true><<<grid, THREADS, 0, s>>>(x, sq, out, n, d, ldx, ldo);
  else
    sqdist_kernel<false><<<grid, THREADS, 0, s>>>(x, sq, out, n, d, ldx, ldo);
  return (int)cudaGetLastError();
}

const char* tdax_sqdist_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
