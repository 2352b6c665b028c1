// Weight-only int8 matrix product for Hopper (sm_90a), with a plain C
// interface.
//
// Replaces the Pallas TPU kernel tdax/ops/quant_matmul.py::_qmm_kernel
// (driven there by _qmm_2d, quant_matmul and qdot).  Same function:
//
//   out[m, n] = cast_to_x_dtype( (sum_k x[m, k] * q[k, n]) * s[n] ),
//
// x [M, K] bf16 or f32 (contiguous rows, any row stride), q [K, N] int8
// row-major, s [N] f32, out [M, N] contiguous in x's type.  The product
// accumulates in f32; the scale is applied once, at the single write,
// then one cast.  The int8 weight is converted inside the K loop, so it
// crosses device memory as one byte per weight.  Ragged M, N and K are
// masked here (zero fill), with no padded copy.
//
// What bounds it on an H100 (989 TFLOP/s bf16, 3.35 TB/s; ridge 295
// flop/byte): a product does 2*M*N*K flops on M*K*2 + K*N + 4*N +
// M*N*2 bytes.  At the capture's M (16*1024 ViT rows, 16*320 decoder
// rows) it is thousands of flops per byte, so the tensor cores bound it;
// at decode (M = 16) it is ~32 flops per weight byte, so reading the
// int8 weight bounds it, and int8 halves those bytes against bf16.
//
// This first design is simple and right:
//   * bf16: one block per (BM x BN) output tile; K in chunks of BK staged
//     through shared memory, x as bf16 and q as raw bytes, double-
//     buffered: the next chunk is read into registers while the current
//     one is multiplied.  Each warp runs mma.sync m16n8k16 (bf16 in, f32
//     accumulate) on its (WM x WN) sub-tile; the B fragments are built
//     from the int8 bytes in shared memory and converted to bf16 there
//     (exact: |q| <= 127 fits bf16's 8-bit significand).  Two tilings:
//     128 x 128 (8 warps) for large M, 16 x 32 with a deep K chunk
//     (4 warps) for small M, so that a decode step still spreads over the
//     SMs.  It does not use ldmatrix, cp.async/TMA or wgmma yet: those
//     are the known gaps to the bound.
//   * f32: true f32 on the CUDA cores (FMA, never TF32), 64 x 64 tiles of
//     4 x 4 per thread: the parity configuration.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

struct Params {
  const void* x;
  const int8_t* q;
  const float* s;
  void* out;
  int M, N, K;
  long long ldx;  // x's row stride, elements
};

// ---------------------------------------------------------------- bf16 ---

__device__ __forceinline__ uint32_t cvt_pair(int8_t lo, int8_t hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn((float)lo, (float)hi);  // .x = lo (low half)
  return *reinterpret_cast<uint32_t*>(&v);
}

// D = A(16x16, row) * B(16x8, col) + D, bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 8 bf16 of x (row r, columns c..c+7) as one 16-byte chunk, zero past M/K.
template <bool VEC>
__device__ __forceinline__ uint4 load_x_chunk(const uint16_t* x, long long ldx, int M, int K,
                                              int r, int c) {
  if (VEC) {  // K % 8 == 0, ldx % 8 == 0, base 16-byte aligned
    if (r < M && c < K) return *reinterpret_cast<const uint4*>(x + r * ldx + c);
    return make_uint4(0u, 0u, 0u, 0u);
  }
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  if (r < M) {
    const uint16_t* row = x + r * ldx;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (c + i < K) w[i >> 1] |= (uint32_t)row[c + i] << (16 * (i & 1));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// 16 int8 of q (row k, columns n..n+15) as one 16-byte chunk, zero past K/N.
template <bool VEC>
__device__ __forceinline__ uint4 load_q_chunk(const int8_t* q, int N, int K, int k, int n) {
  if (VEC) {  // N % 16 == 0, base 16-byte aligned
    if (k < K && n < N) return *reinterpret_cast<const uint4*>(q + (long long)k * N + n);
    return make_uint4(0u, 0u, 0u, 0u);
  }
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  if (k < K) {
    const uint8_t* row = reinterpret_cast<const uint8_t*>(q) + (long long)k * N;
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (n + i < N) w[i >> 2] |= (uint32_t)row[n + i] << (8 * (i & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <int BM, int BN, int BK, int WM, int WN>
struct Tile {
  static constexpr int WARPS_M = BM / WM, WARPS_N = BN / WN;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int MT = WM / 16, NT = WN / 8;
  static constexpr int LDA = BK + 8;   // bf16 per smem row: +16 bytes, conflict-free fragments
  static constexpr int LDB = BN + 16;  // bytes per smem row: keeps 16-byte alignment
  static constexpr int X_CHUNKS = BM * BK / 8 / THREADS;
  static constexpr int Q_CHUNKS = BK * BN / 16 / THREADS;
  static_assert(BM * BK / 8 % THREADS == 0 && BK * BN / 16 % THREADS == 0, "chunking");
  static_assert(WM % 16 == 0 && WN % 8 == 0 && BK % 16 == 0, "mma shape");
};

template <int BM, int BN, int BK, int WM, int WN, bool VEC>
__global__ void __launch_bounds__(Tile<BM, BN, BK, WM, WN>::THREADS)
qmm_bf16_kernel(Params p) {
  using T = Tile<BM, BN, BK, WM, WN>;
  constexpr int LDA = T::LDA, LDB = T::LDB, MT = T::MT, NT = T::NT;
  __shared__ __align__(16) uint16_t As[2][BM * LDA];
  __shared__ __align__(16) int8_t Bs[2][BK * LDB];

  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int wm0 = (warp / T::WARPS_N) * WM;
  const int wn0 = (warp % T::WARPS_N) * WN;

  const uint16_t* x = static_cast<const uint16_t*>(p.x) + (long long)m0 * p.ldx;
  const int Mb = p.M - m0;  // rows of this block that exist (may exceed BM)

  uint4 xr[T::X_CHUNKS], qr[T::Q_CHUNKS];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < T::X_CHUNKS; ++i) {
      const int c = tid + i * T::THREADS;
      xr[i] = load_x_chunk<VEC>(x, p.ldx, Mb, p.K, c / (BK / 8), k0 + (c % (BK / 8)) * 8);
    }
#pragma unroll
    for (int i = 0; i < T::Q_CHUNKS; ++i) {
      const int c = tid + i * T::THREADS;
      qr[i] = load_q_chunk<VEC>(p.q, p.N, p.K, k0 + c / (BN / 16), n0 + (c % (BN / 16)) * 16);
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int i = 0; i < T::X_CHUNKS; ++i) {
      const int c = tid + i * T::THREADS;
      *reinterpret_cast<uint4*>(&As[buf][(c / (BK / 8)) * LDA + (c % (BK / 8)) * 8]) = xr[i];
    }
#pragma unroll
    for (int i = 0; i < T::Q_CHUNKS; ++i) {
      const int c = tid + i * T::THREADS;
      *reinterpret_cast<uint4*>(&Bs[buf][(c / (BN / 16)) * LDB + (c % (BN / 16)) * 16]) = qr[i];
    }
  };

  float acc[MT][NT][4] = {};

  const int n_chunks = (p.K + BK - 1) / BK;
  fetch(0);
  stash(0);
  __syncthreads();
  for (int kc = 0; kc < n_chunks; ++kc) {
    const int buf = kc & 1;
    if (kc + 1 < n_chunks) fetch((kc + 1) * BK);  // in flight while this chunk multiplies
    const uint16_t* A = As[buf];
    const int8_t* B = Bs[buf];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r = wm0 + mt * 16 + g, c = kk * 16 + tig * 2;
        af[mt][0] = *reinterpret_cast<const uint32_t*>(&A[r * LDA + c]);
        af[mt][1] = *reinterpret_cast<const uint32_t*>(&A[(r + 8) * LDA + c]);
        af[mt][2] = *reinterpret_cast<const uint32_t*>(&A[r * LDA + c + 8]);
        af[mt][3] = *reinterpret_cast<const uint32_t*>(&A[(r + 8) * LDA + c + 8]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = wn0 + nt * 8 + g, k = kk * 16 + tig * 2;
        const uint32_t b0 = cvt_pair(B[k * LDB + n], B[(k + 1) * LDB + n]);
        const uint32_t b1 = cvt_pair(B[(k + 8) * LDB + n], B[(k + 9) * LDB + n]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][nt], af[mt], b0, b1);
      }
    }
    if (kc + 1 < n_chunks) stash(buf ^ 1);  // last read of buf ^ 1 was before the previous sync
    __syncthreads();
  }

  // epilogue: scale per output channel, one cast, masked store
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = n0 + wn0 + nt * 8 + tig * 2;
    const float s0 = col < p.N ? p.s[col] : 0.f;
    const float s1 = col + 1 < p.N ? p.s[col + 1] : 0.f;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm0 + mt * 16 + g + 8 * h;
        if (row >= p.M) continue;
        __nv_bfloat16* o = out + (long long)row * p.N + col;
        const float v0 = acc[mt][nt][2 * h] * s0, v1 = acc[mt][nt][2 * h + 1] * s1;
        if (col + 1 < p.N && (p.N & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
        } else {
          if (col < p.N) o[0] = __float2bfloat16(v0);
          if (col + 1 < p.N) o[1] = __float2bfloat16(v1);
        }
      }
    }
  }
}

// ----------------------------------------------------------------- f32 ---

constexpr int FB = 64;       // output tile FB x FB
constexpr int FBK = 16;      // K chunk
constexpr int FTHREADS = 256;

__global__ void __launch_bounds__(FTHREADS) qmm_f32_kernel(Params p) {
  __shared__ float As[FBK][FB + 1];  // [k][m]
  __shared__ float Bs[FBK][FB];      // [k][n], q converted to f32
  const int n0 = blockIdx.x * FB, m0 = blockIdx.y * FB;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const float* x = static_cast<const float*>(p.x);
  float acc[4][4] = {};
  for (int k0 = 0; k0 < p.K; k0 += FBK) {
    for (int e = tid; e < FB * FBK; e += FTHREADS) {
      const int r = e / FBK, k = e % FBK;  // consecutive threads along k
      As[k][r] = (m0 + r < p.M && k0 + k < p.K) ? x[(long long)(m0 + r) * p.ldx + k0 + k] : 0.f;
      const int kb = e / FB, n = e % FB;
      Bs[kb][n] = (k0 + kb < p.K && n0 + n < p.N) ? (float)p.q[(long long)(k0 + kb) * p.N + n0 + n]
                                                  : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FBK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = static_cast<float*>(p.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= p.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < p.N) out[(long long)row * p.N + col] = acc[i][j] * p.s[col];
    }
  }
}

template <int BM, int BN, int BK, int WM, int WN>
cudaError_t launch_bf16(const Params& p, bool vec, cudaStream_t stream) {
  const dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  constexpr int threads = Tile<BM, BN, BK, WM, WN>::THREADS;
  if (vec)
    qmm_bf16_kernel<BM, BN, BK, WM, WN, true><<<grid, threads, 0, stream>>>(p);
  else
    qmm_bf16_kernel<BM, BN, BK, WM, WN, false><<<grid, threads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  vec (bf16 only): 1 when K, ldx and N
// allow 16-byte loads (K % 8 == 0, ldx % 8 == 0, N % 16 == 0) and the x
// and q bases are 16-byte aligned.  Returns the cudaError_t of the launch
// (0 = success).
int tdax_qmm(const void* x, const int8_t* q, const float* s, void* out, int M, int N, int K,
             long long ldx, int dtype, int vec, void* stream) {
  const Params p{x, q, s, out, M, N, K, ldx};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M < 1 || N < 1 || K < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    if (M <= 64) return (int)launch_bf16<16, 32, 256, 16, 8>(p, vec != 0, st);
    return (int)launch_bf16<128, 128, 32, 64, 32>(p, vec != 0, st);
  }
  if (dtype == 0) {
    const dim3 grid((N + FB - 1) / FB, (M + FB - 1) / FB);
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    qmm_f32_kernel<<<grid, FTHREADS, 0, st>>>(p);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

const char* tdax_qmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
