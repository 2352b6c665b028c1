// The visual tower's elementwise passes, fused, for Hopper (sm_90a), with a
// plain C interface.
//
// Replaces no TPU kernel.  tdax writes these passes as plain jnp
// expressions (tdax/models/qwen_vl/vit.py: layer_norm, gelu_tanh, the bias
// and residual adds) and XLA fuses them on the TPU.  PyTorch runs each
// operation of those expressions as its own pass over device memory: a
// ViT-bigG block moves ~7.4 GB that way, where the fused passes below move
// 1.41 GB.  Two kernels keep tdax's roundings exactly:
//
// vit_ln_rows: y = LayerNorm(x) * w + b over the last dimension of x [R, C]
//   (bf16 or f32), bit for bit the plain version as PyTorch runs it on the
//   card: the row mean in f32 (the sum times R / (R * C) in f32, as
//   PyTorch's mean scales its sum); the population variance of the centred
//   values in f32, two-pass (the square rounded before it is summed);
//   (x - mean) * rsqrtf(var + eps) in f32, rounded to x's type; * w,
//   rounded; + b, rounded.  No product is contracted into an fma, since
//   the plain version rounds each one.  Both sums follow PyTorch's CUDA
//   reduce (ATen/native/cuda/Reduce.cuh) for an f32 row of C: `lanes`
//   threads a row (its block width: a warp from 16 rows up), each with four
//   accumulators (rows of 128 or more in 16-byte f32 vectors, accumulator
//   k taking element k of the thread's vectors lane, lane + lanes, ...;
//   shorter rows element by element, element n of the thread's into
//   accumulator n % 4), then ((a0 + a1) + a2) + a3, then the lanes by
//   halves.  So every card path that held the plain LayerNorm keeps its
//   bits, a W8A8 capture's int8 roundings among them (a summation order
//   that moves a value by an ulp moves an activation by a whole level
//   there).
//   Bound on an H100: bytes.  x read once and y written once: 4 bytes an
//   element in bf16, 109.1 MB and 33 us at [16384, 1664] and 3.35 TB/s.
//   Design: the row is read once, in the reduce's pattern (8-byte loads of
//   four bf16, 16-byte of four f32, coalesced across the lanes), into
//   shared memory, where each thread keeps its own elements for the
//   variance and the write; blocks of 128 threads hold 128 / lanes rows
//   (fewer where a row's stash passes 48 KB).  Every row of x and y starts
//   on a 16-byte boundary and C is a whole number of 16-byte vectors, as at
//   every width of ViT-bigG and of its shards under tp; the launch refuses
//   any other layout.

// vit_bias_epilogue: out = p + b (MODE_BIAS), gelu_tanh(p + b) (MODE_GELU)
//   or res + (p + b) (MODE_RESIDUAL) over p [R, N] with b [N], p + b
//   rounded to the type before the GELU or the residual add, the GELU in
//   f32 as PyTorch's tanh form computes it (precise tanhf), the result
//   rounded once.  out may be p itself (in place on the product's output).
//   Bound: bytes.  p read and out written (plus res read): in bf16
//   [16384, 8192] with the GELU moves 536.9 MB, 160 us at 3.35 TB/s; the
//   GELU's ~30 f32 instructions an element come to a similar time on the
//   SMs' ALUs, so that form is near both bounds.
//   Design: a grid-stride loop over 16-byte vectors of p (rows on 16-byte
//   boundaries, as for vit_ln_rows), eight blocks of 256 threads an SM,
//   the bias vector read through the read-only cache; the (row, column) of
//   the next vector is stepped, not divided.
//
// Kernel names: neither contains a family string of the benchmark's
// per-layer readers, so both stay inside the elementwise time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LN_BLOCK = 128;          // threads of a LayerNorm block, where rows allow
constexpr int LN_MAX_LANES = 512;      // threads a row, at most (PyTorch's widest block)
constexpr int LN_STASH_BYTES = 48 << 10;  // shared memory a block stashes its rows in
constexpr int EPI_THREADS = 256;

enum { MODE_BIAS = 0, MODE_GELU = 1, MODE_RESIDUAL = 2 };

// storage <-> f32, rounding to nearest even as PyTorch's casts do
struct BF16 {
  using S = uint16_t;
  static __device__ __forceinline__ float load(S s) { return __uint_as_float(uint32_t(s) << 16); }
  static __device__ __forceinline__ S store(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};
struct F32 {
  using S = float;
  static __device__ __forceinline__ float load(S s) { return s; }
  static __device__ __forceinline__ S store(float v) { return v; }
};

// the value a tensor of the type holds after a cast of v
template <typename K>
__device__ __forceinline__ float round_to(float v) {
  return K::load(K::store(v));
}

// elements in a 16-byte vector
template <typename S>
constexpr int kVec = 16 / sizeof(S);

// one 16-byte vector, loaded and stored as one
template <typename S>
struct alignas(16) Vec {
  S s[kVec<S>];
};

// PyTorch's tanh GELU in f32 (ATen's GeluCUDAKernelImpl), written as it
// writes it so that the compiler contracts the same products
__device__ __forceinline__ float gelu_tanh(float x) {
  constexpr float kBeta = 1.41421356237309504880 * 1.12837916709551257390 * 0.5;
  constexpr float kKappa = 0.044715;
  const float x_cube = x * x * x;
  const float inner = kBeta * (x + kKappa * x_cube);
  return 0.5f * x * (1.f + tanhf(inner));
}

// four consecutive elements, loaded and stored as one: the f32 vector in
// which PyTorch's reduce reads a row
template <typename S>
struct alignas(4 * sizeof(S)) Quad {
  S s[4];
};

// the sum of f over a thread's share of its row (the stash), in PyTorch's
// per-thread order: four accumulators from 0, each in the order of its
// elements, then ((a0 + a1) + a2) + a3
template <typename S, typename F>
__device__ __forceinline__ float thread_sum(const S* row, int cols, int lanes, int lane,
                                            bool vectorized, F f) {
  float a[4] = {0.f, 0.f, 0.f, 0.f};
  if (vectorized) {
    for (int v = lane; v < cols / 4; v += lanes) {
      const Quad<S> q = reinterpret_cast<const Quad<S>*>(row)[v];
#pragma unroll
      for (int k = 0; k < 4; ++k) a[k] = __fadd_rn(a[k], f(q.s[k]));
    }
  } else {
    for (int e = lane; e < cols; e += 4 * lanes) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (e + i * lanes < cols) a[i] = __fadd_rn(a[i], f(row[e + i * lanes]));
    }
  }
  return __fadd_rn(__fadd_rn(__fadd_rn(a[0], a[1]), a[2]), a[3]);
}

// the sum of v over the row's `lanes` threads in PyTorch's block_x_reduce
// order: halves through shared memory down to a warp, then halves by
// shuffles (by xor, so every lane ends with lane 0's sum, bit for bit, as
// a + b == b + a).  Every thread of the block calls it.
__device__ __forceinline__ float row_total(float v, int lanes, int lane, int slot, float* red,
                                           float* total) {
  if (lanes <= 32) {
    for (int o = lanes >> 1; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
  }
  float* r = red + slot * lanes;
  r[lane] = v;
  for (int off = lanes >> 1; off >= 32; off >>= 1) {
    __syncthreads();
    if (lane < off) {
      v = __fadd_rn(v, r[lane + off]);
      r[lane] = v;
    }
  }
  __syncthreads();
  if (lane < 32) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) total[slot] = v;
  }
  __syncthreads();
  v = total[slot];
  __syncthreads();  // red and total are free for the next sum
  return v;
}

template <typename K>
__global__ void __launch_bounds__(LN_MAX_LANES)
vit_ln_rows(const typename K::S* __restrict__ x, const typename K::S* __restrict__ w,
            const typename K::S* __restrict__ b, typename K::S* __restrict__ out, int rows,
            int cols, long long ldx, long long ldo, int lanes, int vectorized, float factor,
            float eps) {
  using S = typename K::S;
  extern __shared__ __align__(16) unsigned char ln_stash[];
  __shared__ float red[LN_MAX_LANES];
  __shared__ float total[LN_BLOCK / 32];
  const int lane = threadIdx.x % lanes;
  const int slot = threadIdx.x / lanes;
  const long long row = (long long)blockIdx.x * (blockDim.x / lanes) + slot;
  const bool live = row < rows;
  S* stash = reinterpret_cast<S*>(ln_stash) + (long long)slot * cols;
  const int quads = cols / 4;

  // the thread's elements into the stash, read in the reduce's pattern
  if (live) {
    const S* xr = x + row * ldx;
    if (vectorized) {
#pragma unroll 4
      for (int v = lane; v < quads; v += lanes)
        reinterpret_cast<Quad<S>*>(stash)[v] = reinterpret_cast<const Quad<S>*>(xr)[v];
    } else {
      for (int e = lane; e < cols; e += lanes) stash[e] = xr[e];
    }
  }
  const auto value = [](S s) { return K::load(s); };
  const float sum = live ? thread_sum(stash, cols, lanes, lane, vectorized, value) : 0.f;
  const float mean = __fmul_rn(row_total(sum, lanes, lane, slot, red, total), factor);
  const auto square = [mean](S s) {
    const float d = __fsub_rn(K::load(s), mean);
    return __fmul_rn(d, d);
  };
  const float sq = live ? thread_sum(stash, cols, lanes, lane, vectorized, square) : 0.f;
  const float var = __fmul_rn(row_total(sq, lanes, lane, slot, red, total), factor);
  const float rs = rsqrtf(__fadd_rn(var, eps));
  if (!live) return;
  const auto norm = [mean, rs](S s, S ws, S bs) {
    const float y = round_to<K>(__fmul_rn(__fsub_rn(K::load(s), mean), rs));
    const float yw = round_to<K>(__fmul_rn(y, K::load(ws)));
    return K::store(__fadd_rn(yw, K::load(bs)));
  };
  S* orow = out + row * ldo;
  if (vectorized) {
    for (int v = lane; v < quads; v += lanes) {
      const Quad<S> q = reinterpret_cast<const Quad<S>*>(stash)[v];
      const Quad<S> wq = reinterpret_cast<const Quad<S>*>(w)[v];
      const Quad<S> bq = reinterpret_cast<const Quad<S>*>(b)[v];
      Quad<S> o;
#pragma unroll
      for (int k = 0; k < 4; ++k) o.s[k] = norm(q.s[k], wq.s[k], bq.s[k]);
      reinterpret_cast<Quad<S>*>(orow)[v] = o;
    }
  } else {
    for (int e = lane; e < cols; e += lanes) orow[e] = norm(stash[e], w[e], b[e]);
  }
}

template <typename K, int MODE>
__global__ void __launch_bounds__(EPI_THREADS)
vit_bias_epilogue(const typename K::S* p, const typename K::S* __restrict__ b,
                  const typename K::S* __restrict__ res, typename K::S* out, int rows, int cols,
                  long long ldp, long long ldr, long long ldo) {
  using V = Vec<typename K::S>;
  constexpr int VEC = kVec<typename K::S>;
  const long long nvec = cols / VEC;
  const long long start = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long row = start / nvec, col = start - row * nvec;
  const long long srow = stride / nvec, scol = stride - srow * nvec;
  while (row < rows) {
    const V pv = *reinterpret_cast<const V*>(p + row * ldp + col * VEC);
    const V bv = *reinterpret_cast<const V*>(b + col * VEC);
    V rv;
    if (MODE == MODE_RESIDUAL) rv = *reinterpret_cast<const V*>(res + row * ldr + col * VEC);
    V o;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      float h = round_to<K>(__fadd_rn(K::load(pv.s[k]), K::load(bv.s[k])));
      if (MODE == MODE_GELU) h = gelu_tanh(h);
      if (MODE == MODE_RESIDUAL) h = __fadd_rn(K::load(rv.s[k]), h);
      o.s[k] = K::store(h);
    }
    *reinterpret_cast<V*>(out + row * ldo + col * VEC) = o;
    col += scol;
    row += srow;
    if (col >= nvec) {
      col -= nvec;
      ++row;
    }
  }
}

bool misaligned(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 != 0; }

struct LnArgs {
  const void *x, *w, *b;
  void* out;
  int rows, cols;
  long long ldx, ldo;
  int lanes, vectorized;
  float factor, eps;
};

template <typename K>
int ln_launch(const LnArgs& a, cudaStream_t s) {
  using S = typename K::S;
  constexpr int V = kVec<S>;
  if (a.cols % V || a.ldx % V || a.ldo % V) return (int)cudaErrorInvalidValue;
  if (misaligned(a.x) || misaligned(a.w) || misaligned(a.b) || misaligned(a.out))
    return (int)cudaErrorMisalignedAddress;
  const long long row_bytes = (long long)a.cols * sizeof(S);
  if (row_bytes > LN_STASH_BYTES) return (int)cudaErrorInvalidValue;
  int per = a.lanes < LN_BLOCK ? LN_BLOCK / a.lanes : 1;  // rows a block
  while (per > 1 && per * row_bytes > LN_STASH_BYTES && per * a.lanes > 32) per >>= 1;
  const unsigned grid = (unsigned)((a.rows + per - 1) / per);
  vit_ln_rows<K><<<grid, per * a.lanes, per * row_bytes, s>>>(
      static_cast<const S*>(a.x), static_cast<const S*>(a.w), static_cast<const S*>(a.b),
      static_cast<S*>(a.out), a.rows, a.cols, a.ldx, a.ldo, a.lanes, a.vectorized, a.factor,
      a.eps);
  return (int)cudaGetLastError();
}

struct EpiArgs {
  const void *p, *b, *res;
  void* out;
  int rows, cols;
  long long ldp, ldr, ldo;
  int blocks;
};

template <typename K, int MODE>
int epi_launch(const EpiArgs& a, cudaStream_t s) {
  using S = typename K::S;
  vit_bias_epilogue<K, MODE><<<a.blocks, EPI_THREADS, 0, s>>>(
      static_cast<const S*>(a.p), static_cast<const S*>(a.b), static_cast<const S*>(a.res),
      static_cast<S*>(a.out), a.rows, a.cols, a.ldp, a.ldr, a.ldo);
  return (int)cudaGetLastError();
}

template <typename K>
int epi_dtype(const EpiArgs& a, int mode, cudaStream_t s) {
  constexpr int V = kVec<typename K::S>;
  if (a.cols % V || a.ldp % V || a.ldo % V || (mode == MODE_RESIDUAL && a.ldr % V))
    return (int)cudaErrorInvalidValue;
  if (misaligned(a.p) || misaligned(a.b) || misaligned(a.res) || misaligned(a.out))
    return (int)cudaErrorMisalignedAddress;
  switch (mode) {
    case MODE_BIAS: return epi_launch<K, MODE_BIAS>(a, s);
    case MODE_GELU: return epi_launch<K, MODE_GELU>(a, s);
    case MODE_RESIDUAL: return epi_launch<K, MODE_RESIDUAL>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x [rows, cols] with row stride ldx, out [rows, cols] with row stride ldo,
// w and b [cols], all of one type (dtype 0 = f32, 1 = bf16); cols, ldx
// and ldo whole 16-byte vectors, every base 16-byte aligned; lanes threads
// a row (a power of two up to 512) and vectorized (0 or 1, the f32 rows
// read in vectors of four) as PyTorch's reduce takes an f32 [rows, cols]
// over its last dimension; factor = rows / (rows * cols) in f32.  Returns
// the cudaError_t of the launch (0 = success).
int tdax_vit_ln_rows(const void* x, const void* w, const void* b, void* out, int rows, int cols,
                     long long ldx, long long ldo, int lanes, int vectorized, float factor,
                     float eps, int dtype, void* stream) {
  if (rows < 1 || cols < 1 || ldx < cols || ldo < cols) return (int)cudaErrorInvalidValue;
  if (lanes < 1 || lanes > LN_MAX_LANES || (lanes & (lanes - 1)) || (vectorized & ~1))
    return (int)cudaErrorInvalidValue;
  const LnArgs a{x, w, b, out, rows, cols, ldx, ldo, lanes, vectorized, factor, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return ln_launch<F32>(a, s);
  if (dtype == 1) return ln_launch<BF16>(a, s);
  return (int)cudaErrorInvalidValue;
}

// p, out [rows, cols] (out may be p), res [rows, cols] for mode 2 (else
// null), b [cols], all of one type, laid out as for tdax_vit_ln_rows; mode
// 0 = p + b, 1 = gelu_tanh(p + b), 2 = res + (p + b); blocks of 256
// threads walk the vectors.  Returns the cudaError_t of the launch (0 =
// success).
int tdax_vit_bias_epilogue(const void* p, const void* b, const void* res, void* out, int rows,
                           int cols, long long ldp, long long ldr, long long ldo, int mode,
                           int dtype, int blocks, void* stream) {
  if (rows < 1 || cols < 1 || ldp < cols || ldo < cols || blocks < 1)
    return (int)cudaErrorInvalidValue;
  if (mode == MODE_RESIDUAL ? (res == nullptr || ldr < cols) : res != nullptr)
    return (int)cudaErrorInvalidValue;
  const EpiArgs a{p, b, res, out, rows, cols, ldp, ldr, ldo, blocks};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return epi_dtype<F32>(a, mode, s);
  if (dtype == 1) return epi_dtype<BF16>(a, mode, s);
  return (int)cudaErrorInvalidValue;
}

const char* tdax_vit_elementwise_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
