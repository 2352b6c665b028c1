// Flash-attention forward for Hopper (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernel tdax/ops/flash_attention.py::_kernel
// (driven there by _flash_impl, _build_flash and mha).  Same function:
//
//   o[b, i, h, :] = sum_j softmax_j(s_ij) v[b, j, h, :],
//   s_ij = (q[b, i, h, :] . k[b, j, h, :]) * scale + bias[b, j]
//          (and NEG_INF where causal and j > i),
//
// with an online softmax over key tiles: the running max m, denominator
// l and accumulator stay in f32 on chip, m starts at the finite NEG_INF
// (-1e30), p is cast to v's type before the PV product, key tiles wholly
// above the causal diagonal are skipped, and the output is acc / l with
// l == 0 guarded to 1.  The finite NEG_INF is part of the semantics: a
// fully masked tile gives p = exp(0) = 1 until a real score arrives and
// alpha = exp(NEG_INF - m) = 0 then wipes it; -INFINITY would give NaN.
//
// Layout: q [B, Tq, nh, hd], k/v [B, Tk, nh, hd] read through their
// strides (the last dimension must be contiguous), so the strided views
// that the qkv split produces go in without a copy.  bias [B, Tk] f32.
// Output [B, Tq, nh, hd_v] contiguous, in q's type.  Any hd <= 128 with v
// of the same width; latent attention's v of its own width hd_v <= 128
// beside q and k of hd <= 192 (Kimi-VL: 192 and 128), through the
// instantiations with q.k over 192 padded columns and PV over 128.  The
// ragged hd, hd_v, Tq and Tk edges are masked here.
//
// What bounds it on an H100 (989 TFLOP/s bf16, 3.35 TB/s; the ridge is
// 295 flop/byte): each (batch, head) does 4*Tq*Tk*hd flops (half when
// causal) on (2*Tq + 2*Tk)*hd*2 bytes.  The ViT (T = 1024, hd 104) is
// at ~510 flop/byte, so the tensor cores bound it; the decoder (T = 320,
// causal, ~80) and the resampler (256 x 1024, ~205) are bound by memory.
// Either way the aim is to read q, k and v once and never write the
// scores: per block, the scores, softmax state and accumulator stay
// on chip.  This first design is
// simple and right: one block of 4 warps per (batch, head, 64-row q
// tile); k/v tiles of 64 rows are staged in shared memory and each warp
// runs mma.sync m16n8k16 (bf16 in, f32 accumulate) for QK^T and PV with
// the score tile kept in registers, so no [Tq, Tk] tensor ever reaches
// device memory.  It does not yet overlap loads with math (no cp.async
// or TMA pipeline) nor use wgmma; those are the known gaps to the bound.
//
// f32 inputs run as true f32 on the CUDA cores (FMA, never TF32): a
// straightforward tiled kernel used by the parity checks.
//
// With a non-null lse (training: tdax's with_lse, flash_attention.py:
// 229-235) the kernel also writes each row's log-normalizer m + log(l)
// into lse [B, nh, Tq] f32, for the backward kernels (flash_bwd.cu).  A
// row that sees no key gets lse = 0: l == 0 (as in tdax), or every score
// masked (m still at the finite NEG_INF floor), so that the backward's
// exp(s - lse) is 0 across the row and its gradient is zero whatever the
// tiling.  With lse null nothing else changes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;

// log-normalizer of a finished row; 0 for a row that saw no key
__device__ __forceinline__ float row_lse(float m, float l) {
  return (l == 0.f || m <= NEG_INF) ? 0.f : m + logf(l);
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;
  void* o;
  float* lse;  // [B, nh, Tq] or null
  int B, Tq, Tk, nh, hd, hd_v;
  long long q_sb, q_st, q_sh;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long o_sb, o_st, o_sh;
  long long bias_sb;
  int causal;
  float scale;
};

// ---------------------------------------------------------------- bf16 ---

constexpr int BM = 64;   // q rows per block (16 per warp)
constexpr int BN = 64;   // keys per tile
constexpr int NWARPS = 4;

// Copy `rows_valid` rows of hd elements into a [BM or BN][LDS] smem
// tile, zero-filling the rest (rows past T, columns past hd).
template <int HDP, bool VEC>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                               long long row_stride, int rows, int rows_valid,
                                               int hd, int tid) {
  constexpr int LDS = HDP + 8;
  if (VEC) {
    // 16-byte chunks: hd % 8 == 0, strides % 8 == 0, base 16-byte aligned
    constexpr int CPR = HDP / 8;
    for (int c = tid; c < rows * CPR; c += NWARPS * 32) {
      int r = c / CPR, col = (c % CPR) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows_valid && col < hd)
        val = *reinterpret_cast<const uint4*>(src + r * row_stride + col);
      *reinterpret_cast<uint4*>(dst + r * LDS + col) = val;
    }
  } else {
    for (int c = tid; c < rows * HDP; c += NWARPS * 32) {
      int r = c / HDP, col = c % HDP;
      __nv_bfloat16 val = __float2bfloat16(0.f);
      if (r < rows_valid && col < hd) val = src[r * row_stride + col];
      dst[r * LDS + col] = val;
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo (low half)
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16_raw(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
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

// HDP: q and k's padded width, HDV: v's and o's (HDP where they match)
template <int HDP, int HDV, bool VEC>
__global__ void __launch_bounds__(NWARPS * 32)
flash_fwd_bf16_kernel(Params p) {
  constexpr int LDS = HDP + 8;  // +16 bytes per row: conflict-free fragment loads
  constexpr int LDSV = HDV + 8;
  constexpr int KSTEPS = HDP / 16;
  constexpr int DTILES = HDV / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BM * LDS;
  __nv_bfloat16* Vs = Ks + BN * LDS;
  float* bias_s = reinterpret_cast<float*>(Vs + BN * LDSV);

  const int q0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;

  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh +
                            q0 * p.q_st;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* bg = p.bias + b * p.bias_sb;

  load_tile_bf16<HDP, VEC>(Qs, qg, p.q_st, BM, min(BM, p.Tq - q0), p.hd, tid);
  __syncthreads();

  // this warp's 16 q rows as mma A fragments, for every 16-wide hd step
  const int r0 = warp * 16 + g;
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const int c = kk * 16 + tig * 2;
    qf[kk][0] = *reinterpret_cast<const uint32_t*>(&Qs[r0 * LDS + c]);
    qf[kk][1] = *reinterpret_cast<const uint32_t*>(&Qs[(r0 + 8) * LDS + c]);
    qf[kk][2] = *reinterpret_cast<const uint32_t*>(&Qs[r0 * LDS + c + 8]);
    qf[kk][3] = *reinterpret_cast<const uint32_t*>(&Qs[(r0 + 8) * LDS + c + 8]);
  }

  float acc[DTILES][4];
#pragma unroll
  for (int dt = 0; dt < DTILES; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF};
  float l_run[2] = {0.f, 0.f};
  const int rows[2] = {q0 + r0, q0 + r0 + 8};

  int n_tiles = (p.Tk + BN - 1) / BN;
  if (p.causal) {
    // skip key tiles wholly above the diagonal of this q tile
    n_tiles = min(n_tiles, (q0 + BM - 1) / BN + 1);
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BN;
    __syncthreads();  // every warp is done with the previous k/v tile
    load_tile_bf16<HDP, VEC>(Ks, kg + k0 * p.k_st, p.k_st, BN, min(BN, p.Tk - k0), p.hd, tid);
    load_tile_bf16<HDV, VEC>(Vs, vg + k0 * p.v_st, p.v_st, BN, min(BN, p.Tk - k0), p.hd_v, tid);
    if (tid < BN) bias_s[tid] = (k0 + tid < p.Tk) ? bg[k0 + tid] : NEG_INF;
    __syncthreads();

    // s = q k^T for this warp's 16 rows x 64 keys, in registers
    float s[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* krow = &Ks[(nt * 8 + g) * LDS + tig * 2];
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        uint32_t b0 = *reinterpret_cast<const uint32_t*>(krow + kk * 16);
        uint32_t b1 = *reinterpret_cast<const uint32_t*>(krow + kk * 16 + 8);
        mma_bf16(s[nt], qf[kk], b0, b1);
      }
    }

    // scale, key bias (NEG_INF past Tk), causal mask
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kc = nt * 8 + tig * 2 + (e & 1);
        float val = __fadd_rn(__fmul_rn(s[nt][e], p.scale), bias_s[kc]);  // no contraction
        if (p.causal && k0 + kc > rows[e >> 1]) val = NEG_INF;
        s[nt][e] = val;
      }
    }

    // online softmax; each row is spread over the 4 threads of a quad
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = m_run[i];
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * i], s[nt][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float alpha = expf(m_run[i] - mx);
      float rs = 0.f;
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        const float p0 = expf(s[nt][2 * i] - mx);
        const float p1 = expf(s[nt][2 * i + 1] - mx);
        s[nt][2 * i] = p0;
        s[nt][2 * i + 1] = p1;
        rs += p0 + p1;
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l_run[i] = l_run[i] * alpha + rs;
      m_run[i] = mx;
#pragma unroll
      for (int dt = 0; dt < DTILES; ++dt) {
        acc[dt][2 * i] *= alpha;
        acc[dt][2 * i + 1] *= alpha;
      }
    }

    // acc += bf16(p) v: the score accumulators of two neighbouring key
    // n-tiles form one A fragment of 16 keys
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const int key = kk * 16 + tig * 2;
#pragma unroll
      for (int dt = 0; dt < DTILES; ++dt) {
        const int d = dt * 8 + g;
        uint32_t b0 = pack_bf16_raw(Vs[key * LDSV + d], Vs[(key + 1) * LDSV + d]);
        uint32_t b1 = pack_bf16_raw(Vs[(key + 8) * LDSV + d], Vs[(key + 9) * LDSV + d]);
        mma_bf16(acc[dt], a, b0, b1);
      }
    }
  }

  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= p.Tq) continue;
    if (p.lse && tig == 0)  // the quad's four threads hold the same m and l
      p.lse[((long long)b * p.nh + h) * p.Tq + rows[i]] = row_lse(m_run[i], l_run[i]);
    const float l = l_run[i] == 0.f ? 1.f : l_run[i];
    __nv_bfloat16* orow = og + rows[i] * p.o_st;
#pragma unroll
    for (int dt = 0; dt < DTILES; ++dt) {
      const int d = dt * 8 + tig * 2;
      if (d < p.hd_v) orow[d] = __float2bfloat16(acc[dt][2 * i] / l);
      if (d + 1 < p.hd_v) orow[d + 1] = __float2bfloat16(acc[dt][2 * i + 1] / l);
    }
  }
}

// ----------------------------------------------------------------- f32 ---

constexpr int FBM = 32;   // q rows per block
constexpr int FBN = 32;   // keys per tile
constexpr int FTHREADS = 128;

template <int HDP, int HDV>
__global__ void __launch_bounds__(FTHREADS)
flash_fwd_f32_kernel(Params p) {
  constexpr int LDS = HDP + 1;            // odd row stride: no bank conflicts
  constexpr int LDSV = HDV + 1;
  constexpr int PER = FBM * HDV / FTHREADS;  // accumulator elements per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + FBM * LDS;
  float* Vs = Ks + FBN * LDS;
  float* Ps = Vs + FBN * LDSV;            // [FBM][FBN + 1]
  float* bias_s = Ps + FBM * (FBN + 1);   // [FBN]
  float* m_s = bias_s + FBN;              // [FBM]
  float* l_s = m_s + FBM;                 // [FBM]
  float* alpha_s = l_s + FBM;             // [FBM]

  const int q0 = blockIdx.x * FBM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int hd = p.hd, hd_v = p.hd_v;

  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* bg = p.bias + b * p.bias_sb;

  for (int c = tid; c < FBM * HDP; c += FTHREADS) {
    const int r = c / HDP, d = c % HDP;
    Qs[r * LDS + d] = (q0 + r < p.Tq && d < hd) ? qg[(q0 + r) * p.q_st + d] : 0.f;
  }
  if (tid < FBM) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) acc[i] = 0.f;

  int n_tiles = (p.Tk + FBN - 1) / FBN;
  if (p.causal) n_tiles = min(n_tiles, (q0 + FBM - 1) / FBN + 1);

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * FBN;
    __syncthreads();
    for (int c = tid; c < FBN * HDP; c += FTHREADS) {
      const int r = c / HDP, d = c % HDP;
      Ks[r * LDS + d] = k0 + r < p.Tk && d < hd ? kg[(k0 + r) * p.k_st + d] : 0.f;
    }
    for (int c = tid; c < FBN * HDV; c += FTHREADS) {
      const int r = c / HDV, d = c % HDV;
      Vs[r * LDSV + d] = k0 + r < p.Tk && d < hd_v ? vg[(k0 + r) * p.v_st + d] : 0.f;
    }
    if (tid < FBN) bias_s[tid] = (k0 + tid < p.Tk) ? bg[k0 + tid] : NEG_INF;
    __syncthreads();

    for (int e = tid; e < FBM * FBN; e += FTHREADS) {
      const int r = e / FBN, c = e % FBN;
      float dot = 0.f;
      for (int d = 0; d < hd; ++d) dot = fmaf(Qs[r * LDS + d], Ks[c * LDS + d], dot);
      float val = __fadd_rn(__fmul_rn(dot, p.scale), bias_s[c]);
      if (p.causal && k0 + c > q0 + r) val = NEG_INF;
      Ps[r * (FBN + 1) + c] = val;
    }
    __syncthreads();

    if (tid < FBM) {
      float* prow = &Ps[tid * (FBN + 1)];
      float mx = m_s[tid];
      for (int c = 0; c < FBN; ++c) mx = fmaxf(mx, prow[c]);
      const float alpha = expf(m_s[tid] - mx);
      float rs = 0.f;
      for (int c = 0; c < FBN; ++c) {
        const float pv = expf(prow[c] - mx);
        prow[c] = pv;
        rs += pv;
      }
      l_s[tid] = l_s[tid] * alpha + rs;
      m_s[tid] = mx;
      alpha_s[tid] = alpha;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = tid + i * FTHREADS;
      const int r = e / HDV, d = e % HDV;
      const float* prow = &Ps[r * (FBN + 1)];
      float pv = 0.f;
      for (int c = 0; c < FBN; ++c) pv = fmaf(prow[c], Vs[c * LDSV + d], pv);
      acc[i] = acc[i] * alpha_s[r] + pv;
    }
  }
  __syncthreads();

  float* og = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;
  if (p.lse && tid < FBM && q0 + tid < p.Tq)
    p.lse[((long long)b * p.nh + h) * p.Tq + q0 + tid] = row_lse(m_s[tid], l_s[tid]);
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = tid + i * FTHREADS;
    const int r = e / HDV, d = e % HDV;
    if (q0 + r < p.Tq && d < hd_v) {
      const float l = l_s[r] == 0.f ? 1.f : l_s[r];
      og[(q0 + r) * p.o_st + d] = acc[i] / l;
    }
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, size_t smem, cudaStream_t stream,
                   const Params& p) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int HDP, int HDV = HDP>
cudaError_t launch_bf16(const Params& p, bool vec, cudaStream_t stream) {
  dim3 grid((p.Tq + BM - 1) / BM, p.nh, p.B);
  const size_t smem = ((size_t)(BM + BN) * (HDP + 8) + (size_t)BN * (HDV + 8)) *
                          sizeof(__nv_bfloat16) + BN * sizeof(float);
  if (vec) return launch(flash_fwd_bf16_kernel<HDP, HDV, true>, grid, NWARPS * 32, smem, stream, p);
  return launch(flash_fwd_bf16_kernel<HDP, HDV, false>, grid, NWARPS * 32, smem, stream, p);
}

template <int HDP, int HDV = HDP>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  dim3 grid((p.Tq + FBM - 1) / FBM, p.nh, p.B);
  const size_t smem = ((size_t)(FBM + FBN) * (HDP + 1) + (size_t)FBN * (HDV + 1) +
                       FBM * (FBN + 1) + FBN + 3 * FBM) * sizeof(float);
  return launch(flash_fwd_f32_kernel<HDP, HDV>, grid, FTHREADS, smem, stream, p);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  hd: q and k's width, hd_v: v's and
// o's.  vec (bf16 only): 1 when hd, hd_v and every q/k/v row stride are
// multiples of 8 and the bases are 16-byte aligned.
// lse: null, or [B, nh, Tq] f32 for the per-row log-normalizer.
// Returns the cudaError_t of the launch (0 = success).
int tdax_flash_fwd(const void* q, const void* k, const void* v, const float* bias, void* o,
                   int B, int Tq, int Tk, int nh, int hd, int hd_v,
                   long long q_sb, long long q_st, long long q_sh,
                   long long k_sb, long long k_st, long long k_sh,
                   long long v_sb, long long v_st, long long v_sh,
                   long long o_sb, long long o_st, long long o_sh,
                   long long bias_sb, int causal, float scale, int dtype, int vec,
                   float* lse, void* stream) {
  Params p{q, k, v, bias, o, lse, B, Tq, Tk, nh, hd, hd_v,
           q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, o_sb, o_st, o_sh,
           bias_sb, causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd < 1 || hd_v < 1 || hd_v > 128 || hd > (hd_v == hd ? 128 : 192) || B < 1 || Tq < 1 ||
      Tk < 1 || nh < 1)
    return (int)cudaErrorInvalidValue;
  if (hd_v != hd) {  // latent attention: q.k padded to 192 columns, PV to 128
    if (dtype == 1) return (int)launch_bf16<192, 128>(p, vec != 0, s);
    if (dtype == 0) return (int)launch_f32<192, 128>(p, s);
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 1) {
    if (hd <= 32) return (int)launch_bf16<32>(p, vec != 0, s);
    if (hd <= 64) return (int)launch_bf16<64>(p, vec != 0, s);
    if (hd <= 112) return (int)launch_bf16<112>(p, vec != 0, s);
    return (int)launch_bf16<128>(p, vec != 0, s);
  }
  if (dtype == 0) {
    if (hd <= 32) return (int)launch_f32<32>(p, s);
    if (hd <= 64) return (int)launch_f32<64>(p, s);
    return (int)launch_f32<128>(p, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* tdax_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
