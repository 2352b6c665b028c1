// Flash-attention backward for Hopper (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernels tdax/ops/flash_attention.py::_bwd_dq_kernel
// and ::_bwd_dkv_kernel (driven there by _flash_bwd_impl and _build_flash).
// Same function.  With the forward's per-row log-normalizer lse and
// delta_i = sum_d dO[i, d] O[i, d] (computed outside, in f32):
//
//   s_ij  = (q_i . k_j) * scale + bias_j      (masked where causal and j > i)
//   p_ij  = exp(s_ij - lse_i)                 (0 where masked)
//   dp_ij = dO_i . v_j
//   ds_ij = p_ij * (dp_ij - delta_i) * scale
//   dq_i  = sum_j ds_ij k_j,  dk_j = sum_i ds_ij q_i,  dv_j = sum_i p_ij dO_i
//
// Two kernels, as in tdax.  The dq kernel runs one block per (q tile,
// head, batch) and streams k/v tiles; the dk/dv kernel runs one block per
// (k tile, head, batch) and streams q/dO tiles.  Each recomputes its own
// probability tile from lse, so nothing of size [Tq, Tk] reaches device
// memory, and each output element is summed by one thread in a fixed
// order: no atomics, so the result is deterministic.  Tiles wholly above
// the causal diagonal are skipped.  bf16 casts follow tdax: p (for dv)
// and ds (for dq and dk) are rounded to bf16 before their products, and
// every product accumulates in f32; outputs are written in q's type.
//
// Layout: q/dO [B, Tq, nh, hd], k/v [B, Tk, nh, hd] read through their
// strides (last dimension contiguous), so v may be a view of the fused
// qkv projection.  bias [B, Tk], lse and delta [B, nh, Tq] f32.  dq
// [B, Tq, nh, hd], dk/dv [B, Tk, nh, hd] through the strides given
// (contiguous from the wrapper).  Any hd <= 128; ragged hd, Tq and Tk are
// masked here.
//
// What bounds it on an H100 (989 TFLOP/s bf16, 3.35 TB/s): the dq kernel
// does three products of 2*Tq*Tk*hd flops per (batch, head), the dk/dv
// kernel four (half of each when causal), on (2*Tq + 2*Tk)*hd*2 bytes of
// inputs; at the decoder's training shape [4, 1024, 32, 128] that is
// ~500 flop/byte, above the ridge (295), so the tensor cores bound both.
// This first design is simple and right: bf16 runs mma.sync m16n8k16
// (f32 accumulate) from shared-memory tiles with 4 warps a block, every
// fragment read with plain 32-bit shared loads; the dq kernel keeps a
// 64-row q tile and its dO in shared memory and streams 64-key k/v
// tiles, the dk/dv kernel keeps a 64-key k/v tile and streams 32-row q/dO
// tiles (two accumulators of 16 keys x hd per warp keep it within the
// register file).  No ldmatrix, no cp.async/TMA pipeline, no wgmma:
// those are the known gaps to the bound.
//
// f32 inputs run as true f32 on the CUDA cores (FMA, never TF32): a
// straightforward tiled version used by the parity checks.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* bias;
  const float* lse;    // [B, nh, Tq]
  const float* delta;  // [B, nh, Tq]
  void* dq;
  void* dk;
  void* dv;
  int B, Tq, Tk, nh, hd;
  long long q_sb, q_st, q_sh;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long do_sb, do_st, do_sh;
  long long dq_sb, dq_st, dq_sh;
  long long dk_sb, dk_st, dk_sh;  // dk and dv share one layout
  long long bias_sb;
  int causal;
  float scale;
};

// ---------------------------------------------------------------- bf16 ---

constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int BM = 64;   // dq kernel: q rows per block (16 per warp)
constexpr int BN = 64;   // dq kernel: keys per streamed tile
constexpr int BK = 64;   // dk/dv kernel: keys per block (16 per warp)
constexpr int BQ = 32;   // dk/dv kernel: q rows per streamed tile

// Copy `rows_valid` rows of hd elements into a [rows][LDS] smem tile,
// zero-filling the rest (rows past T, columns past hd).
template <int HDP, bool VEC>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                               long long row_stride, int rows, int rows_valid,
                                               int hd, int tid) {
  constexpr int LDS = HDP + 8;
  if (VEC) {
    // 16-byte chunks: hd % 8 == 0, strides % 8 == 0, base 16-byte aligned
    constexpr int CPR = HDP / 8;
    for (int c = tid; c < rows * CPR; c += NTHREADS) {
      int r = c / CPR, col = (c % CPR) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows_valid && col < hd)
        val = *reinterpret_cast<const uint4*>(src + r * row_stride + col);
      *reinterpret_cast<uint4*>(dst + r * LDS + col) = val;
    }
  } else {
    for (int c = tid; c < rows * HDP; c += NTHREADS) {
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

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D = A(16x16, row) * B(16x8, col) + D, bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of rows r, r + 8 and columns c.., c + 8.. of a [.][LDS] tile.
template <int LDS>
__device__ __forceinline__ void load_a(uint32_t* a, const __nv_bfloat16* tile, int r, int c) {
  a[0] = ld32(&tile[r * LDS + c]);
  a[1] = ld32(&tile[(r + 8) * LDS + c]);
  a[2] = ld32(&tile[r * LDS + c + 8]);
  a[3] = ld32(&tile[(r + 8) * LDS + c + 8]);
}

// Two neighbouring 8-column accumulator tiles as one bf16 A fragment of
// 16 columns (the forward's P -> PV trick).
__device__ __forceinline__ void acc_to_a(uint32_t* a, const float* lo, const float* hi) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// acc[dt] += A(16 x 16) * T[r0 .. r0 + 16][dt * 8 ..], T a [.][LDS] tile
// whose rows are the contraction index.
template <int LDS, int DTILES>
__device__ __forceinline__ void mma_rows(float (*acc)[4], const uint32_t* a,
                                         const __nv_bfloat16* tile, int r0, int g) {
#pragma unroll
  for (int dt = 0; dt < DTILES; ++dt) {
    const int d = dt * 8 + g;
    uint32_t b0 = pack_bf16_raw(tile[r0 * LDS + d], tile[(r0 + 1) * LDS + d]);
    uint32_t b1 = pack_bf16_raw(tile[(r0 + 8) * LDS + d], tile[(r0 + 9) * LDS + d]);
    mma_bf16(acc[dt], a, b0, b1);
  }
}

template <int HDP, bool VEC>
__global__ void __launch_bounds__(NTHREADS)
bwd_dq_bf16_kernel(Params p) {
  constexpr int LDS = HDP + 8;  // +16 bytes per row: conflict-free fragment loads
  constexpr int KSTEPS = HDP / 16;
  constexpr int DTILES = HDP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dOs = Qs + BM * LDS;
  __nv_bfloat16* Ks = dOs + BM * LDS;
  __nv_bfloat16* Vs = Ks + BN * LDS;
  float* bias_s = reinterpret_cast<float*>(Vs + BN * LDS);

  const int q0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;

  typedef __nv_bfloat16 bf;
  const bf* qg = static_cast<const bf*>(p.q) + b * p.q_sb + h * p.q_sh + q0 * p.q_st;
  const bf* dog = static_cast<const bf*>(p.dout) + b * p.do_sb + h * p.do_sh + q0 * p.do_st;
  const bf* kg = static_cast<const bf*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf* vg = static_cast<const bf*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* bg = p.bias + b * p.bias_sb;
  const long long row_base = ((long long)b * p.nh + h) * p.Tq;

  load_tile_bf16<HDP, VEC>(Qs, qg, p.q_st, BM, min(BM, p.Tq - q0), p.hd, tid);
  load_tile_bf16<HDP, VEC>(dOs, dog, p.do_st, BM, min(BM, p.Tq - q0), p.hd, tid);

  const int r0 = warp * 16 + g;
  const int rows[2] = {q0 + r0, q0 + r0 + 8};
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool ok = rows[i] < p.Tq;
    lse_r[i] = ok ? p.lse[row_base + rows[i]] : 0.f;
    delta_r[i] = ok ? p.delta[row_base + rows[i]] : 0.f;
  }

  float acc[DTILES][4];
#pragma unroll
  for (int dt = 0; dt < DTILES; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  int n_tiles = (p.Tk + BN - 1) / BN;
  if (p.causal) n_tiles = min(n_tiles, (q0 + BM - 1) / BN + 1);

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BN;
    __syncthreads();  // every warp is done with the previous k/v tile
    load_tile_bf16<HDP, VEC>(Ks, kg + k0 * p.k_st, p.k_st, BN, min(BN, p.Tk - k0), p.hd, tid);
    load_tile_bf16<HDP, VEC>(Vs, vg + k0 * p.v_st, p.v_st, BN, min(BN, p.Tk - k0), p.hd, tid);
    if (tid < BN) bias_s[tid] = (k0 + tid < p.Tk) ? bg[k0 + tid] : NEG_INF;
    __syncthreads();

    // s = q k^T and dp = dO v^T for this warp's 16 rows x 64 keys
    float s[BN / 8][4], dp[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t qa[4], da[4];
      load_a<LDS>(qa, Qs, r0, kk * 16 + tig * 2);
      load_a<LDS>(da, dOs, r0, kk * 16 + tig * 2);
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        const bf* krow = &Ks[(nt * 8 + g) * LDS + kk * 16 + tig * 2];
        const bf* vrow = &Vs[(nt * 8 + g) * LDS + kk * 16 + tig * 2];
        mma_bf16(s[nt], qa, ld32(krow), ld32(krow + 8));
        mma_bf16(dp[nt], da, ld32(vrow), ld32(vrow + 8));
      }
    }

    // p = exp(s - lse) (0 where masked or out of range), ds into s
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int kc = nt * 8 + tig * 2 + (e & 1);
        const int key = k0 + kc;
        float pv = 0.f;
        if (rows[i] < p.Tq && key < p.Tk && !(p.causal && key > rows[i])) {
          const float sv = __fadd_rn(__fmul_rn(s[nt][e], p.scale), bias_s[kc]);  // no contraction
          pv = expf(sv - lse_r[i]);
        }
        s[nt][e] = __fmul_rn(__fmul_rn(pv, dp[nt][e] - delta_r[i]), p.scale);
      }
    }

    // dq += bf16(ds) k
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t a[4];
      acc_to_a(a, s[2 * kk], s[2 * kk + 1]);
      mma_rows<LDS, DTILES>(acc, a, Ks, kk * 16 + tig * 2, g);
    }
  }

  bf* dqg = static_cast<bf*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= p.Tq) continue;
    bf* row = dqg + rows[i] * p.dq_st;
#pragma unroll
    for (int dt = 0; dt < DTILES; ++dt) {
      const int d = dt * 8 + tig * 2;
      if (d < p.hd) row[d] = __float2bfloat16(acc[dt][2 * i]);
      if (d + 1 < p.hd) row[d + 1] = __float2bfloat16(acc[dt][2 * i + 1]);
    }
  }
}

template <int HDP, bool VEC>
__global__ void __launch_bounds__(NTHREADS)
bwd_dkv_bf16_kernel(Params p) {
  constexpr int LDS = HDP + 8;
  constexpr int KSTEPS = HDP / 16;
  constexpr int DTILES = HDP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + BK * LDS;
  __nv_bfloat16* Qs = Vs + BK * LDS;
  __nv_bfloat16* dOs = Qs + BQ * LDS;
  float* lse_s = reinterpret_cast<float*>(dOs + BQ * LDS);
  float* delta_s = lse_s + BQ;

  const int k0 = blockIdx.x * BK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;

  typedef __nv_bfloat16 bf;
  const bf* qg = static_cast<const bf*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf* dog = static_cast<const bf*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const bf* kg = static_cast<const bf*>(p.k) + b * p.k_sb + h * p.k_sh + k0 * p.k_st;
  const bf* vg = static_cast<const bf*>(p.v) + b * p.v_sb + h * p.v_sh + k0 * p.v_st;
  const float* bg = p.bias + b * p.bias_sb;
  const long long row_base = ((long long)b * p.nh + h) * p.Tq;

  load_tile_bf16<HDP, VEC>(Ks, kg, p.k_st, BK, min(BK, p.Tk - k0), p.hd, tid);
  load_tile_bf16<HDP, VEC>(Vs, vg, p.v_st, BK, min(BK, p.Tk - k0), p.hd, tid);

  // this warp's 16 keys: rows kr, kr + 8 of the accumulator fragments
  const int kr = warp * 16 + g;
  const int keys[2] = {k0 + kr, k0 + kr + 8};
  float bias_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) bias_r[i] = keys[i] < p.Tk ? bg[keys[i]] : NEG_INF;

  float dk[DTILES][4], dv[DTILES][4];
#pragma unroll
  for (int dt = 0; dt < DTILES; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dt][e] = dv[dt][e] = 0.f;

  const int n_q = (p.Tq + BQ - 1) / BQ;
  // causal: only q tiles reaching this k tile's first key contribute
  const int first = p.causal ? k0 / BQ : 0;

  for (int it = first; it < n_q; ++it) {
    const int q0 = it * BQ;
    __syncthreads();  // every warp is done with the previous q/dO tile
    load_tile_bf16<HDP, VEC>(Qs, qg + q0 * p.q_st, p.q_st, BQ, min(BQ, p.Tq - q0), p.hd, tid);
    load_tile_bf16<HDP, VEC>(dOs, dog + q0 * p.do_st, p.do_st, BQ, min(BQ, p.Tq - q0), p.hd,
                             tid);
    if (tid < BQ) {
      const bool ok = q0 + tid < p.Tq;
      lse_s[tid] = ok ? p.lse[row_base + q0 + tid] : 0.f;
      delta_s[tid] = ok ? p.delta[row_base + q0 + tid] : 0.f;
    }
    __syncthreads();

    // s^T = k q^T and dp^T = v dO^T for this warp's 16 keys x 32 rows
    float s[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
    for (int nt = 0; nt < BQ / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t ka[4], va[4];
      load_a<LDS>(ka, Ks, kr, kk * 16 + tig * 2);
      load_a<LDS>(va, Vs, kr, kk * 16 + tig * 2);
#pragma unroll
      for (int nt = 0; nt < BQ / 8; ++nt) {
        const bf* qrow = &Qs[(nt * 8 + g) * LDS + kk * 16 + tig * 2];
        const bf* dorow = &dOs[(nt * 8 + g) * LDS + kk * 16 + tig * 2];
        mma_bf16(s[nt], ka, ld32(qrow), ld32(qrow + 8));
        mma_bf16(dp[nt], va, ld32(dorow), ld32(dorow + 8));
      }
    }

    // p^T into s, ds^T into dp
#pragma unroll
    for (int nt = 0; nt < BQ / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int qc = nt * 8 + tig * 2 + (e & 1);
        const int row = q0 + qc;
        float pv = 0.f;
        if (keys[i] < p.Tk && row < p.Tq && !(p.causal && row < keys[i])) {
          const float sv = __fadd_rn(__fmul_rn(s[nt][e], p.scale), bias_r[i]);
          pv = expf(sv - lse_s[qc]);
        }
        s[nt][e] = pv;
        dp[nt][e] = __fmul_rn(__fmul_rn(pv, dp[nt][e] - delta_s[qc]), p.scale);
      }
    }

    // dv += bf16(p^T) dO, dk += bf16(ds^T) q
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t pa[4], da[4];
      acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
      acc_to_a(da, dp[2 * kk], dp[2 * kk + 1]);
      mma_rows<LDS, DTILES>(dv, pa, dOs, kk * 16 + tig * 2, g);
      mma_rows<LDS, DTILES>(dk, da, Qs, kk * 16 + tig * 2, g);
    }
  }

  bf* dkg = static_cast<bf*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  bf* dvg = static_cast<bf*>(p.dv) + b * p.dk_sb + h * p.dk_sh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (keys[i] >= p.Tk) continue;
    bf* krow = dkg + keys[i] * p.dk_st;
    bf* vrow = dvg + keys[i] * p.dk_st;
#pragma unroll
    for (int dt = 0; dt < DTILES; ++dt) {
      const int d = dt * 8 + tig * 2;
      if (d < p.hd) {
        krow[d] = __float2bfloat16(dk[dt][2 * i]);
        vrow[d] = __float2bfloat16(dv[dt][2 * i]);
      }
      if (d + 1 < p.hd) {
        krow[d + 1] = __float2bfloat16(dk[dt][2 * i + 1]);
        vrow[d + 1] = __float2bfloat16(dv[dt][2 * i + 1]);
      }
    }
  }
}

// ----------------------------------------------------------------- f32 ---

constexpr int FB = 32;        // rows (dq) or keys (dk/dv) per block, and per streamed tile
constexpr int FTHREADS = 128;

// rows [r0, r0 + FB) of a [T, ., hd] f32 tensor into a [FB][HDP + 1] tile
template <int HDP>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src, long long row_stride,
                                              int rows_valid, int hd, int tid) {
  constexpr int LDS = HDP + 1;  // odd row stride: no bank conflicts
  for (int c = tid; c < FB * HDP; c += FTHREADS) {
    const int r = c / HDP, d = c % HDP;
    dst[r * LDS + d] = (r < rows_valid && d < hd) ? src[r * row_stride + d] : 0.f;
  }
}

template <int HDP>
__global__ void __launch_bounds__(FTHREADS)
bwd_dq_f32_kernel(Params p) {
  constexpr int LDS = HDP + 1;
  constexpr int PER = FB * HDP / FTHREADS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* dOs = Qs + FB * LDS;
  float* Ks = dOs + FB * LDS;
  float* Vs = Ks + FB * LDS;
  float* Ds = Vs + FB * LDS;          // [FB][FB + 1] ds tile
  float* bias_s = Ds + FB * (FB + 1);
  float* lse_s = bias_s + FB;
  float* delta_s = lse_s + FB;

  const int q0 = blockIdx.x * FB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int hd = p.hd;
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh + q0 * p.q_st;
  const float* dog = static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh + q0 * p.do_st;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* bg = p.bias + b * p.bias_sb;
  const long long row_base = ((long long)b * p.nh + h) * p.Tq;

  load_tile_f32<HDP>(Qs, qg, p.q_st, p.Tq - q0, hd, tid);
  load_tile_f32<HDP>(dOs, dog, p.do_st, p.Tq - q0, hd, tid);
  if (tid < FB) {
    const bool ok = q0 + tid < p.Tq;
    lse_s[tid] = ok ? p.lse[row_base + q0 + tid] : 0.f;
    delta_s[tid] = ok ? p.delta[row_base + q0 + tid] : 0.f;
  }
  float acc[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) acc[i] = 0.f;

  int n_tiles = (p.Tk + FB - 1) / FB;
  if (p.causal) n_tiles = min(n_tiles, (q0 + FB - 1) / FB + 1);

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * FB;
    __syncthreads();
    load_tile_f32<HDP>(Ks, kg + k0 * p.k_st, p.k_st, p.Tk - k0, hd, tid);
    load_tile_f32<HDP>(Vs, vg + k0 * p.v_st, p.v_st, p.Tk - k0, hd, tid);
    if (tid < FB) bias_s[tid] = (k0 + tid < p.Tk) ? bg[k0 + tid] : NEG_INF;
    __syncthreads();

    for (int e = tid; e < FB * FB; e += FTHREADS) {
      const int r = e / FB, c = e % FB;
      const int row = q0 + r, key = k0 + c;
      float ds = 0.f;
      if (row < p.Tq && key < p.Tk && !(p.causal && key > row)) {
        float dot = 0.f, dpv = 0.f;
        for (int d = 0; d < hd; ++d) {
          dot = fmaf(Qs[r * LDS + d], Ks[c * LDS + d], dot);
          dpv = fmaf(dOs[r * LDS + d], Vs[c * LDS + d], dpv);
        }
        const float sv = __fadd_rn(__fmul_rn(dot, p.scale), bias_s[c]);
        const float pv = expf(sv - lse_s[r]);
        ds = __fmul_rn(__fmul_rn(pv, dpv - delta_s[r]), p.scale);
      }
      Ds[r * (FB + 1) + c] = ds;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = tid + i * FTHREADS;
      const int r = e / HDP, d = e % HDP;
      const float* drow = &Ds[r * (FB + 1)];
      float sum = 0.f;
      for (int c = 0; c < FB; ++c) sum = fmaf(drow[c], Ks[c * LDS + d], sum);
      acc[i] += sum;
    }
  }

  float* dqg = static_cast<float*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = tid + i * FTHREADS;
    const int r = e / HDP, d = e % HDP;
    if (q0 + r < p.Tq && d < hd) dqg[(q0 + r) * p.dq_st + d] = acc[i];
  }
}

template <int HDP>
__global__ void __launch_bounds__(FTHREADS)
bwd_dkv_f32_kernel(Params p) {
  constexpr int LDS = HDP + 1;
  constexpr int PER = FB * HDP / FTHREADS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);
  float* Vs = Ks + FB * LDS;
  float* Qs = Vs + FB * LDS;
  float* dOs = Qs + FB * LDS;
  float* Pt = dOs + FB * LDS;         // [FB keys][FB + 1] p^T tile
  float* Dt = Pt + FB * (FB + 1);     // [FB keys][FB + 1] ds^T tile
  float* bias_s = Dt + FB * (FB + 1);
  float* lse_s = bias_s + FB;
  float* delta_s = lse_s + FB;

  const int k0 = blockIdx.x * FB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int hd = p.hd;
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* dog = static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh + k0 * p.k_st;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh + k0 * p.v_st;
  const float* bg = p.bias + b * p.bias_sb;
  const long long row_base = ((long long)b * p.nh + h) * p.Tq;

  load_tile_f32<HDP>(Ks, kg, p.k_st, p.Tk - k0, hd, tid);
  load_tile_f32<HDP>(Vs, vg, p.v_st, p.Tk - k0, hd, tid);
  if (tid < FB) bias_s[tid] = (k0 + tid < p.Tk) ? bg[k0 + tid] : NEG_INF;
  float acc_k[PER], acc_v[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) acc_k[i] = acc_v[i] = 0.f;

  const int n_q = (p.Tq + FB - 1) / FB;
  const int first = p.causal ? k0 / FB : 0;

  for (int it = first; it < n_q; ++it) {
    const int q0 = it * FB;
    __syncthreads();
    load_tile_f32<HDP>(Qs, qg + q0 * p.q_st, p.q_st, p.Tq - q0, hd, tid);
    load_tile_f32<HDP>(dOs, dog + q0 * p.do_st, p.do_st, p.Tq - q0, hd, tid);
    if (tid < FB) {
      const bool ok = q0 + tid < p.Tq;
      lse_s[tid] = ok ? p.lse[row_base + q0 + tid] : 0.f;
      delta_s[tid] = ok ? p.delta[row_base + q0 + tid] : 0.f;
    }
    __syncthreads();

    for (int e = tid; e < FB * FB; e += FTHREADS) {
      const int kr = e / FB, c = e % FB;
      const int key = k0 + kr, row = q0 + c;
      float pv = 0.f, ds = 0.f;
      if (key < p.Tk && row < p.Tq && !(p.causal && row < key)) {
        float dot = 0.f, dpv = 0.f;
        for (int d = 0; d < hd; ++d) {
          dot = fmaf(Ks[kr * LDS + d], Qs[c * LDS + d], dot);
          dpv = fmaf(Vs[kr * LDS + d], dOs[c * LDS + d], dpv);
        }
        const float sv = __fadd_rn(__fmul_rn(dot, p.scale), bias_s[kr]);
        pv = expf(sv - lse_s[c]);
        ds = __fmul_rn(__fmul_rn(pv, dpv - delta_s[c]), p.scale);
      }
      Pt[kr * (FB + 1) + c] = pv;
      Dt[kr * (FB + 1) + c] = ds;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = tid + i * FTHREADS;
      const int kr = e / HDP, d = e % HDP;
      float sv = 0.f, sk = 0.f;
      for (int c = 0; c < FB; ++c) {
        sv = fmaf(Pt[kr * (FB + 1) + c], dOs[c * LDS + d], sv);
        sk = fmaf(Dt[kr * (FB + 1) + c], Qs[c * LDS + d], sk);
      }
      acc_v[i] += sv;
      acc_k[i] += sk;
    }
  }

  float* dkg = static_cast<float*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  float* dvg = static_cast<float*>(p.dv) + b * p.dk_sb + h * p.dk_sh;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = tid + i * FTHREADS;
    const int kr = e / HDP, d = e % HDP;
    if (k0 + kr < p.Tk && d < hd) {
      dkg[(k0 + kr) * p.dk_st + d] = acc_k[i];
      dvg[(k0 + kr) * p.dk_st + d] = acc_v[i];
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

template <int HDP>
cudaError_t launch_bf16(const Params& p, bool dkv, bool vec, cudaStream_t stream) {
  const size_t lds_bytes = (HDP + 8) * sizeof(__nv_bfloat16);
  if (!dkv) {
    dim3 grid((p.Tq + BM - 1) / BM, p.nh, p.B);
    const size_t smem = (2 * BM + 2 * BN) * lds_bytes + BN * sizeof(float);
    if (vec) return launch(bwd_dq_bf16_kernel<HDP, true>, grid, NTHREADS, smem, stream, p);
    return launch(bwd_dq_bf16_kernel<HDP, false>, grid, NTHREADS, smem, stream, p);
  }
  dim3 grid((p.Tk + BK - 1) / BK, p.nh, p.B);
  const size_t smem = (2 * BK + 2 * BQ) * lds_bytes + 2 * BQ * sizeof(float);
  if (vec) return launch(bwd_dkv_bf16_kernel<HDP, true>, grid, NTHREADS, smem, stream, p);
  return launch(bwd_dkv_bf16_kernel<HDP, false>, grid, NTHREADS, smem, stream, p);
}

template <int HDP>
cudaError_t launch_f32(const Params& p, bool dkv, cudaStream_t stream) {
  const int t = dkv ? p.Tk : p.Tq;
  dim3 grid((t + FB - 1) / FB, p.nh, p.B);
  const size_t tiles = (size_t)4 * FB * (HDP + 1);
  if (!dkv) {
    const size_t smem = (tiles + FB * (FB + 1) + 3 * FB) * sizeof(float);
    return launch(bwd_dq_f32_kernel<HDP>, grid, FTHREADS, smem, stream, p);
  }
  const size_t smem = (tiles + 2 * FB * (FB + 1) + 3 * FB) * sizeof(float);
  return launch(bwd_dkv_f32_kernel<HDP>, grid, FTHREADS, smem, stream, p);
}

int dispatch(const Params& p, bool dkv, int dtype, int vec, cudaStream_t s) {
  if (p.hd < 1 || p.hd > 128 || p.B < 1 || p.Tq < 1 || p.Tk < 1 || p.nh < 1)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    if (p.hd <= 32) return (int)launch_bf16<32>(p, dkv, vec != 0, s);
    if (p.hd <= 64) return (int)launch_bf16<64>(p, dkv, vec != 0, s);
    if (p.hd <= 112) return (int)launch_bf16<112>(p, dkv, vec != 0, s);
    return (int)launch_bf16<128>(p, dkv, vec != 0, s);
  }
  if (dtype == 0) {
    if (p.hd <= 32) return (int)launch_f32<32>(p, dkv, s);
    if (p.hd <= 64) return (int)launch_f32<64>(p, dkv, s);
    return (int)launch_f32<128>(p, dkv, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  vec (bf16 only): 1 when hd and every
// q/k/v/dO row stride are multiples of 8 and the bases 16-byte aligned.
// Returns the cudaError_t of the launch (0 = success).
int tdax_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                      const float* bias, const float* lse, const float* delta, void* dq,
                      int B, int Tq, int Tk, int nh, int hd,
                      long long q_sb, long long q_st, long long q_sh,
                      long long k_sb, long long k_st, long long k_sh,
                      long long v_sb, long long v_st, long long v_sh,
                      long long do_sb, long long do_st, long long do_sh,
                      long long dq_sb, long long dq_st, long long dq_sh,
                      long long bias_sb, int causal, float scale, int dtype, int vec,
                      void* stream) {
  Params p{q, k, v, dout, bias, lse, delta, dq, nullptr, nullptr, B, Tq, Tk, nh, hd,
           q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, do_sb, do_st, do_sh,
           dq_sb, dq_st, dq_sh, 0, 0, 0, bias_sb, causal, scale};
  return dispatch(p, false, dtype, vec, static_cast<cudaStream_t>(stream));
}

// dk and dv are written through one set of strides (dk_sb, dk_st, dk_sh).
int tdax_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const float* bias, const float* lse, const float* delta, void* dk,
                       void* dv, int B, int Tq, int Tk, int nh, int hd,
                       long long q_sb, long long q_st, long long q_sh,
                       long long k_sb, long long k_st, long long k_sh,
                       long long v_sb, long long v_st, long long v_sh,
                       long long do_sb, long long do_st, long long do_sh,
                       long long dk_sb, long long dk_st, long long dk_sh,
                       long long bias_sb, int causal, float scale, int dtype, int vec,
                       void* stream) {
  Params p{q, k, v, dout, bias, lse, delta, nullptr, dk, dv, B, Tq, Tk, nh, hd,
           q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, do_sb, do_st, do_sh,
           0, 0, 0, dk_sb, dk_st, dk_sh, bias_sb, causal, scale};
  return dispatch(p, true, dtype, vec, static_cast<cudaStream_t>(stream));
}

const char* tdax_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
