// Flash-attention forward for one query row (the decode step) on Hopper
// (sm_90a): split-KV over the warps of a block, f32 on the CUDA cores.
// Plain C interface.
//
// Replaces the Pallas TPU kernel tdax/ops/flash_attention.py::_kernel
// (tdax/ops/flash_attention.py:164; driven there by _flash_impl,
// _build_flash and mha) at Tq = 1, where tdax itself takes the einsum
// path (flash_attention.py:813-824) and the port takes a kernel.  Same
// function as flash_fwd.cu:
//
//   o[b, 0, h, :] = sum_j softmax_j(s_j) v[b, j, h, :],
//   s_j = (q[b, 0, h, :] . k[b, j, h, :]) * scale + bias[b, j]
//         (NEG_INF for j > 0 when causal),
//
// the running max m, denominator l and accumulator in f32, m starting at
// the finite NEG_INF (-1e30), p rounded to v's type (bf16) before the PV
// product, the output acc / l with l == 0 guarded to 1, and with a
// non-null lse the row's m + log(l), 0 when the row sees no key (l == 0 or
// m still at NEG_INF).  The finite NEG_INF makes a stretch of masked keys
// harmless: its p = exp(0) = 1 is wiped by alpha = exp(NEG_INF - m) = 0
// once a real score arrives.
//
// Layout: q [B, 1, nh, hd], k/v [B, Tk, nh, hd] read through their
// strides (the decode step's strided q from the qkv split, the layer's
// view of the cache [L, B, T_max, nh, hd]); bias [B, Tk] f32; out [B, 1,
// nh, hd] contiguous bf16.  hd <= 128 with hd, every stride and every base
// 16-byte aligned (tdax_torch/ops/flash_attention.py::_route).
//
// What bounds it on an H100 (3.35 TB/s): each (b, h) reads its Tk keys
// and values once, 4 * Tk * hd bytes, for 4 * Tk * hd flops: ~1 flop a
// byte, so the card's memory rate bounds it (at [16, 1, 352, 32, 128]:
// 92 MB, 0.0276 ms).  flash_fwd.cu reached 21% of that: one 4-warp block
// per (b, h) used 1 of its 64 query rows (15 of 16 rows of each
// m16n8k16 tile zero fill) and loaded a 64-key tile, then computed, with
// nothing in flight meanwhile.
//
// The design:
// - One block per (b, h), WARPS warps (4, 8 or 16; the wrapper picks the
//   fewest that put ~8 warps of loads on each SM).  Each half-warp is a
//   split (a "slot"): its 16 lanes hold 8 dims each (one 16-byte load of a
//   256-byte key row), and it walks a contiguous range of ceil(Tk / slots)
//   keys, U keys at a time: the U rows of k and of v are loaded (16 bytes a
//   lane, 2U loads in flight a lane) before any is used, so a block keeps
//   2 * U * 256 bytes per slot in flight and an SM tens of KB.
// - q . k on the CUDA cores in f32: 8 FMAs a lane, then a butterfly over
//   the 16 lanes (every lane ends with the same bits: each step adds the
//   same two values in swapped order).  At one query row the tensor cores
//   would only add zero fill.
// - Each slot keeps its own m, l and 8-dim accumulator per lane; a group of
//   U keys updates m once.  Keys past the slot's range are not keys: p = 0.
// - The slots merge in the block, in slot order: each writes m, l and its
//   accumulator to shared memory; the weights w_s = exp(m_s - M) follow from
//   the block's M; thread d sums acc_s[d] w_s over s = 0, 1, ... and l_s
//   w_s likewise.  A slot that saw only masked keys (m_s = NEG_INF) gets
//   w_s = exp(NEG_INF - M) = 0 beside a real key and merges to exactly
//   nothing; when no slot saw a real key, M = NEG_INF and every w_s = 1,
//   the same sums a single pass would make.  An empty slot has l = 0 and
//   acc = 0.
// - No atomics and no scratch in device memory: one launch a call, and a
//   repeat is bitwise.
// - Causal at Tq = 1 leaves key 0 alone: the kernel reads only that key.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int U = 4;  // keys a slot loads at once

__device__ __forceinline__ float row_lse(float m, float l) {
  return (l == 0.f || m <= NEG_INF) ? 0.f : m + logf(l);
}

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const float* bias;
  __nv_bfloat16* o;
  float* lse;  // [B, nh] or null
  int B, Tk, nh, hd;
  long long q_sb, q_sh;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long bias_sb;
  int causal;
  float scale;
};

__device__ __forceinline__ void unpack8(const uint4& w, float* f) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xFFFF0000u);
  }
}

__device__ __forceinline__ uint4 load16(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

template <int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
flash_decode_kernel(Params p) {
  constexpr int SLOTS = 2 * WARPS;
  __shared__ float m_s[SLOTS], l_s[SLOTS], w_s[SLOTS];
  __shared__ __align__(16) float acc_s[SLOTS][128];

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x;
  const int slot = tid >> 4, lane = tid & 15;
  const int d0 = lane * 8;
  const bool active = d0 < p.hd;

  float qf[8];
  {
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    if (active) w = load16(p.q + b * p.q_sb + h * p.q_sh + d0);
    unpack8(w, qf);
  }
  const __nv_bfloat16* kg = p.k + b * p.k_sb + h * p.k_sh + d0;
  const __nv_bfloat16* vg = p.v + b * p.v_sb + h * p.v_sh + d0;
  const float* bg = p.bias + b * p.bias_sb;

  const int tk = p.causal ? 1 : p.Tk;
  const int chunk = ((tk + SLOTS - 1) / SLOTS + U - 1) / U * U;
  const int kbeg = slot * chunk;
  const int kend = min(kbeg + chunk, tk);
  // both slots of a warp run the trip count of its first (the longer), so
  // that the shuffles see every lane
  const int wbeg = (slot & ~1) * chunk;
  const int wsteps = (max(0, min(wbeg + chunk, tk) - wbeg) + U - 1) / U;

  float m = NEG_INF, l = 0.f;
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;

  for (int step = 0; step < wsteps; ++step) {
    const int k0 = kbeg + step * U;
    uint4 kw[U], vw[U];
    float bs[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int key = k0 + u;
      const bool ok = key < kend;
      kw[u] = vw[u] = make_uint4(0u, 0u, 0u, 0u);
      if (ok && active) {
        kw[u] = load16(kg + key * p.k_st);
        vw[u] = load16(vg + key * p.v_st);
      }
      bs[u] = ok ? __ldg(bg + key) : 0.f;
    }
    float sc[U];
    float mx = m;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[8];
      unpack8(kw[u], kf);
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) dot = fmaf(qf[i], kf[i], dot);
      dot += __shfl_xor_sync(0xffffffffu, dot, 8);
      dot += __shfl_xor_sync(0xffffffffu, dot, 4);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      sc[u] = __fadd_rn(__fmul_rn(dot, p.scale), bs[u]);  // no contraction
      if (k0 + u < kend) mx = fmaxf(mx, sc[u]);
    }
    const float alpha = expf(m - mx);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] *= alpha;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (k0 + u >= kend) continue;
      const float pu = expf(sc[u] - mx);
      l += pu;
      const float pb = __bfloat162float(__float2bfloat16_rn(pu));  // p in v's type
      float vf[8];
      unpack8(vw[u], vf);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = fmaf(pb, vf[i], acc[i]);
    }
    m = mx;
  }

  // merge the slots in slot order
  if (lane == 0) {
    m_s[slot] = m;
    l_s[slot] = l;
  }
  if (active) {
    *reinterpret_cast<float4*>(&acc_s[slot][d0]) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    *reinterpret_cast<float4*>(&acc_s[slot][d0 + 4]) = make_float4(acc[4], acc[5], acc[6], acc[7]);
  }
  __syncthreads();
  if (tid < SLOTS) {
    float mm = NEG_INF;
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) mm = fmaxf(mm, m_s[s]);
    w_s[tid] = expf(m_s[tid] - mm);
  }
  __syncthreads();
  float lt = 0.f;
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) lt = fmaf(l_s[s], w_s[s], lt);
  const long long row = (long long)b * p.nh + h;
  if (tid < p.hd) {
    float a = 0.f;
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) a = fmaf(acc_s[s][tid], w_s[s], a);
    p.o[row * p.hd + tid] = __float2bfloat16_rn(a / (lt == 0.f ? 1.f : lt));
  }
  if (p.lse && tid == 0) {
    float mm = NEG_INF;
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) mm = fmaxf(mm, m_s[s]);
    p.lse[row] = row_lse(mm, lt);
  }
}

template <int WARPS>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  flash_decode_kernel<WARPS><<<dim3(p.nh, p.B), WARPS * 32, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q [B, 1, nh, hd], k/v [B, Tk, nh, hd] bf16 (strides in elements, the
// last dimension contiguous), bias [B, Tk] f32, out [B, 1, nh, hd] bf16
// contiguous, lse null or [B, nh, 1] f32.  warps: 4, 8 or 16.  Needs hd
// <= 128, hd and every stride a multiple of 8 and the q, k, v bases
// 16-byte aligned.  Returns the cudaError_t of the launch (0 = success).
int tdax_flash_decode_sm90(const void* q, const void* k, const void* v, const float* bias,
                           void* o, int B, int Tk, int nh, int hd, long long q_sb, long long q_sh,
                           long long k_sb, long long k_st, long long k_sh, long long v_sb,
                           long long v_st, long long v_sh, long long bias_sb, int causal,
                           float scale, float* lse, int warps, void* stream) {
  if (B < 1 || Tk < 1 || nh < 1 || hd < 8 || hd > 128 || hd % 8 || B > 65535 ||
      q_sb % 8 || q_sh % 8 || k_sb % 8 || k_st % 8 || k_sh % 8 || v_sb % 8 || v_st % 8 ||
      v_sh % 8 || reinterpret_cast<uintptr_t>(q) % 16 || reinterpret_cast<uintptr_t>(k) % 16 ||
      reinterpret_cast<uintptr_t>(v) % 16)
    return (int)cudaErrorInvalidValue;
  const Params p{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
                 static_cast<const __nv_bfloat16*>(v), bias, static_cast<__nv_bfloat16*>(o), lse,
                 B, Tk, nh, hd, q_sb, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, bias_sb, causal,
                 scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (warps == 4) return (int)launch<4>(p, s);
  if (warps == 8) return (int)launch<8>(p, s);
  if (warps == 16) return (int)launch<16>(p, s);
  return (int)cudaErrorInvalidValue;
}

const char* tdax_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
