// Flash-attention forward for Hopper (sm_90a): TMA, an mbarrier ring and
// wgmma in a warp-specialised block.  Plain C interface.
//
// Replaces the Pallas TPU kernel tdax/ops/flash_attention.py::_kernel
// (driven there by _flash_impl, _build_flash and mha) for bf16 inputs that
// TMA can read: the function is flash_fwd.cu's, unchanged,
//
//   o[b, i, h, :] = sum_j softmax_j(s_ij) v[b, j, h, :],
//   s_ij = fl(fl(q[b, i, h, :] . k[b, j, h, :] * scale) + bias[b, j])
//          (NEG_INF where causal and j > i),
//
// with an online softmax in f32 (m starts at the finite NEG_INF = -1e30),
// p rounded to bf16 before the PV product, l == 0 guarded to 1, key tiles
// wholly above the causal diagonal skipped, and an optional lse [B, nh,
// Tq] f32 = m + log(l), 0 on a row that sees no key.  flash_fwd.cu keeps
// f32, the decode step (Tq = 1) and the inputs TMA cannot read
// (tdax_torch/ops/flash_attention.py::_route).
//
// Layout: q [B, Tq, nh, hd], k/v [B, Tk, nh, hd] through their strides
// (the last dimension contiguous, the bases and the other strides 16-byte
// aligned, hd a multiple of 8), bias [B, Tk] f32, o [B, Tq, nh, hd]
// contiguous.  Each of q, k, v and o is a 4-D tensor map (hd, nh, T, B)
// over its own strides, so the model's fused-projection views go in
// without a copy.
//
// What bounds it on an H100 (989 TFLOP/s bf16, 3.35 TB/s): the ViT (T =
// 1024, hd 104) by the tensor cores, the decoder (T = 320, causal) and
// the resampler (256 x 1024) by memory.  The design:
//
// - A block owns 128 q rows of one (batch, head): 384 threads, a producer
//   warpgroup and two consumer warpgroups of 64 rows each (wgmma's M).
//   The q tiles of one (batch, head) are neighbours in the grid, so they
//   run together and read its K and V from L2 after the first (putting
//   the q tile on the slowest grid axis cost 15% at the ViT's shape);
//   among them the heaviest causal tile starts first.
// - The producer (its warp 0; the warpgroup gives its registers away with
//   setmaxnreg.dec) loads Q once, then K and V tiles of 128 keys by TMA
//   into a ring of STAGES = 3 stages (224 KB at hd 128), with full and
//   empty barriers for K and for V apart: K_j is released after S_j's
//   softmax, V_j after P_j V_j, so the next K streams in while the PV
//   product still holds V.  The same warp stages the tile's 128 bias
//   values in shared memory (NEG_INF past Tk) with a flag for a tile whose
//   bias is all 0, and arrives on the K barrier.  Tiles are 128-byte
//   swizzled, 64 columns a box: hd 128 or 104 arrives as two boxes (zeros
//   past hd), hd <= 64 as one.  Rows past Tq or Tk arrive as zeros.
// - Each consumer warpgroup (setmaxnreg.inc) runs S = Q K^T as wgmma
//   m64n128k16 with both operands in shared memory (K-major; 7 steps of
//   16 at hd 104), then the scale, the bias and (on the diagonal tile
//   only) the causal mask and the online softmax in registers on the
//   accumulator fragment, with the MUFU ex2 on (s - m) log2(e) (s keeps
//   its two roundings; lse stays in natural-log units), then O += P V as
//   wgmma with P in registers (the f32 accumulator packs into bf16 A
//   fragments without shuffles) and V read from its stored [keys, hd]
//   layout through the transpose bit, N = 104 at the ViT's hd.  Nothing
//   of S or P reaches device memory.
// - The consumers overlap: S_{j+1} = Q K_{j+1}^T is issued with
//   O += P_j V_j and S_{j+1}'s softmax runs while the PV product
//   finishes; the two warpgroups take turns to issue their products
//   (named barriers 3 and 4), so one's softmax runs under the other's
//   products.  O is rescaled only where the running max moved.
// - The epilogue divides by l, writes bf16 O into the warpgroup's rows of
//   the Q tile (no longer read) in the swizzled layout and stores it by
//   TMA, which clips rows past Tq and columns past hd; lse goes out from
//   one thread per row.
// - Every output row belongs to one block and sums in a fixed order: no
//   atomics, the result is deterministic.
//
// Latent attention (MLA, Kimi-VL's decoder) takes q and k of 192 columns
// (128 without rotary, 64 with) and v of 128: q.k runs over three
// 64-column boxes (12 steps of 16), PV over two, and o takes v's width.
// Its kernel, flash_fwd_mla_kernel, is the same body with a ring of
// STAGES_MLA = 2 stages, since three stages of a 192-column K and a
// 128-column V (240 KB with Q) do not fit in the 227 KB a block may
// hold: 48 KB of Q, 2 x 48 KB of K and 2 x 32 KB of V, 208 KB in all.
// Its bound on an H100 at Kimi-VL's capture (B = 16, T = 320, 16 heads,
// causal) is memory's, like the QWen decoder's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int BM = 128;        // q rows per block: two consumer warpgroups of 64
constexpr int BN = 128;        // keys per stage
constexpr int STAGES = 3;
constexpr int STAGES_MLA = 2;  // latent attention: q.k over 192 columns, v of 128
constexpr int THREADS = 384;   // producer warpgroup + two consumer warpgroups
constexpr int BOX = 64;        // columns per TMA box (128 bytes of bf16)
constexpr int CHUNK = 128 * 128;  // bytes of one 128-row, 64-column box
constexpr uint32_t PRODUCER_REGS = 40, CONSUMER_REGS = 232;

// shared memory, as offsets from a 1024-aligned base: q and k rows of QKB
// 64-column boxes, v (and o) rows of VB, a ring of STG stages
template <int QKB, int VB, int STG>
struct Smem {
  static constexpr int QK_TILE = QKB * CHUNK;  // one 128-row tile of q or k
  static constexpr int V_TILE = VB * CHUNK;    // one 128-row tile of v
  static constexpr int Q = 0;
  static constexpr int K = Q + QK_TILE;
  static constexpr int V = K + STG * QK_TILE;
  static constexpr int BIAS = V + STG * V_TILE;
  static constexpr int FLAG = BIAS + STG * BN * 4;  // per stage: the bias is not all 0
  static constexpr int BAR = FLAG + 16;
  static constexpr int BYTES = BAR + (1 + 4 * STG) * 8;
  static constexpr int ALLOC = BYTES + 1024;   // room to align the base
};

// boxes of a q or k row for KSTEPS steps of 16 columns, of a v row for NV
template <int KSTEPS, int NV, int STG>
using SmemOf = Smem<(KSTEPS * 16 + BOX - 1) / BOX, NV <= 64 ? 1 : 2, STG>;

struct Params {
  const float* bias;
  float* lse;  // [B, nh, Tq] or null
  int Tq, Tk, nh;
  long long bias_sb;
  float scale;
  int m_tiles;
};

// log-normalizer of a finished row; 0 for a row that saw no key
__device__ __forceinline__ float row_lse(float m, float l) {
  return (l == 0.f || m <= NEG_INF) ? 0.f : m + logf(l);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo (low half)
  return *reinterpret_cast<uint32_t*>(&v);
}

// S = Q K^T for one warpgroup: KSTEPS steps of 16 columns (zeros past
// hd), both operands K-major in shared memory.  The step count is a
// template parameter: a run-time bound would split the chain of wgmmas
// into blocks, and ptxas then fences between them.
template <int KSTEPS>
__device__ __forceinline__ void issue_qk(float (&sc)[64], uint32_t q_addr, uint32_t k_addr) {
  wgmma_m64n128k16_ss_first(sc, desc_sw128(q_addr, 0, 1024), desc_sw128(k_addr, 0, 1024));
#pragma unroll
  for (int ks = 1; ks < KSTEPS; ++ks) {
    const uint32_t off = (ks / 4) * CHUNK + (ks % 4) * 32;
    wgmma_m64n128k16_ss(sc, desc_sw128(q_addr + off, 0, 1024), desc_sw128(k_addr + off, 0, 1024));
  }
}

// O += P V over NV output columns, P from registers; V [keys, hd] is
// MN-major for this product (the transpose bit), hd's 64-column boxes
// CHUNK bytes apart
template <int NV>
__device__ __forceinline__ void issue_pv(float (&o)[NV / 2], uint32_t (&pa)[32],
                                         uint32_t v_addr) {
  fence_regs(pa);
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint64_t dv = desc_sw128(v_addr + kk * 16 * 128, CHUNK, 1024);
    if constexpr (NV == 128)
      wgmma_m64n128k16_rs_tb(o, &pa[4 * kk], dv);
    else if constexpr (NV == 104)
      wgmma_m64n104k16_rs_tb(o, &pa[4 * kk], dv);
    else
      wgmma_m64n64k16_rs_tb(o, &pa[4 * kk], dv);
  }
}

// One key tile of the online softmax on the S accumulator fragment:
// s = fl(fl(qk * scale) + bias) (no contraction; bias is NEG_INF past Tk;
// the add is skipped on a tile whose bias is all 0, where it is exact),
// NEG_INF above the diagonal on the tile that straddles it, then the new
// running max, p = 2^((s - m) log2 e) in place, this thread's share of l
// and the factor alpha that rescales O (exactly 1 where the max did not
// move).  A row lies across the 4 threads of a quad.  While some row of
// the warp is still at the NEG_INF floor (it has seen no key), p is
// 2^((s - m) log2 e) with s - m = 0 exactly there, so p = 1 as in
// flash_fwd.cu; otherwise 2^(s log2 e - m log2 e) as one FFMA, which
// differs from it by rounding only.
template <bool CAUSAL>
__device__ __forceinline__ void softmax_tile(float (&sc)[64], const float* bs, bool with_bias,
                                             float scale, int wrow0, int row0, int k0, int t,
                                             float (&m_run)[2], float (&l_run)[2],
                                             float (&alpha)[2]) {
  if (with_bias) {
#pragma unroll
    for (int nb = 0; nb < 16; ++nb) {
      const float2 bb = *reinterpret_cast<const float2*>(bs + nb * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sc[4 * nb + e] = __fadd_rn(__fmul_rn(sc[4 * nb + e], scale), (e & 1) ? bb.y : bb.x);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 64; ++e) sc[e] = __fmul_rn(sc[e], scale);
  }
  if (CAUSAL && k0 + BN - 1 > wrow0) {
#pragma unroll
    for (int nb = 0; nb < 16; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k0 + nb * 8 + 2 * t + (e & 1) > row0 + 8 * (e >> 1)) sc[4 * nb + e] = NEG_INF;
  }
  float mx[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = m_run[i];
#pragma unroll
    for (int nb = 0; nb < 16; ++nb)
      mx[i] = fmaxf(mx[i], fmaxf(sc[4 * nb + 2 * i], sc[4 * nb + 2 * i + 1]));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
  }
  const bool at_floor = __any_sync(0xffffffffu, mx[0] <= NEG_INF || mx[1] <= NEG_INF);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float rs = 0.f;
    if (at_floor) {
      alpha[i] = ex2((m_run[i] - mx[i]) * LOG2E);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        float& x = sc[4 * (e / 2) + 2 * i + (e & 1)];
        x = ex2((x - mx[i]) * LOG2E);
        rs += x;
      }
    } else {
      const float ml = mx[i] * LOG2E;
      alpha[i] = m_run[i] == mx[i] ? 1.f : ex2(fmaf(m_run[i], LOG2E, -ml));
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        float& x = sc[4 * (e / 2) + 2 * i + (e & 1)];
        x = ex2(fmaf(x, LOG2E, -ml));
        rs += x;
      }
    }
    l_run[i] = l_run[i] * alpha[i] + rs;
    m_run[i] = mx[i];
  }
}

// O *= alpha per row, skipped where the warp's alphas are all 1
template <int NV>
__device__ __forceinline__ void rescale_o(float (&o)[NV / 2], const float (&alpha)[2]) {
  if (!__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) return;
#pragma unroll
  for (int nb = 0; nb < NV / 8; ++nb) {
    o[4 * nb] *= alpha[0];
    o[4 * nb + 1] *= alpha[0];
    o[4 * nb + 2] *= alpha[1];
    o[4 * nb + 3] *= alpha[1];
  }
}

// P as bf16 A fragments: key blocks 2kk and 2kk + 1 form k-step kk
__device__ __forceinline__ void pack_p(const float (&sc)[64], uint32_t (&pa)[32]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    pa[4 * kk + 0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
    pa[4 * kk + 1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
    pa[4 * kk + 2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
    pa[4 * kk + 3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

// (KSTEPS, NV) = (4, 64) for hd <= 64, (7, 104) for hd <= 104 (the ViT's
// hd), (8, 128) above: QK^T's steps of 16 columns and PV's output columns;
// (12, 128) for latent attention's q.k over 192 and v of 128.  Rows of up
// to 64 columns take one 64-column box, larger ones two or three.  The
// body of both kernels below, with a ring of STG stages.
template <int KSTEPS, int NV, int STG, bool CAUSAL, bool LSE>
__device__ __forceinline__ void fwd_body(const CUtensorMap& map_q, const CUtensorMap& map_k,
                                         const CUtensorMap& map_v, const CUtensorMap& map_o,
                                         const Params& p) {
  constexpr int STAGES = STG;
  using S = SmemOf<KSTEPS, NV, STG>;
  constexpr int QKB = (KSTEPS * 16 + BOX - 1) / BOX;  // boxes of a q or k row
  constexpr int VB = NV <= 64 ? 1 : 2;                // boxes of a v or o row
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* bias_s = reinterpret_cast<float*>(base + S::BIAS);
  int* bias_nz = reinterpret_cast<int*>(base + S::FLAG);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + S::BAR);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = bars + 1 + STAGES;
  uint64_t* k_empty = bars + 1 + 2 * STAGES;
  uint64_t* v_empty = bars + 1 + 3 * STAGES;

  // the q tiles of one (batch, head) are neighbours in the grid, so they
  // run together and read its K and V from L2 after the first; within
  // them the heaviest causal tile goes first
  const int q0 = (p.m_tiles - 1 - (int)blockIdx.x) * BM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int nk = (p.Tk + BN - 1) / BN;
  const int n_tiles = CAUSAL ? min(nk, (q0 + BM - 1) / BN + 1) : nk;
  const int tid = threadIdx.x;

  if (tid == 0) {
    prefetch_tensormap(&map_q);
    prefetch_tensormap(&map_k);
    prefetch_tensormap(&map_v);
    prefetch_tensormap(&map_o);
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 33);  // the TMA's expected bytes + the producer warp's 32 lanes (bias)
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], 8);  // one lane of each consumer warp
      mbar_init(&v_empty[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid < 128) {
    // ---------------------------------------------------- producer ---
    reg_dealloc<PRODUCER_REGS>();
    if (tid < 32) {
      const int lane = tid;
      if (lane == 0) {
        mbar_arrive_expect_tx(q_full, S::QK_TILE);
        for (int c = 0; c < QKB; ++c)
          tma_load_4d(base + S::Q + c * CHUNK, &map_q, q_full, c * BOX, h, q0, b);
      }
      const float* bias_row = p.bias + (long long)b * p.bias_sb;
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        const int k0 = j * BN;
        const uint32_t parity = ((j / STAGES) & 1) ^ 1;  // round 0 passes at once
        mbar_wait(&k_empty[s], parity);
        if (lane == 0) {
          mbar_arrive_expect_tx(&k_full[s], S::QK_TILE);
          for (int c = 0; c < QKB; ++c)
            tma_load_4d(base + S::K + s * S::QK_TILE + c * CHUNK, &map_k, &k_full[s], c * BOX, h,
                        k0, b);
        }
        mbar_wait(&v_empty[s], parity);
        if (lane == 0) {
          mbar_arrive_expect_tx(&v_full[s], S::V_TILE);
          for (int c = 0; c < VB; ++c)
            tma_load_4d(base + S::V + s * S::V_TILE + c * CHUNK, &map_v, &v_full[s], c * BOX, h,
                        k0, b);
        }
        // the bias goes in while the tiles are in flight (its slot is free:
        // K_{j - STAGES} and its bias were released before k_empty)
        float* bs = bias_s + s * BN;
        bool nz = false;
        for (int i = lane; i < BN; i += 32) {
          bs[i] = k0 + i < p.Tk ? bias_row[k0 + i] : NEG_INF;
          nz |= bs[i] != 0.f;
        }
        nz = __any_sync(0xffffffffu, nz);
        if (lane == 0) bias_nz[s] = nz;
        mbar_arrive(&k_full[s]);
      }
    }
  } else {
    // --------------------------------------------------- consumers ---
    reg_alloc<CONSUMER_REGS>();
    const int cw = tid / 128 - 1;     // consumer warpgroup: rows cw * 64 .. + 63
    const int ctid = tid % 128;
    const int warp = ctid / 32, lane = ctid % 32;
    const int g = lane / 4, t = lane % 4;
    const int wrow0 = q0 + cw * 64;            // first row of this warpgroup
    const int row0 = wrow0 + warp * 16 + g;    // this thread's rows: row0, row0 + 8
    const uint32_t q_addr = smem_u32(base + S::Q) + cw * 64 * 128;
    auto release = [&](uint64_t* bar) {  // one arrival per consumer warp
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };

    float o[NV / 2];  // m64 x NV accumulator: NV / 8 blocks of 8 columns x 4
#pragma unroll
    for (int i = 0; i < NV / 2; ++i) o[i] = 0.f;
    float m_run[2] = {NEG_INF, NEG_INF};
    float l_run[2] = {0.f, 0.f};  // this thread's share; summed over the quad at the end
    float alpha[2];
    uint32_t pa[32];

    // Software pipeline inside the warpgroup: S_j = Q K_j^T is issued
    // together with O += P_{j-1} V_{j-1}, and the softmax of S_j runs
    // while the tensor cores finish the PV product; O is rescaled once
    // that product has landed.  Between the two warpgroups, a ping-pong
    // on named barriers 3 and 4 lets one issue its products while the
    // other runs its softmax (warpgroup 0 goes first).
    const int issues = n_tiles + 1;  // product issues of this warpgroup
    int issued = 0;
    auto my_turn = [&] { named_barrier_sync(3 + cw, 256); };
    auto their_turn = [&] {
      if (cw == 0 || ++issued < issues) named_barrier_arrive(3 + (cw ^ 1), 256);
    };
    if (cw == 1) named_barrier_arrive(3, 256);
    mbar_wait(q_full, 0);
    mbar_wait(&k_full[0], 0);
    {
      float sc[64];
      my_turn();
      wgmma_fence();
      issue_qk<KSTEPS>(sc, q_addr, smem_u32(base + S::K));
      wgmma_commit();
      their_turn();
      wgmma_wait<0>();
      fence_regs(sc);
      softmax_tile<CAUSAL>(sc, bias_s, bias_nz[0], p.scale, wrow0, row0, 0, t, m_run, l_run,
                           alpha);
      release(&k_empty[0]);
      pack_p(sc, pa);
    }
    for (int j = 1; j < n_tiles; ++j) {
      const int s = j % STAGES, sp = (j - 1) % STAGES;
      float sc[64];
      mbar_wait(&k_full[s], (j / STAGES) & 1);
      mbar_wait(&v_full[sp], ((j - 1) / STAGES) & 1);
      my_turn();
      wgmma_fence();
      issue_qk<KSTEPS>(sc, q_addr, smem_u32(base + S::K + s * S::QK_TILE));
      wgmma_commit();
      issue_pv<NV>(o, pa, smem_u32(base + S::V + sp * S::V_TILE));
      wgmma_commit();
      their_turn();
      wgmma_wait<1>();  // S_j is in
      fence_regs(sc);
      softmax_tile<CAUSAL>(sc, bias_s + s * BN, bias_nz[s], p.scale, wrow0, row0, j * BN, t,
                           m_run, l_run, alpha);
      release(&k_empty[s]);  // K_j and its bias are read
      wgmma_wait<0>();       // P_{j-1} V_{j-1} is in
      fence_regs(o);
      release(&v_empty[sp]);
      rescale_o<NV>(o, alpha);
      pack_p(sc, pa);
    }
    {
      const int sp = (n_tiles - 1) % STAGES;
      mbar_wait(&v_full[sp], ((n_tiles - 1) / STAGES) & 1);
      my_turn();
      issue_pv<NV>(o, pa, smem_u32(base + S::V + sp * S::V_TILE));
      wgmma_commit();
      their_turn();
      wgmma_wait<0>();
      fence_regs(o);
      release(&v_empty[sp]);
    }

    // ------------------------------------------------------ epilogue ---
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
      l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
    }
    // O / l as bf16 into this warpgroup's 64 rows of the Q tile, in the
    // 128-byte swizzle the O map stores from, once all four warps are past
    // their last product (each reads all 64 rows)
    named_barrier_sync(1 + cw, 128);
    unsigned char* ot = base + S::Q + cw * 64 * 128;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = warp * 16 + g + 8 * i;
      const float l = l_run[i] == 0.f ? 1.f : l_run[i];
#pragma unroll
      for (int nb = 0; nb < NV / 8; ++nb) {
        const int c = nb * 8 + 2 * t, cin = c % BOX;
        const int off = (c / BOX) * CHUNK + r * 128 + (((cin / 8) ^ (r % 8)) * 16) + (cin % 8) * 2;
        *reinterpret_cast<uint32_t*>(ot + off) =
            pack_bf16(o[4 * nb + 2 * i] / l, o[4 * nb + 2 * i + 1] / l);
      }
    }
    fence_proxy_async();
    named_barrier_sync(1 + cw, 128);
    if (ctid == 0 && wrow0 < p.Tq) {
      for (int c = 0; c < VB; ++c) tma_store_4d(&map_o, ot + c * CHUNK, c * BOX, h, wrow0, b);
      tma_store_commit_and_wait();
    }
    if (LSE && t == 0) {  // the quad's four threads hold the same m and l
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = row0 + 8 * i;
        if (row < p.Tq)
          p.lse[((long long)b * p.nh + h) * p.Tq + row] = row_lse(m_run[i], l_run[i]);
      }
    }
  }
}

template <int KSTEPS, int NV, bool CAUSAL, bool LSE>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      const __grid_constant__ CUtensorMap map_o, const Params p) {
  fwd_body<KSTEPS, NV, STAGES, CAUSAL, LSE>(map_q, map_k, map_v, map_o, p);
}

// latent attention: q.k over 192 columns, v and o of 128, two stages
template <bool CAUSAL, bool LSE>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_mla_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     const __grid_constant__ CUtensorMap map_o, const Params p) {
  fwd_body<12, 128, STAGES_MLA, CAUSAL, LSE>(map_q, map_k, map_v, map_o, p);
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int smem, const CUtensorMap* maps, const Params& p, int B,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(p.m_tiles, p.nh, B);
  kernel<<<grid, THREADS, smem, stream>>>(maps[0], maps[1], maps[2], maps[3], p);
  return cudaGetLastError();
}

template <int KSTEPS, int NV>
cudaError_t launch_hd(const CUtensorMap* maps, const Params& p, int B, bool causal,
                      cudaStream_t stream) {
  const int smem = SmemOf<KSTEPS, NV, STAGES>::ALLOC;
  if (causal)
    return p.lse ? launch(flash_fwd_sm90_kernel<KSTEPS, NV, true, true>, smem, maps, p, B, stream)
                 : launch(flash_fwd_sm90_kernel<KSTEPS, NV, true, false>, smem, maps, p, B, stream);
  return p.lse ? launch(flash_fwd_sm90_kernel<KSTEPS, NV, false, true>, smem, maps, p, B, stream)
               : launch(flash_fwd_sm90_kernel<KSTEPS, NV, false, false>, smem, maps, p, B, stream);
}

cudaError_t launch_mla(const CUtensorMap* maps, const Params& p, int B, bool causal,
                       cudaStream_t stream) {
  const int smem = SmemOf<12, 128, STAGES_MLA>::ALLOC;
  static_assert(SmemOf<12, 128, STAGES_MLA>::ALLOC <= 232448, "MLA tiles exceed shared memory");
  if (causal)
    return p.lse ? launch(flash_fwd_mla_kernel<true, true>, smem, maps, p, B, stream)
                 : launch(flash_fwd_mla_kernel<true, false>, smem, maps, p, B, stream);
  return p.lse ? launch(flash_fwd_mla_kernel<false, true>, smem, maps, p, B, stream)
               : launch(flash_fwd_mla_kernel<false, false>, smem, maps, p, B, stream);
}

}  // namespace

extern "C" {

// bf16 only.  Strides in elements (batch, token, head); the last
// dimension contiguous; bases and strides 16-byte aligned, hd (q and k) and
// hd_v (v and o) multiples of 8: hd_v == hd up to 128, or latent
// attention's hd in 136..192 with hd_v up to 128.  o is contiguous [B, Tq,
// nh, hd_v].  lse: null, or [B, nh, Tq] f32.  Returns the cudaError_t of
// the map encoding or the launch (0 = success).
int tdax_flash_fwd_sm90(const void* q, const void* k, const void* v, const float* bias, void* o,
                        int B, int Tq, int Tk, int nh, int hd, int hd_v,
                        long long q_sb, long long q_st, long long q_sh,
                        long long k_sb, long long k_st, long long k_sh,
                        long long v_sb, long long v_st, long long v_sh,
                        long long bias_sb, int causal, float scale, float* lse, void* stream) {
  const bool mla = hd_v != hd;
  if (hd < 8 || hd % 8 || hd_v < 8 || hd_v % 8 || hd_v > 128 || (mla ? hd <= 128 || hd > 192
                                                                    : hd > 128) ||
      B < 1 || B > 65535 || Tq < 1 || Tk < 1 || nh < 1 || nh > 65535)
    return (int)cudaErrorInvalidValue;
  CUtensorMap maps[4];
  const void* ptrs[3] = {q, k, v};
  const long long strides[3][3] = {{q_sh, q_st, q_sb}, {k_sh, k_st, k_sb}, {v_sh, v_st, v_sb}};
  for (int i = 0; i < 3; ++i) {
    const uint64_t dims[4] = {(uint64_t)(i == 2 ? hd_v : hd), (uint64_t)nh,
                              (uint64_t)(i == 0 ? Tq : Tk), (uint64_t)B};
    const uint64_t bytes[3] = {2ull * strides[i][0], 2ull * strides[i][1], 2ull * strides[i][2]};
    cudaError_t err = encode_bf16_4d(&maps[i], ptrs[i], dims, bytes, BOX, BN);
    if (err != cudaSuccess) return (int)err;
  }
  const uint64_t odims[4] = {(uint64_t)hd_v, (uint64_t)nh, (uint64_t)Tq, (uint64_t)B};
  const uint64_t obytes[3] = {2ull * hd_v, 2ull * hd_v * nh, 2ull * hd_v * nh * Tq};
  cudaError_t err = encode_bf16_4d(&maps[3], o, odims, obytes, BOX, 64);
  if (err != cudaSuccess) return (int)err;

  const int m_tiles = (Tq + BM - 1) / BM;
  Params p{bias, lse, Tq, Tk, nh, bias_sb, scale, m_tiles};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mla) return (int)launch_mla(maps, p, B, causal != 0, s);
  if (hd <= 64) return (int)launch_hd<4, 64>(maps, p, B, causal != 0, s);
  if (hd <= 104) return (int)launch_hd<7, 104>(maps, p, B, causal != 0, s);
  return (int)launch_hd<8, 128>(maps, p, B, causal != 0, s);
}

const char* tdax_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
