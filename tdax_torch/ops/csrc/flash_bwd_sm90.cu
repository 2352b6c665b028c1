// Flash-attention backward for Hopper (sm_90a): TMA, an mbarrier ring and
// wgmma in warp-specialised blocks.  Plain C interface.
//
// Replaces the Pallas TPU kernels tdax/ops/flash_attention.py::_bwd_dq_kernel
// (:395) and ::_bwd_dkv_kernel (:446), driven there by _flash_bwd_impl and
// _build_flash, for bf16 inputs that TMA can read: the function is
// flash_bwd.cu's, unchanged.  With the forward's per-row log-normalizer
// lse and delta_i = sum_d dO[i, d] O[i, d] (both [B, nh, Tq] f32, computed
// outside):
//
//   s_ij  = fl(fl(q_i . k_j * scale) + bias_j)  (masked where causal, j > i)
//   p_ij  = exp(s_ij - lse_i)                   (0 where masked)
//   ds_ij = p_ij (dO_i . v_j - delta_i) scale
//   dq_i  = sum_j bf16(ds_ij) k_j,  dk_j = sum_i bf16(ds_ij) q_i,
//   dv_j  = sum_i bf16(p_ij) dO_i,
//
// every product accumulated in f32, outputs written in bf16.  flash_bwd.cu
// keeps f32 and the inputs TMA cannot read or that would leave a block
// mostly empty (tdax_torch/ops/flash_attention.py::_bwd_route).
//
// Layout: q/dO [B, Tq, nh, hd], k/v [B, Tk, nh, hd] through their strides
// (the last dimension contiguous, bases and other strides 16-byte aligned,
// hd a multiple of 8 up to 128), bias [B, Tk] f32; dq [B, Tq, nh, hd] and
// dk/dv [B, Tk, nh, hd] contiguous.  Each is a 4-D tensor map (hd, nh, T,
// B), so v may be a view of the fused qkv projection.
//
// What bounds it on an H100 (989 TFLOP/s bf16, 3.35 TB/s): the dq kernel
// does three products of 2 hd flops per visible (query, key) pair, the
// dk/dv kernel four, on 2 (Tq + Tk) hd bf16 per (batch, head) of inputs:
// at the decoder's training shape [4, 1024, 32, 128] causal that is ~500
// flop/byte, above the ridge (295), so the tensor cores bound both.  The
// design keeps them fed:
//
// - Two kernels, as tdax has.  A dk/dv block owns 128 keys of one (batch,
//   head) and streams 64-row Q and dO tiles; a dq block owns 128 q rows and
//   streams 64-key K and V tiles.  384 threads: a producer warpgroup (its
//   warp 0 works; setmaxnreg.dec to 24) and two consumer warpgroups of 64
//   keys or rows each, wgmma's M (setmaxnreg.inc to 240).
// - The producer loads the resident pair (K, V or Q, dO) once by TMA and
//   the streamed pair into a ring of STAGES = 4 stages with full and empty
//   mbarriers; with each stage it stages, by plain loads, the tile's lse
//   (as lse log2 e, +inf past Tq) and delta (dk/dv), or its bias (NEG_INF
//   past Tk, dq).  Tiles are 128-byte swizzled, 64 columns a box: hd 128
//   or 104 arrives as two boxes, hd <= 64 as one, zeros past hd, Tq and Tk.
// - dk/dv: S^T = K Q^T and dP^T = V dO^T as wgmma m64n64k16 with both
//   operands K-major in shared memory; p^T and ds^T in registers on the
//   accumulator fragments (s keeps flash_bwd.cu's two roundings; p =
//   2^(s log2 e - lse log2 e) on the MUFU ex2); then dV += bf16(P^T) dO and
//   dK += bf16(dS^T) Q as wgmma with A in registers (the f32 fragments pack
//   into bf16 A fragments without shuffles) and B, the stored [q, hd]
//   tile, read MN-major through the transpose bit.  S^T's wait returns
//   before dP^T's, so p's exponentials run under dP^T's product.  The two
//   warpgroups share each stage and take turns to issue their products
//   (named barriers 3 and 4), so one's p and ds run on the CUDA cores
//   under the other's products (4-6% at the training shape).
// - dq: S = Q K^T and dP = dO V^T the same way, then dQ += bf16(dS) K with
//   K read MN-major.
// - Causal: tiles wholly above the diagonal are skipped, by the block (its
//   tile range) and by a warpgroup (a streamed tile none of whose pairs
//   it sees); only the diagonal tile is masked.  A head's blocks are
//   neighbours in the grid, so they run together and read the streamed
//   tiles from L2 after the first; the heaviest causal block goes first.
// - Epilogue: the accumulators go as bf16 into the warpgroup's rows of its
//   resident tiles (no longer read), in the swizzled layout, and out by a
//   TMA store, which clips rows past T and columns past hd.
//
// Budget at hd 128, per consumer thread: dK 64 + dV 64 f32 accumulators,
// S^T 32 and dP^T 32, the packed P^T and dS^T 16 + 16 (the dq kernel: dQ
// 64, S 32, dP 32, dS 16); 128 x 24 + 256 x 240 = 64,512 of the 65,536
// registers.  Shared memory 195 KB: the resident pair 64 KB, four stages
// of 32 KB, 2 KB of lse/delta or bias, the barriers.
//
// No atomics: every output element is summed by one thread of one block,
// over the streamed tiles in order, so the result is bitwise the same from
// run to run (train_loop's resume depends on it).  A fused single kernel
// (S and dP once, dq summed across key blocks) would need atomics or an
// ordered cross-block reduction; it is not this design.
//
// Accuracy: ex2.approx on (s - lse) log2 e differs from expf by ~2^-22
// relative, far below the bf16 step (2^-8) at which p and ds are rounded;
// the checks hold it to flash_bwd.cu's tolerances.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int BLK = 128;         // keys (dk/dv) or q rows (dq) per block
constexpr int BT = 64;           // rows of a streamed tile
constexpr int STAGES = 4;
constexpr int THREADS = 384;     // producer warpgroup + two consumer warpgroups
constexpr int BOX = 64;          // columns per TMA box (128 bytes of bf16)
constexpr int BIG_BOX = BLK * 128;   // bytes of a 128-row, 64-column box
constexpr int SMALL_BOX = BT * 128;  // bytes of a 64-row, 64-column box
constexpr uint32_t PRODUCER_REGS = 24, CONSUMER_REGS = 240;

// shared memory, as offsets from a 1024-aligned base
template <int HDP>
struct Smem {
  static constexpr int NCH = HDP / BOX;          // boxes per row
  static constexpr int BIG = NCH * BIG_BOX;      // a resident 128-row tile
  static constexpr int SMALL = NCH * SMALL_BOX;  // a streamed 64-row tile
  static constexpr int RES0 = 0;                 // K (dk/dv) or Q (dq)
  static constexpr int RES1 = RES0 + BIG;        // V (dk/dv) or dO (dq)
  static constexpr int RING = RES1 + BIG;        // per stage: Q, dO (dk/dv) or K, V (dq)
  static constexpr int STAGE = 2 * SMALL;
  static constexpr int VEC = RING + STAGES * STAGE;  // per stage: 2 x BT floats
  static constexpr int BAR = VEC + STAGES * 2 * BT * 4;
  static constexpr int BYTES = BAR + (1 + 2 * STAGES) * 8;
  static constexpr int ALLOC = BYTES + 1024;     // room to align the base
};

struct Params {
  const float* bias;
  const float* lse;    // [B, nh, Tq]
  const float* delta;  // [B, nh, Tq]
  int Tq, Tk, nh;
  long long bias_sb;
  float scale;
  int blocks;          // blocks along the owned axis (grid x)
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo (low half)
  return *reinterpret_cast<uint32_t*>(&v);
}

// A 64 x 64 accumulator as bf16 A fragments: column blocks 2kk and 2kk + 1
// form k-step kk
__device__ __forceinline__ void pack_a(const float (&x)[32], uint32_t (&a)[16]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[4 * kk + 0] = pack_bf16(x[8 * kk + 0], x[8 * kk + 1]);
    a[4 * kk + 1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
    a[4 * kk + 2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
    a[4 * kk + 3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

// acc = A B^T over KSTEPS steps of 16 columns (zeros past hd): A the
// warpgroup's 64 rows of a resident 128-row tile, B a streamed 64-row
// tile, both K-major in shared memory.  The step count is a template
// parameter: a run-time bound would split the chain of wgmmas, and ptxas
// then fences between them.
template <int KSTEPS>
__device__ __forceinline__ void issue_scores(float (&acc)[32], uint32_t a_addr, uint32_t b_addr) {
  wgmma_m64n64k16_ss_first(acc, desc_sw128(a_addr, 0, 1024), desc_sw128(b_addr, 0, 1024));
#pragma unroll
  for (int ks = 1; ks < KSTEPS; ++ks) {
    const uint32_t col = (ks % 4) * 32;
    wgmma_m64n64k16_ss(acc, desc_sw128(a_addr + (ks / 4) * BIG_BOX + col, 0, 1024),
                       desc_sw128(b_addr + (ks / 4) * SMALL_BOX + col, 0, 1024));
  }
}

// acc += A B over 64 rows of B: A in registers (64 x 64 bf16), B a
// streamed [64, hd] tile, MN-major for this product (the transpose bit),
// hd's 64-column boxes SMALL_BOX bytes apart
template <int HDP>
__device__ __forceinline__ void issue_grad(float (&acc)[HDP / 2], uint32_t (&a)[16],
                                           uint32_t b_addr) {
  fence_regs(a);
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = desc_sw128(b_addr + kk * 16 * 128, SMALL_BOX, 1024);
    if constexpr (HDP == 128)
      wgmma_m64n128k16_rs_tb(acc, &a[4 * kk], db);
    else
      wgmma_m64n64k16_rs_tb(acc, &a[4 * kk], db);
  }
}

// An accumulator [64, HDP] as bf16 into the warpgroup's 64 rows of a
// resident tile (boxes BIG_BOX bytes apart), in the 128-byte swizzle the
// TMA store reads
template <int HDP>
__device__ __forceinline__ void stage_out(unsigned char* tile, const float (&acc)[HDP / 2],
                                          int warp, int g, int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + g + 8 * i;
#pragma unroll
    for (int nb = 0; nb < HDP / 8; ++nb) {
      const int c = nb * 8 + 2 * t, cin = c % BOX;
      const int off = (c / BOX) * BIG_BOX + r * 128 + (((cin / 8) ^ (r % 8)) * 16) + (cin % 8) * 2;
      *reinterpret_cast<uint32_t*>(tile + off) = pack_bf16(acc[4 * nb + 2 * i], acc[4 * nb + 2 * i + 1]);
    }
  }
}

// Turns between the two consumer warpgroups (named barriers 3 and 4):
// each issues its products only in its turn and then hands the turn over,
// so one runs p and ds on the CUDA cores while the other's products run
// on the tensor cores; warpgroup 0 goes first.  Both take the same number
// of turns (an empty one where a warpgroup skips a tile's products);
// warpgroup 1 opens with a handover and so skips its last.
struct Turns {
  int cw, left;
  __device__ __forceinline__ Turns(int cw_, int total) : cw(cw_), left(total) {
    if (cw == 1 && total > 0) named_barrier_arrive(3, 256);
  }
  __device__ __forceinline__ void mine() const { named_barrier_sync(3 + cw, 256); }
  __device__ __forceinline__ void theirs() {
    if (cw == 0 || --left > 0) named_barrier_arrive(3 + (cw ^ 1), 256);
  }
  __device__ __forceinline__ void pass() {
    mine();
    theirs();
  }
};

// ------------------------------------------------------------- dk / dv ---

template <int HDP, bool CAUSAL>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          const __grid_constant__ CUtensorMap map_do,
                          const __grid_constant__ CUtensorMap map_dk,
                          const __grid_constant__ CUtensorMap map_dv, const Params p) {
  using S = Smem<HDP>;
  constexpr int NCH = S::NCH;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* vec = reinterpret_cast<float*>(base + S::VEC);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + S::BAR);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + STAGES;

  // a head's key blocks are neighbours in the grid; the first key block,
  // the heaviest when causal, goes first
  const int k0 = blockIdx.x * BLK;
  const int h = blockIdx.y, b = blockIdx.z;
  const int nq = (p.Tq + BT - 1) / BT;
  const int first = CAUSAL ? min(k0 / BT, nq) : 0;  // the first q tile reaching key k0
  const int n_tiles = nq - first;
  const int tid = threadIdx.x;

  if (tid == 0) {
    prefetch_tensormap(&map_q);
    prefetch_tensormap(&map_k);
    prefetch_tensormap(&map_v);
    prefetch_tensormap(&map_do);
    prefetch_tensormap(&map_dk);
    prefetch_tensormap(&map_dv);
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 33);  // the TMA's expected bytes + the producer warp's 32 lanes
      mbar_init(&empty[s], 8);  // one lane of each consumer warp
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
        mbar_arrive_expect_tx(kv_full, 2 * S::BIG);
        for (int c = 0; c < NCH; ++c) {
          tma_load_4d(base + S::RES0 + c * BIG_BOX, &map_k, kv_full, c * BOX, h, k0, b);
          tma_load_4d(base + S::RES1 + c * BIG_BOX, &map_v, kv_full, c * BOX, h, k0, b);
        }
      }
      const long long row_base = ((long long)b * p.nh + h) * p.Tq;
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        const int q0 = (first + j) * BT;
        mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);  // round 0 passes at once
        if (lane == 0) {
          unsigned char* st = base + S::RING + s * S::STAGE;
          mbar_arrive_expect_tx(&full[s], S::STAGE);
          for (int c = 0; c < NCH; ++c) {
            tma_load_4d(st + c * SMALL_BOX, &map_q, &full[s], c * BOX, h, q0, b);
            tma_load_4d(st + S::SMALL + c * SMALL_BOX, &map_do, &full[s], c * BOX, h, q0, b);
          }
        }
        // lse log2 e (+inf past Tq, where p is then 0) and delta
        float* vs = vec + s * 2 * BT;
        for (int i = lane; i < BT; i += 32) {
          const int row = q0 + i;
          const bool ok = row < p.Tq;
          vs[i] = ok ? p.lse[row_base + row] * LOG2E : __int_as_float(0x7f800000);
          vs[BT + i] = ok ? p.delta[row_base + row] : 0.f;
        }
        mbar_arrive(&full[s]);
      }
    }
  } else {
    // --------------------------------------------------- consumers ---
    reg_alloc<CONSUMER_REGS>();
    const int cw = tid / 128 - 1;     // consumer warpgroup: keys cw * 64 .. + 63
    const int ctid = tid % 128;
    const int warp = ctid / 32, lane = ctid % 32;
    const int g = lane / 4, t = lane % 4;
    const int wk0 = k0 + cw * 64;             // first key of this warpgroup
    const int key0 = wk0 + warp * 16 + g;     // this thread's keys: key0, key0 + 8
    float bias_r[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = key0 + 8 * i;
      bias_r[i] = key < p.Tk ? p.bias[(long long)b * p.bias_sb + key] : NEG_INF;
    }
    const uint32_t k_addr = smem_u32(base + S::RES0) + cw * 64 * 128;
    const uint32_t v_addr = smem_u32(base + S::RES1) + cw * 64 * 128;
    auto release = [&](uint64_t* bar) {  // one arrival per consumer warp
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };

    float dk[HDP / 2], dv[HDP / 2];  // m64 x HDP accumulators
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) dk[i] = dv[i] = 0.f;

    Turns turns(cw, 2 * n_tiles);
    mbar_wait(kv_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % STAGES;
      const int q0 = (first + j) * BT;
      mbar_wait(&full[s], (j / STAGES) & 1);
      if (CAUSAL && q0 + BT - 1 < wk0) {  // every row of the tile precedes these keys
        turns.pass();
        turns.pass();
        release(&empty[s]);
        continue;
      }
      const uint32_t q_addr = smem_u32(base + S::RING + s * S::STAGE);
      const uint32_t do_addr = q_addr + S::SMALL;
      const float* vs = vec + s * 2 * BT;
      float st[32], dpt[32];  // S^T and dP^T: keys x q rows
      turns.mine();
      wgmma_fence();
      issue_scores<HDP / 16>(st, k_addr, q_addr);
      wgmma_commit();
      issue_scores<HDP / 16>(dpt, v_addr, do_addr);
      wgmma_commit();
      turns.theirs();
      wgmma_wait<1>();  // S^T is in; dP^T's product runs under p's exponentials
      fence_regs(st);
      const bool diag = CAUSAL && q0 < wk0 + 64;
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        const float2 l2 = *reinterpret_cast<const float2*>(vs + nb * 8 + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float sv = __fadd_rn(__fmul_rn(st[4 * nb + e], p.scale), bias_r[e >> 1]);
          float pv = ex2(fmaf(sv, LOG2E, -((e & 1) ? l2.y : l2.x)));
          if (diag && q0 + nb * 8 + 2 * t + (e & 1) < key0 + 8 * (e >> 1)) pv = 0.f;
          st[4 * nb + e] = pv;
        }
      }
      wgmma_wait<0>();
      fence_regs(dpt);
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        const float2 dl = *reinterpret_cast<const float2*>(vs + BT + nb * 8 + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dpt[4 * nb + e] = __fmul_rn(__fmul_rn(st[4 * nb + e],
                                                dpt[4 * nb + e] - ((e & 1) ? dl.y : dl.x)),
                                      p.scale);
      }
      uint32_t pa[16], da[16];
      pack_a(st, pa);
      pack_a(dpt, da);
      turns.mine();
      issue_grad<HDP>(dv, pa, do_addr);
      issue_grad<HDP>(dk, da, q_addr);
      wgmma_commit();
      turns.theirs();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      release(&empty[s]);  // Q, dO, lse and delta of this stage are read
    }

    // ------------------------------------------------------ epilogue ---
    // dK and dV as bf16 into this warpgroup's rows of the K and V tiles
    // once all four warps are past their last product
    named_barrier_sync(1 + cw, 128);
    unsigned char* kt = base + S::RES0 + cw * 64 * 128;
    unsigned char* vt = base + S::RES1 + cw * 64 * 128;
    stage_out<HDP>(kt, dk, warp, g, t);
    stage_out<HDP>(vt, dv, warp, g, t);
    fence_proxy_async();
    named_barrier_sync(1 + cw, 128);
    if (ctid == 0 && wk0 < p.Tk) {
      for (int c = 0; c < NCH; ++c) {
        tma_store_4d(&map_dk, kt + c * BIG_BOX, c * BOX, h, wk0, b);
        tma_store_4d(&map_dv, vt + c * BIG_BOX, c * BOX, h, wk0, b);
      }
      tma_store_commit_and_wait();
    }
  }
}

// ------------------------------------------------------------------ dq ---

template <int HDP, bool CAUSAL>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const __grid_constant__ CUtensorMap map_do,
                         const __grid_constant__ CUtensorMap map_dq, const Params p) {
  using S = Smem<HDP>;
  constexpr int NCH = S::NCH;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* vec = reinterpret_cast<float*>(base + S::VEC);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + S::BAR);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + STAGES;

  // a head's q blocks are neighbours in the grid; the last, the heaviest
  // when causal, goes first
  const int q0 = (p.blocks - 1 - (int)blockIdx.x) * BLK;
  const int h = blockIdx.y, b = blockIdx.z;
  const int nk = (p.Tk + BT - 1) / BT;
  const int n_tiles = CAUSAL ? min(nk, (q0 + BLK - 1) / BT + 1) : nk;
  const int tid = threadIdx.x;

  if (tid == 0) {
    prefetch_tensormap(&map_q);
    prefetch_tensormap(&map_k);
    prefetch_tensormap(&map_v);
    prefetch_tensormap(&map_do);
    prefetch_tensormap(&map_dq);
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 33);  // the TMA's expected bytes + the producer warp's 32 lanes
      mbar_init(&empty[s], 8);  // one lane of each consumer warp
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
        mbar_arrive_expect_tx(q_full, 2 * S::BIG);
        for (int c = 0; c < NCH; ++c) {
          tma_load_4d(base + S::RES0 + c * BIG_BOX, &map_q, q_full, c * BOX, h, q0, b);
          tma_load_4d(base + S::RES1 + c * BIG_BOX, &map_do, q_full, c * BOX, h, q0, b);
        }
      }
      const float* bias_row = p.bias + (long long)b * p.bias_sb;
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        const int k0 = j * BT;
        mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);  // round 0 passes at once
        if (lane == 0) {
          unsigned char* st = base + S::RING + s * S::STAGE;
          mbar_arrive_expect_tx(&full[s], S::STAGE);
          for (int c = 0; c < NCH; ++c) {
            tma_load_4d(st + c * SMALL_BOX, &map_k, &full[s], c * BOX, h, k0, b);
            tma_load_4d(st + S::SMALL + c * SMALL_BOX, &map_v, &full[s], c * BOX, h, k0, b);
          }
        }
        float* bs = vec + s * 2 * BT;  // the tile's bias, NEG_INF past Tk
        for (int i = lane; i < BT; i += 32) bs[i] = k0 + i < p.Tk ? bias_row[k0 + i] : NEG_INF;
        mbar_arrive(&full[s]);
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
    float lse_l2[2], delta_r[2];  // +inf past Tq: p = 0 there
    const long long row_base = ((long long)b * p.nh + h) * p.Tq;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      const bool ok = row < p.Tq;
      lse_l2[i] = ok ? p.lse[row_base + row] * LOG2E : __int_as_float(0x7f800000);
      delta_r[i] = ok ? p.delta[row_base + row] : 0.f;
    }
    const uint32_t q_addr = smem_u32(base + S::RES0) + cw * 64 * 128;
    const uint32_t do_addr = smem_u32(base + S::RES1) + cw * 64 * 128;
    auto release = [&](uint64_t* bar) {  // one arrival per consumer warp
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };

    float dq[HDP / 2];  // m64 x HDP accumulator
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) dq[i] = 0.f;

    Turns turns(cw, 2 * n_tiles);
    mbar_wait(q_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % STAGES;
      const int k0 = j * BT;
      mbar_wait(&full[s], (j / STAGES) & 1);
      if (CAUSAL && k0 > wrow0 + 63) {  // every key of the tile follows these rows
        turns.pass();
        turns.pass();
        release(&empty[s]);
        continue;
      }
      const uint32_t k_addr = smem_u32(base + S::RING + s * S::STAGE);
      const uint32_t v_addr = k_addr + S::SMALL;
      const float* bs = vec + s * 2 * BT;
      float sc[32], dp[32];  // S and dP: q rows x keys
      turns.mine();
      wgmma_fence();
      issue_scores<HDP / 16>(sc, q_addr, k_addr);
      wgmma_commit();
      issue_scores<HDP / 16>(dp, do_addr, v_addr);
      wgmma_commit();
      turns.theirs();
      wgmma_wait<1>();  // S is in; dP's product runs under p's exponentials
      fence_regs(sc);
      const bool diag = CAUSAL && k0 + BT - 1 > wrow0;
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        const float2 bb = *reinterpret_cast<const float2*>(bs + nb * 8 + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float sv = __fadd_rn(__fmul_rn(sc[4 * nb + e], p.scale), (e & 1) ? bb.y : bb.x);
          float pv = ex2(fmaf(sv, LOG2E, -lse_l2[e >> 1]));
          if (diag && k0 + nb * 8 + 2 * t + (e & 1) > row0 + 8 * (e >> 1)) pv = 0.f;
          sc[4 * nb + e] = pv;
        }
      }
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[4 * nb + e] = __fmul_rn(__fmul_rn(sc[4 * nb + e], dp[4 * nb + e] - delta_r[e >> 1]),
                                     p.scale);
      uint32_t da[16];
      pack_a(dp, da);
      turns.mine();
      issue_grad<HDP>(dq, da, k_addr);
      wgmma_commit();
      turns.theirs();
      wgmma_wait<0>();
      fence_regs(dq);
      release(&empty[s]);  // K, V and the bias of this stage are read
    }

    // ------------------------------------------------------ epilogue ---
    named_barrier_sync(1 + cw, 128);
    unsigned char* qt = base + S::RES0 + cw * 64 * 128;
    stage_out<HDP>(qt, dq, warp, g, t);
    fence_proxy_async();
    named_barrier_sync(1 + cw, 128);
    if (ctid == 0 && wrow0 < p.Tq) {
      for (int c = 0; c < NCH; ++c) tma_store_4d(&map_dq, qt + c * BIG_BOX, c * BOX, h, wrow0, b);
      tma_store_commit_and_wait();
    }
  }
}

template <typename Kernel, typename... Maps>
cudaError_t launch(Kernel kernel, int smem, dim3 grid, cudaStream_t stream, const Params& p,
                   const Maps&... maps) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, smem, stream>>>(maps..., p);
  return cudaGetLastError();
}

// the four input maps (q, k, v, dO) over their strides; rows_q / rows_kv
// the box rows of q and dO / of k and v
cudaError_t encode_inputs(CUtensorMap* maps, const void* const ptrs[4], const long long st[4][3],
                          int B, int Tq, int Tk, int nh, int hd, int rows_q, int rows_kv) {
  for (int i = 0; i < 4; ++i) {
    const bool is_q = i == 0 || i == 3;
    const uint64_t dims[4] = {(uint64_t)hd, (uint64_t)nh, (uint64_t)(is_q ? Tq : Tk),
                              (uint64_t)B};
    const uint64_t bytes[3] = {2ull * st[i][0], 2ull * st[i][1], 2ull * st[i][2]};
    cudaError_t err = encode_bf16_4d(&maps[i], ptrs[i], dims, bytes, BOX,
                                     is_q ? rows_q : rows_kv);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// a contiguous [B, T, nh, hd] output, stored 64 rows a box
cudaError_t encode_output(CUtensorMap* map, void* out, int B, int T, int nh, int hd) {
  const uint64_t dims[4] = {(uint64_t)hd, (uint64_t)nh, (uint64_t)T, (uint64_t)B};
  const uint64_t bytes[3] = {2ull * hd, 2ull * hd * nh, 2ull * hd * nh * T};
  return encode_bf16_4d(map, out, dims, bytes, BOX, 64);
}

bool bad_shape(int B, int Tq, int Tk, int nh, int hd) {
  return hd < 8 || hd > 128 || hd % 8 || B < 1 || B > 65535 || Tq < 1 || Tk < 1 || nh < 1 ||
         nh > 65535;
}

}  // namespace

extern "C" {

// bf16 only.  Strides in elements (batch, token, head); the last
// dimension contiguous; bases and strides 16-byte aligned, hd a multiple
// of 8 up to 128.  dq is contiguous [B, Tq, nh, hd]; lse and delta [B, nh,
// Tq] f32.  Returns the cudaError_t of the map encoding or the launch
// (0 = success).
int tdax_flash_bwd_dq_sm90(const void* q, const void* k, const void* v, const void* dout,
                           const float* bias, const float* lse, const float* delta, void* dq,
                           int B, int Tq, int Tk, int nh, int hd,
                           long long q_sb, long long q_st, long long q_sh,
                           long long k_sb, long long k_st, long long k_sh,
                           long long v_sb, long long v_st, long long v_sh,
                           long long do_sb, long long do_st, long long do_sh,
                           long long bias_sb, int causal, float scale, void* stream) {
  if (bad_shape(B, Tq, Tk, nh, hd)) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[5];
  const void* ptrs[4] = {q, k, v, dout};
  const long long st[4][3] = {{q_sh, q_st, q_sb}, {k_sh, k_st, k_sb}, {v_sh, v_st, v_sb},
                              {do_sh, do_st, do_sb}};
  cudaError_t err = encode_inputs(maps, ptrs, st, B, Tq, Tk, nh, hd, BLK, BT);
  if (err == cudaSuccess) err = encode_output(&maps[4], dq, B, Tq, nh, hd);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (Tq + BLK - 1) / BLK;
  const Params p{bias, lse, delta, Tq, Tk, nh, bias_sb, scale, blocks};
  const dim3 grid(blocks, nh, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd <= 64)
    err = causal ? launch(flash_bwd_dq_sm90_kernel<64, true>, Smem<64>::ALLOC, grid, s, p,
                          maps[0], maps[1], maps[2], maps[3], maps[4])
                 : launch(flash_bwd_dq_sm90_kernel<64, false>, Smem<64>::ALLOC, grid, s, p,
                          maps[0], maps[1], maps[2], maps[3], maps[4]);
  else
    err = causal ? launch(flash_bwd_dq_sm90_kernel<128, true>, Smem<128>::ALLOC, grid, s, p,
                          maps[0], maps[1], maps[2], maps[3], maps[4])
                 : launch(flash_bwd_dq_sm90_kernel<128, false>, Smem<128>::ALLOC, grid, s, p,
                          maps[0], maps[1], maps[2], maps[3], maps[4]);
  return (int)err;
}

// As tdax_flash_bwd_dq_sm90; dk and dv are contiguous [B, Tk, nh, hd].
int tdax_flash_bwd_dkv_sm90(const void* q, const void* k, const void* v, const void* dout,
                            const float* bias, const float* lse, const float* delta, void* dk,
                            void* dv, int B, int Tq, int Tk, int nh, int hd,
                            long long q_sb, long long q_st, long long q_sh,
                            long long k_sb, long long k_st, long long k_sh,
                            long long v_sb, long long v_st, long long v_sh,
                            long long do_sb, long long do_st, long long do_sh,
                            long long bias_sb, int causal, float scale, void* stream) {
  if (bad_shape(B, Tq, Tk, nh, hd)) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[6];
  const void* ptrs[4] = {q, k, v, dout};
  const long long st[4][3] = {{q_sh, q_st, q_sb}, {k_sh, k_st, k_sb}, {v_sh, v_st, v_sb},
                              {do_sh, do_st, do_sb}};
  cudaError_t err = encode_inputs(maps, ptrs, st, B, Tq, Tk, nh, hd, BT, BLK);
  if (err == cudaSuccess) err = encode_output(&maps[4], dk, B, Tk, nh, hd);
  if (err == cudaSuccess) err = encode_output(&maps[5], dv, B, Tk, nh, hd);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (Tk + BLK - 1) / BLK;
  const Params p{bias, lse, delta, Tq, Tk, nh, bias_sb, scale, blocks};
  const dim3 grid(blocks, nh, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd <= 64)
    err = causal ? launch(flash_bwd_dkv_sm90_kernel<64, true>, Smem<64>::ALLOC, grid, s, p,
                          maps[0], maps[1], maps[2], maps[3], maps[4], maps[5])
                 : launch(flash_bwd_dkv_sm90_kernel<64, false>, Smem<64>::ALLOC, grid, s, p,
                          maps[0], maps[1], maps[2], maps[3], maps[4], maps[5]);
  else
    err = causal ? launch(flash_bwd_dkv_sm90_kernel<128, true>, Smem<128>::ALLOC, grid, s, p,
                          maps[0], maps[1], maps[2], maps[3], maps[4], maps[5])
                 : launch(flash_bwd_dkv_sm90_kernel<128, false>, Smem<128>::ALLOC, grid, s, p,
                          maps[0], maps[1], maps[2], maps[3], maps[4], maps[5]);
  return (int)err;
}

const char* tdax_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
