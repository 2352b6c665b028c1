#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tdax_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and nvcc.
It imports the port from this checkout (never ``jax``, never ``tdax``)
and runs these phases, printing JSON lines:

1. env      the card's name and power limit (nvidia-smi), torch/CUDA
            versions; builds every kernel of the port from the sources
            in the checkout (one nvcc per source, all started together,
            and the native Rips engine's g++ beside them); prints ptxas's
            register, spill, C7508 and setmaxnreg lines and fails if
            flash_fwd_sm90.cu or flash_bwd_sm90.cu spills or has
            setmaxnreg ignored (C7508).
2. kernels  each kernel's wrapper against its plain PyTorch version on
            the card.  flash_fwd, both kernels: the route must send the
            capture's three attention shapes (decoder, ViT, resampler;
            batch 16, bf16, the model's strided views) and the training
            shape [4, 1024, 32, 128] (causal, with lse) to the Hopper
            kernel (flash_fwd_sm90.cu); each is checked on it and on the
            mma kernel (flash_fwd.cu, forced by the private _kernel="mma")
            and both are timed beside SDPA, the plain version and the
            bound (kernel_case lines: ms, ms_mma, library_ms, bound_ms);
            the launch counters must move as the route says.  The mma
            kernel alone: f32 at the shapes of tests/test_flash_attention.py
            and the decode step's [16, 1, 352, 32, 128] with ragged key
            validity; fully masked rows on both (finite, lse 0).
            sqdist: the tests/test_scale_ops.py shapes, a ragged case
            with n and d odd, and the scale path's [10000, 4096].  qmm:
            bf16 at every (M, K, N) of the int8 capture and of a decode
            step (QMM_SITES), f32 at small ragged shapes.  Raises on a
            case outside its tolerance.  Times the kernel, the plain
            version and one PyTorch library call (SDPA; torch.cdist
            against the Euclidean wrapper; torch.matmul on the weight
            pre-converted to bf16; used nowhere in the port) with CUDA
            events, beside the least time the card could take (H100 SXM
            peaks: 989 TFLOP/s bf16, 67 TFLOP/s f32 without tensor
            cores, 3.35 TB/s).
3. capture  the port's main path at full width and depth: the 48-sample
            dataset, the full QwenVLConfig() in bf16 with random weights
            drawn on the card from a seed, extract_activations at batch
            16.  Checks the [32, 48, 4096] capture, finiteness, the .pt
            and .npz schemas, and that every attention went through the
            sm90 kernel (both counters = 3 batches x (48 + 1 + 32) = 243),
            then times the same capture once more, warm, and each of
            its host stages alone (tokenize, image decode, .npz, .pt).
            Before that, a tiny f32 model's capture on the card is held
            against the same capture on the CPU (plain attention), and
            its int8 tree's capture and generate (8 new tokens, fp and
            int8 caches) likewise: activations and logits within
            TINY_TOL, greedy tokens identical.  The bf16 capture must
            launch no qmm kernel.
4. profile  one batch's forward alone (synchronised host clock), then
            under torch.profiler: device busy time by kind (qmm kernel,
            flash kernel, GEMMs, other) and the idle share.
4b. int8     the capture's own bf16 weights quantized on the card, then
            extract_activations with ExtractConfig(quantize_int8=True):
            the [32, 48, 4096] capture, finite, tdax's schemas, qmm
            launches 3 x (199 + 160) = 1077 and flash 243, all sm90, minimum
            cosine per captured vector > 0.98 against the bf16 capture;
            the same profile of one batch.
4c. generate init_params_quantized(QwenVLConfig(), "cuda", seed=0), the
            first 16 samples' prompts (images, ToyTokenizer, padded to
            320), greedy generate of 32 tokens with bf16 caches and with
            kv_int8: ids in range, qmm launches 360 + 31 x 161 = 5351
            and flash 81 + 31 x 32 = 1073 each, the prefill's 81 on the
            sm90 kernel and the decode steps' 992 on the mma kernel
            (Tq = 1); the prefill's and the
            first two decode steps' logits against the uncached forward
            (CACHE_TOL), kv_int8's first decode logits within 0.05 x
            max|logit| of the bf16 cache's; a profile of one decode
            step.
5. sweep    the port's run_tda_sweep on the activations the capture
            wrote, read back through the port's load_activations: 32
            layers x 36 bound samples x 4096, UMAP (cosine, k 6, 3-d,
            500 epochs, spectral init), Rips H0/H1 in the native engine,
            shape and colour silhouettes (diagram PNGs and the evolution
            plot only where matplotlib is installed).  Checks
            summary_stats.json (32 entries, tdax's keys in tdax's order,
            finite) and the peak layer.  Then run_tda_sweep on bench.py's
            make_clouds recipe (seed 42, layer 25 clustered) on the card
            and, in the same process, on the CPU: the shape-silhouette
            peak must be layer 25 on both, silhouettes and max-H1 must
            agree within SWEEP_SIL_TOL / SWEEP_H1_TOL.  Times each stage.
6. scale    rips_at_scale on bench_scale.py's seeded 3-sphere cloud,
            10000 x 4096, threshold for ~40 neighbours, maxdim
            SCALE_MAXDIM: the distance matrix through the sqdist kernel
            (the launch counter must read exactly 1), H0 by Boruvka on
            the card, H1+ in the native engine.  Boruvka's H0 must equal
            the engine's dim-0 bars on the same matrix; a small
            two-cluster cloud must give the CPU's diagrams (bottleneck
            <= SMALL_BOTTLENECK_TOL per dimension).  Times each stage.
7. flash_bwd the flash backward kernels (dq; dk/dv) and the forward's
            lse output against their plain versions, bf16 and f32, at the
            decoder's training shape [4, 1024, 32, 128] (causal, the last
            row's final 128 keys masked), the ViT's (4 x 1024, 16 heads,
            hd 104), the resampler's (256 x 1024 keys, hd 128) and a
            ragged one.  bf16 goes to flash_bwd_sm90.cu (the route must
            say so) and is checked there and on flash_bwd.cu (forced by
            the private _kernel="mma"), the counters moving as the choice
            says; f32 stays on flash_bwd.cu.  At the training shape two
            runs of the sm90 pair must agree bitwise.  Kernel times of
            both pairs and SDPA's backward alone (autograd.grad over a
            retained graph; medians and spreads of 5 x 10 calls, and
            the profiler's device time, SDPA's yardstick), bound and
            plain times.
8. tiny_train the tiny f32 config trained on the card (kernels) and on the
            CPU (plain versions): loss and every gradient, three
            make_train_step steps, a with_images step, and train_loop
            stopped at step 4 and resumed to 6 bitwise equal to the
            uninterrupted run (checkpoint through tmp).
9. train    the full decoder width (QwenVLConfig(), text-only, bf16,
            7.72B params), default_optimizer(warmup_cosine_lr(1e-4, 2, 8)),
            remat, a fixed 4 x 1024 batch from --seed's numpy generator
            (the last row's final 128 positions masked): one warm step,
            five timed steps (64 flash forwards, all sm90, 32 dq and 32
            dk/dv launches each, all sm90), losses finite, decreasing
            and, at --seed 0, within TRAIN_LOSS_TOL of the reference
            trajectory, peak memory,
            the share of 989 TFLOP/s (bench_train.py's convention), and a
            profiled step's device time by kind.
10. the kernels line (flash_fwd and flash_bwd_* name both sources and
            the launches of each kernel on each path), the nvidia-smi
            line, then the last
            line {"ok": true, "device": {...}}.  Kernel times are
            reported, never gated: only correctness and launch counts
            fail the run.

Any failure raises, so the script exits non-zero and prints no result;
it also exits non-zero when no CUDA card is present.  ``--seed`` (default
0) draws the training phase's batch.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent

BF16_PEAK = 989e12      # H100 SXM dense bf16 tensor-core FLOP/s
F32_PEAK = 67e12        # H100 SXM f32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12

# bf16: the kernel rounds the un-normalized p to bf16 where the plain
# version rounds the normalized probabilities, and the two f32 results
# may round to neighbouring bf16 outputs (one ulp is 2^-7 relative).
BF16_ATOL, BF16_RTOL = 2e-2, 2e-2
F32_TOL = 2e-5          # tests/test_flash_attention.py:65
TINY_TOL = 1e-4         # tiny f32 capture, card vs CPU
# tiny decode logits through int8 caches, card vs CPU: a cache value ~1e-6
# from an int8 rounding edge may round the other way on the two devices,
# which moves it by its scale (1/127 of its row's max)
TINY_KV_INT8_TOL = 5e-3
# qmm bf16: one bf16 rounding of the output (2^-7 relative) plus room for
# the order of the f32 sum; f32: the sum's rounding is bounded by the sum
# of the magnitudes of its terms, |x| @ |q| * s
QMM_BF16_RTOL, QMM_BF16_ATOL_OF_MAX = 2.0 ** -7, 1e-3
QMM_F32_REL_TOL = 1e-5
QMM_F32_SHAPES = [(8, 256, 128), (130, 588, 384), (1, 33, 7)]
# (site, M, K, N, calls per int8 capture batch, calls per decode step)
QMM_SITES = [
    ("vit.patch_w", 16 * 1024, 588, 1664, 1, 0),
    ("vit.attn_qkv_w", 16 * 1024, 1664, 4992, 48, 0),
    ("vit.attn_proj_w", 16 * 1024, 1664, 1664, 48, 0),
    ("vit.mlp_fc_w", 16 * 1024, 1664, 8192, 48, 0),
    ("vit.mlp_proj_w", 16 * 1024, 8192, 1664, 48, 0),
    ("resampler.kv_proj_w", 16 * 1024, 1664, 4096, 1, 0),
    ("resampler.attn_q_w", 16 * 256, 4096, 4096, 1, 0),
    ("resampler.attn_k_w", 16 * 1024, 4096, 4096, 1, 0),
    ("resampler.attn_v_w", 16 * 1024, 4096, 4096, 1, 0),
    ("resampler.attn_out_w", 16 * 256, 4096, 4096, 1, 0),
    ("visual.proj", 16 * 256, 4096, 4096, 1, 0),
    ("decoder.attn_qkv_w", 16 * 320, 4096, 12288, 32, 0),
    ("decoder.attn_proj_w", 16 * 320, 4096, 4096, 32, 0),
    ("decoder.mlp_w1+w2", 16 * 320, 4096, 11008, 64, 0),
    ("decoder.mlp_proj_w", 16 * 320, 11008, 4096, 32, 0),
    ("decode.attn_qkv_w", 16, 4096, 12288, 0, 32),
    ("decode.attn_proj_w", 16, 4096, 4096, 0, 32),
    ("decode.mlp_w1+w2", 16, 4096, 11008, 0, 64),
    ("decode.mlp_proj_w", 16, 11008, 4096, 0, 32),
    ("decode.lm_head", 16, 4096, 151936, 0, 1),
]
QMM_PER_CAPTURE_BATCH, QMM_PER_DECODE_STEP = 359, 161
# int8 capture against the bf16 capture of the same weights: tdax's gate
# (tests/test_quantize.py:60)
INT8_MIN_COSINE = 0.98
# generate: cached logits against the uncached forward, relative to
# max|logit| (bf16: the decode step's reductions run at other shapes, and
# a one-ulp bf16 difference can grow through 32 random layers); kv_int8
# against bf16 caches as tests/test_generate.py:94
CACHE_TOL, KV_INT8_TOL = 3e-2, 5e-2
GEN_BATCH, GEN_PROMPT_LEN, GEN_NEW_TOKENS = 16, 320, 32
# sqdist: kernel and plain version are expansion forms summed in other
# orders (one f32 FMA chain per entry against a library product), so the
# bound is relative to the cancelled terms: 1e-5 * (|x_i|^2 + |x_j|^2).
SQDIST_REL_TOL = 1e-5
SQDIST_SHAPES = [(36, 3), (100, 17), (130, 257), (1001, 333)]  # + the scale path's
SCALE_N, SCALE_D, SCALE_DEGREE, SCALE_MAXDIM = 10_000, 4096, 40, 2
# the card's matrix (kernel) and the CPU's (plain version) are both
# expansion forms, so distances near 0.6 between points of norm ~11 may
# differ by ~1e-5 relative (tests/test_scale_ops.py:91-95 allows 1e-4)
SMALL_BOTTLENECK_TOL = 1e-4
# the sweep on the card against the same sweep on the CPU: eigh may
# return other signs (and another basis of a repeated eigenvalue) on the
# card, and the 500-epoch layout amplifies rounding.  A CPU run with
# flipped eigenvector signs moved silhouettes by 0.003 and max-H1 by
# 0.006; on an H100 the widest gaps are 0.0144 (silhouette, layer 25,
# whose graph has six components, so its init is any basis of a six-fold
# eigenvalue) and 0.0160 (max-H1, of a mean max-H1 of 0.41), the same
# in every run.  The limits leave under 2x room over those gaps.
SWEEP_SIL_TOL, SWEEP_H1_TOL = 0.02, 0.03
STATS_KEYS = ["layer", "n_h1_features", "max_h1_persistence", "all_h1_persistence_values",
              "n_h0_features", "max_h0_persistence", "silhouette_shape", "silhouette_color"]

# (name, B, Tq, Tk, nh, hd, causal, calls per batch on the main path)
MAIN_SHAPES = [
    ("decoder", 16, 320, 320, 32, 128, True, 32),
    ("vit", 16, 1024, 1024, 16, 104, False, 48),
    ("resampler", 16, 256, 1024, 32, 128, False, 1),
]
# the training step's attention: causal, with lse, 2 x 32 calls a step
# (forward and remat replay)
TRAIN_SHAPE = ("train", 4, 1024, 1024, 32, 128, True, 64)
# the decode step's attention: one query row over the 352-row cache
DECODE_SHAPE = ("decode", 16, 1, 352, 32, 128, False)
F32_SHAPES = [  # tests/test_flash_attention.py:37-50, batch 2, plus hd 104
    (40, 40, 2, 16, True), (40, 40, 2, 16, False), (8, 40, 2, 20, False),
    (130, 130, 1, 128, True), (16, 260, 1, 32, False), (64, 192, 2, 128, False),
    (256, 256, 2, 128, True), (1024, 1024, 1, 128, True), (128, 640, 2, 128, True),
    (70, 70, 2, 104, True),
]


# the flash backward: (name, B, Tq, Tk, nh, hd, causal, calls per training step)
BWD_SHAPES = [
    ("decoder", 4, 1024, 1024, 32, 128, True, 32),
    ("vit", 4, 1024, 1024, 16, 104, False, 0),
    ("resampler", 4, 256, 1024, 32, 128, False, 0),
    ("ragged", 3, 77, 131, 3, 40, True, 0),
]
# f32: the kernel and the plain version sum in other orders; the bound is
# relative to the magnitude of the summed terms (ds's size bound
# p (|dO|.|v| + |delta|) scale times |k| or |q|; p |dO| for dv).  bf16:
# 2^-7 |plain| + 1e-3 max|plain| for the output's rounding, plus 2^-8 of
# the summed terms' magnitude (|ds| |k|, |ds| |q|, p |dO|): each ds or p
# is rounded to bf16 before its product, and where the kernel's f32 value
# and the plain version's lie on two sides of a rounding edge the term
# moves by one bf16 step (2^-8 relative).  lse: 1e-5 relative to 1 + |lse|.
BWD_F32_REL_TOL = 1e-5
BWD_BF16_RTOL, BWD_BF16_ATOL_OF_MAX, BWD_BF16_TERMS = 2.0 ** -7, 1e-3, 2.0 ** -8
LSE_TOL = 1e-5
# flash_bwd_sm90.cu is held to the same bf16 bound: its p = 2^(s log2 e -
# lse log2 e) on the MUFU ex2 differs from flash_bwd.cu's expf by ~2^-22
# relative, far inside one bf16 step (2^-8) of the rounded p and ds
BWD_REPEATS = 5         # timed repeats of each backward: median and spread
# tiny f32 training, card against CPU: gradients within 1e-4 of each
# leaf's largest magnitude; params after three AdamW steps within 1e-4
# relative + 3e-5 (Adam divides by the root of the second moment, so a
# gradient rounding differently near zero moves its update more than its
# own error; tests/test_torch_train_step.py holds tdax to the same)
TINY_GRAD_TOL, TINY_PARAM_RTOL, TINY_PARAM_ATOL = 1e-4, 1e-4, 3e-5
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MASKED, TRAIN_TIMED_STEPS = 4, 1024, 128, 5
# the training phase's seven losses at --seed 0 through flash_bwd.cu (an
# H100 80GB HBM3 at 700 W); two runs of equal math but other kernels' sum
# orders (flash_fwd.cu and flash_fwd_sm90.cu) moved them by at most 0.016,
# bf16 noise.  A wrong gradient moves the descent far more.
TRAIN_REF_LOSSES_SEED0 = [12.400, 12.400, 11.078, 9.922, 8.478, 7.562, 6.211]
TRAIN_LOSS_TOL = 0.1


# the sources ptxas must compile without a spill and with setmaxnreg kept
SM90_SOURCES = ("flash_fwd_sm90", "flash_bwd_sm90")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def import_port():
    sys.path.insert(0, str(HERE))
    import tdax_torch
    where = Path(tdax_torch.__file__).resolve().parent
    if where != HERE / "tdax_torch":
        raise RuntimeError(f"tdax_torch imported from {where}, not from this checkout")
    return tdax_torch


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(b, tq, tk, nh, hd, causal, itemsize):
    """(ms, 'operations' | 'bytes'): the least time for one call."""
    flops = 4.0 * b * nh * tq * tk * hd / (2 if causal else 1)
    nbytes = (2 * b * tq + 2 * b * tk) * nh * hd * itemsize + 4 * b * tk  # q, o, k, v, bias
    peak = BF16_PEAK if itemsize == 2 else F32_PEAK
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def phase_env() -> dict:
    import concurrent.futures
    import importlib.util

    import torch
    smi = nvidia_smi()
    from tdax_torch.ops import _build
    from tdax_torch.ops.rips import native
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
        engine = pool.submit(lambda: (native.build(), time.perf_counter() - t0)[1])
        _build.build()
        build_s = time.perf_counter() - t0
        engine_s = engine.result()
    ptxas = []
    for log in sorted(_build.BUILD_DIR.glob("*.log")):
        ptxas += [ln.strip() for ln in log.read_text().splitlines()
                  if any(w in ln for w in ("registers", "spill", "C7508", "setmaxnreg"))]
    # the Hopper kernels: setmaxnreg ignored (C7508) or any spill is a fault
    sm90_regs = {}
    for name in SM90_SOURCES:
        sm90_log = (_build.BUILD_DIR / f"{name}.log").read_text()
        sm90_regs[name] = [ln.strip() for ln in sm90_log.splitlines()
                           if any(w in ln for w in ("registers", "spill", "C7508", "setmaxnreg"))]
        spills = [int(n) for n in re.findall(r"(\d+) bytes spill (?:stores|loads)", sm90_log)]
        if "C7508" in sm90_log or "setmaxnreg ignored" in sm90_log or any(spills):
            raise AssertionError(f"{_build.SOURCES[name]}: ptxas ignored setmaxnreg or "
                                 f"spilled:\n" + sm90_log[-4000:])
    info = {"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
            "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
            "build_s": round(build_s, 3), "built": sorted(_build.BUILD_SECONDS),
            "build_s_by_source": {n: round(t, 3) for n, t in _build.BUILD_SECONDS.items()},
            "engine_build_s": engine_s, "ptxas": ptxas, "ptxas_sm90": sm90_regs,
            "matplotlib": importlib.util.find_spec("matplotlib") is not None}
    emit(info)
    return info


def _case_inputs(gen, b, tq, tk, nh, hd, dtype, device, strided_kv: bool, strided_q: bool):
    """q/k/v as the model hands them over: views of a fused projection
    where the model splits one (ViT: q, k, v; decoder: v)."""
    import torch

    def fused(t, n):
        x = torch.randn((b, t, n * nh * hd), generator=gen, device=device, dtype=dtype)
        return [c.reshape(b, t, nh, hd) for c in x.split(nh * hd, dim=-1)]

    def plain(t):
        return torch.randn((b, t, nh, hd), generator=gen, device=device, dtype=dtype)

    if strided_q:
        q, k, v = fused(tq, 3)
    else:
        q = plain(tq)
        k, v = (fused(tk, 2) if strided_kv else (plain(tk), plain(tk)))
    return q, k, v


def _visible(valid, tq, tk, causal):
    import torch
    keyed = (valid > 0)[:, None, :].expand(valid.shape[0], tq, tk)
    if causal:
        keyed = keyed & torch.ones((tq, tk), dtype=torch.bool, device=valid.device).tril()
    return keyed.any(-1)  # [B, Tq]


def _check_case(fa, q, k, v, valid, causal, atol, rtol, label, kernel=None, with_lse=False):
    """One forward kernel (the routed one, or ``kernel="mma"``) against
    the plain version on the rows that see a key; with ``with_lse`` the
    lse on every row within LSE_TOL * (1 + |lse|).  Returns (bias,
    max |kernel - plain|, rows checked, rows, max |lse - plain lse|)."""
    import torch
    bias = torch.where(valid > 0, 0.0, fa.NEG_INF).to(torch.float32)
    got = fa.flash_attention(q, k, v, bias, causal, with_lse, _kernel=kernel)
    want = fa.flash_attention_plain(q, k, v, bias, causal, with_lse)
    torch.cuda.synchronize()
    lse_err = None
    if with_lse:
        (got, lse), (want, lse_want) = got, want
        lse_err = float((lse - lse_want).abs().max())
        if float(((lse - lse_want).abs() - LSE_TOL * (1 + lse_want.abs())).max()) > 0:
            raise AssertionError(f"{label}: lse differs from the plain version's by {lse_err:.3e}")
    if got.shape != want.shape or got.dtype != q.dtype:
        raise AssertionError(f"{label}: shape/dtype {tuple(got.shape)} {got.dtype}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{label}: non-finite kernel output")
    rows = _visible(valid, q.shape[1], k.shape[1], causal)
    g, w = got.float()[rows], want.float()[rows]
    err = (g - w).abs()
    max_abs = float(err.max())
    excess = float((err - (atol + rtol * w.abs())).max())
    if excess > 0:
        raise AssertionError(f"{label}: max |kernel - plain| = {max_abs:.3e} exceeds "
                             f"atol {atol} + rtol {rtol} * |plain|")
    return bias, max_abs, int(rows.sum()), int(rows.numel()), lse_err


def phase_kernels() -> dict:
    """Every kernel of the path against its plain version, on the card."""
    import torch
    import torch.nn.functional as F
    import tdax_torch.ops.flash_attention as fa
    from tdax_torch.runtime import get_device

    device = get_device()
    gen = torch.Generator(device=device).manual_seed(1234)
    sites, train = [], None
    for name, b, tq, tk, nh, hd, causal, calls in MAIN_SHAPES + [TRAIN_SHAPE]:
        with_lse = name == "train"
        q, k, v = _case_inputs(gen, b, tq, tk, nh, hd, torch.bfloat16, device,
                               strided_kv=name in ("decoder", "train"), strided_q=name == "vit")
        valid = torch.ones((b, tk), dtype=torch.int32, device=device)
        if name == "decoder":  # right-padded rows of different lengths, one full
            lengths = torch.randint(200, tk, (b,), generator=gen, device=device)
            lengths[0] = tk
            valid = (torch.arange(tk, device=device)[None] < lengths[:, None]).to(torch.int32)
        elif name == "train":  # the training batch's mask
            valid[-1, -TRAIN_MASKED:] = 0
        route = fa._route(q, k, v)
        if route != "sm90":
            raise AssertionError(f"bf16 {name}: routed to the {route} kernel, not sm90")
        err = {}
        for kernel in ("sm90", "mma"):
            before = (fa.LAUNCHES, fa.LAUNCHES_SM90)
            bias, err[kernel], n_rows, n_all, err[kernel + "_lse"] = _check_case(
                fa, q, k, v, valid, causal, BF16_ATOL, BF16_RTOL, f"bf16 {name} ({kernel})",
                kernel=None if kernel == "sm90" else "mma", with_lse=with_lse)
            moved = (fa.LAUNCHES - before[0], fa.LAUNCHES_SM90 - before[1])
            if moved != (1, int(kernel == "sm90")):
                raise AssertionError(f"bf16 {name} ({kernel}): launch counters moved {moved}")
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v, bias, causal, with_lse), iters=20)
        ms_mma = cuda_ms(lambda: fa.flash_attention(q, k, v, bias, causal, with_lse,
                                                    _kernel="mma"), iters=10)
        plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, bias, causal, with_lse),
                           iters=3)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        mask = None
        if name == "decoder":
            mask = (valid > 0)[:, None, None, :] & torch.ones(
                (tq, tk), dtype=torch.bool, device=device).tril()
        # the training shape: SDPA's forward with is_causal and no key mask,
        # as PR 4 timed it
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=name == "train"), iters=20)
        bound_ms, bound_by = bound(b, tq, tk, nh, hd, causal, 2)
        site = {"site": name, "shape": [b, tq, tk, nh, hd], "causal": causal,
                "dtype": "bfloat16", "route": route, "lse": with_lse,
                "max_abs_err": err["sm90"], "max_abs_err_mma": err["mma"],
                "lse_max_abs_err": err["sm90_lse"], "lse_max_abs_err_mma": err["mma_lse"],
                "rows_checked": n_rows, "rows": n_all, "ms": ms, "ms_mma": ms_mma,
                "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "share_of_bound": bound_ms / ms,
                "share_of_bound_mma": bound_ms / ms_mma,
                ("calls_per_train_step" if with_lse else "calls_per_batch"): calls}
        emit({"phase": "kernel_case", **site})
        if with_lse:
            train = site
        else:
            sites.append(site)
        del q, k, v, qt, kt, vt, mask
        torch.cuda.empty_cache()

    # the decode step: q of one row, k/v the layer's cache, valid keys up
    # to each sample's own position (one sample at the cache's last row)
    name, b, tq, tk, nh, hd, causal = DECODE_SHAPE
    q, k, v = _case_inputs(gen, b, tq, tk, nh, hd, torch.bfloat16, device, False, False)
    cur = torch.randint(200, tk, (b,), generator=gen, device=device)
    cur[0] = tk - 1
    valid = (torch.arange(tk, device=device)[None] <= cur[:, None]).to(torch.int32)
    if fa._route(q, k, v) != "mma":
        raise AssertionError("the decode step is not routed to the mma kernel")
    bias, max_abs, _, _, _ = _check_case(fa, q, k, v, valid, causal, BF16_ATOL, BF16_RTOL,
                                         "bf16 decode")
    mask = (valid > 0)[:, None, None, :]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    decode = {"site": name, "shape": [b, tq, tk, nh, hd], "causal": causal, "dtype": "bfloat16",
              "calls_per_decode_step": 32, "max_abs_err": max_abs,
              "ms": cuda_ms(lambda: fa.flash_attention(q, k, v, bias, causal), iters=50),
              "plain_ms": cuda_ms(lambda: fa.flash_attention_plain(q, k, v, bias, causal),
                                  iters=20),
              "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                           attn_mask=mask),
                                    iters=50)}
    decode["bound_ms"], decode["bound_by"] = bound(b, tq, tk, nh, hd, causal, 2)
    emit({"phase": "kernel_case", **decode})
    del q, k, v, qt, kt, vt, mask

    f32_errs = []
    for tq, tk, nh, hd, causal in F32_SHAPES:
        b = 2
        q, k, v = _case_inputs(gen, b, tq, tk, nh, hd, torch.float32, device,
                               strided_kv=False, strided_q=False)
        valid = torch.ones((b, tk), dtype=torch.int32, device=device)
        valid[0, tk - 7:] = 0
        _, max_abs, _, _, _ = _check_case(fa, q, k, v, valid, causal, F32_TOL, F32_TOL,
                                          f"f32 {(tq, tk, nh, hd, causal)}")
        f32_errs.append(max_abs)
    emit({"phase": "kernel_f32", "shapes": F32_SHAPES, "max_abs_err": f32_errs,
          "tolerance": F32_TOL})

    # all-masked rows: the output must be finite and lse 0 (both kernels)
    q, k, v = _case_inputs(gen, 2, 64, 64, 2, 32, torch.bfloat16, device, False, False)
    for kernel in (None, "mma"):
        out, lse = fa.flash_attention(q, k, v, torch.full((2, 64), fa.NEG_INF, device=device),
                                      True, True, _kernel=kernel)
        torch.cuda.synchronize()
        if not torch.isfinite(out).all() or not (lse == 0).all():
            raise AssertionError(f"fully masked rows ({kernel or 'sm90'}): non-finite output "
                                 "or lse not 0")
    return {"sites": sites, "train": train, "decode": decode, "f32_max_abs_err": max(f32_errs)}


def qmm_bound(m, k, n, x_bytes):
    """(ms, 'operations' | 'bytes'): 2MNK tensor-core flops; x, q, s read
    once and the output written once."""
    t_ops = 2.0 * m * n * k / BF16_PEAK
    t_bytes = (m * k * x_bytes + k * n + 4 * n + m * n * x_bytes) / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _qmm_check(qm, x, w, label) -> float:
    """The kernel against the plain version; max |kernel - plain|."""
    import torch
    got = qm.quant_matmul(x, w["q"], w["s"])
    want = qm.quant_matmul_plain(x, w["q"], w["s"])
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != x.dtype:
        raise AssertionError(f"qmm {label}: shape/dtype {tuple(got.shape)} {got.dtype}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"qmm {label}: non-finite kernel output")
    err = (got.float() - want.float()).abs_()
    if x.dtype == torch.bfloat16:
        ref = want.float().abs_()
        limit = ref.mul_(QMM_BF16_RTOL).add_(QMM_BF16_ATOL_OF_MAX * float(ref.max()))
    else:
        limit = (x.abs() @ w["q"].float().abs()) * w["s"] * QMM_F32_REL_TOL
    excess = float((err - limit).max())
    max_abs = float(err.max())
    if excess > 0:
        raise AssertionError(f"qmm {label}: max |kernel - plain| = {max_abs:.3e} is outside "
                             f"the tolerance by {excess:.3e}")
    return max_abs


def phase_qmm() -> dict:
    """The int8 matmul kernel against its plain version at every site of
    the int8 capture and of a decode step, on the card."""
    import torch
    from tdax_torch.models.qwen_vl.quantize import quantize_weight
    from tdax_torch.ops import quant_matmul as qm
    from tdax_torch.runtime import get_device

    device = get_device()
    gen = torch.Generator(device=device).manual_seed(2468)
    f32_errs = []
    for m, k, n in QMM_F32_SHAPES:
        x = torch.randn((m, k), generator=gen, device=device)
        w = quantize_weight(torch.randn((k, n), generator=gen, device=device) / math.sqrt(k))
        f32_errs.append(_qmm_check(qm, x, w, f"f32 {(m, k, n)}"))
    emit({"phase": "kernel_qmm_f32", "shapes": QMM_F32_SHAPES, "max_abs_err": f32_errs,
          "tolerance": f"{QMM_F32_REL_TOL} * (|x| @ |q| * s)"})

    sites = []
    for name, m, k, n, per_batch, per_step in QMM_SITES:
        x = torch.randn((m, k), generator=gen, device=device, dtype=torch.bfloat16)
        w = quantize_weight(torch.randn((k, n), generator=gen, device=device) / math.sqrt(k))
        max_abs = _qmm_check(qm, x, w, name)
        dense = (w["q"].float() * w["s"]).to(torch.bfloat16)  # the library's operand
        iters = 50 if m <= 64 else 10
        site = {"site": name, "shape": [m, k, n], "dtype": "bfloat16",
                "calls_per_capture_batch": per_batch, "calls_per_decode_step": per_step,
                "max_abs_err": max_abs,
                "ms": cuda_ms(lambda: qm.quant_matmul(x, w["q"], w["s"]), iters=iters),
                "plain_ms": cuda_ms(lambda: qm.quant_matmul_plain(x, w["q"], w["s"]), iters=3),
                "library_ms": cuda_ms(lambda: torch.matmul(x, dense), iters=iters)}
        site["bound_ms"], site["bound_by"] = qmm_bound(m, k, n, 2)
        site["achieved_tflops"] = 2.0 * m * n * k / (site["ms"] * 1e-3) / 1e12
        site["achieved_weight_gb_per_s"] = k * n / (site["ms"] * 1e-3) / 1e9
        emit({"phase": "kernel_case", "kernel": "qmm", **site})
        sites.append(site)
        del x, w, dense
        torch.cuda.empty_cache()
    return {"sites": sites, "max_abs_err": max(max(s["max_abs_err"] for s in sites), *f32_errs)}


def scale_cloud():
    """bench_scale.py:36-40: n points on a 3-sphere embedded in 4096-d
    (seed 42), and the generator, which then picks the threshold's rows."""
    import numpy as np
    rng = np.random.default_rng(42)
    z = rng.normal(size=(SCALE_N, 4))
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    proj = rng.normal(size=(4, SCALE_D)) / np.sqrt(4)
    x = (z @ proj + rng.normal(0, 1e-3, (SCALE_N, SCALE_D))).astype(np.float32)
    return x, rng


def sqdist_bound(n, d):
    """(ms, 'operations' | 'bytes'): 2 n^2 d f32 FMA flops; x read once,
    the [n, n] output written once."""
    t_ops = 2.0 * n * n * d / F32_PEAK
    t_bytes = (4.0 * n * d + 4.0 * n * n) / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _sqdist_check(sqdist, x, label):
    import torch
    got = sqdist.sqdist(x)
    want = sqdist.pairwise_sq_euclidean_plain(x)
    torch.cuda.synchronize()
    sq = (x.double() ** 2).sum(1)
    err = (got.double() - want.double()).abs()
    ratio = float((err / (sq[:, None] + sq[None, :]).clamp_min(1e-30)).max())
    max_abs = float(err.max())
    del err
    if got.shape != want.shape or got.dtype != torch.float32:
        raise AssertionError(f"sqdist {label}: shape/dtype {tuple(got.shape)} {got.dtype}")
    if not torch.isfinite(got).all() or not (got >= 0).all():
        raise AssertionError(f"sqdist {label}: non-finite or negative output")
    if ratio > SQDIST_REL_TOL:
        raise AssertionError(f"sqdist {label}: |kernel - plain| / (|x_i|^2 + |x_j|^2) = "
                             f"{ratio:.3e} exceeds {SQDIST_REL_TOL}")
    if not torch.equal(got, got.T):
        raise AssertionError(f"sqdist {label}: output is not exactly symmetric")
    return max_abs, ratio


def phase_sqdist() -> dict:
    """The sqdist kernel against its plain version, on the card."""
    import torch
    import tdax_torch.ops.sqdist as sqdist
    from tdax_torch.runtime import get_device

    device = get_device()
    gen = torch.Generator(device=device).manual_seed(4321)
    cases = []
    for n, d in SQDIST_SHAPES:
        x = torch.randn((n, d), generator=gen, device=device)
        max_abs, ratio = _sqdist_check(sqdist, x, f"{(n, d)}")
        cases.append({"shape": [n, d], "max_abs_err": max_abs, "max_err_over_scale": ratio})
    emit({"phase": "kernel_sqdist_cases", "cases": cases, "tolerance": SQDIST_REL_TOL})

    x_np, _ = scale_cloud()
    x = torch.as_tensor(x_np, device=device)
    max_abs, ratio = _sqdist_check(sqdist, x, "scale path")
    ms = cuda_ms(lambda: sqdist.sqdist(x), iters=10)
    plain_ms = cuda_ms(lambda: sqdist.pairwise_sq_euclidean_plain(x), iters=5)
    euclid_ms = cuda_ms(lambda: sqdist.euclidean(x), iters=10)
    library_ms = cuda_ms(lambda: torch.cdist(x, x, compute_mode="use_mm_for_euclid_dist"),
                         iters=10)
    bound_ms, bound_by = sqdist_bound(SCALE_N, SCALE_D)
    site = {"site": "scale", "shape": [SCALE_N, SCALE_D], "dtype": "float32",
            "max_abs_err": max_abs, "max_err_over_scale": ratio, "ms": ms,
            "plain_ms": plain_ms, "euclid_ms": euclid_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "achieved_tflops": 2.0 * SCALE_N * SCALE_N * SCALE_D / (ms * 1e-3) / 1e12}
    emit({"phase": "kernel_case", **site})
    torch.cuda.empty_cache()
    return {"site": site, "max_abs_err": max(max_abs, *(c["max_abs_err"] for c in cases))}


def make_clouds(seed: int = 42):
    """bench.py:31-43: 32 x 36 x 4096 synthetic activation clouds with
    shape-clustered structure at layer 25, and their labels."""
    import numpy as np
    rng = np.random.default_rng(seed)
    shapes = [f"s{i}" for i in range(6)]
    colors = [f"c{i}" for i in range(6)]
    shape_labels = [shapes[i // 6] for i in range(36)]
    color_labels = [colors[i % 6] for i in range(36)]
    clouds = rng.normal(size=(32, 36, 4096))
    centers = rng.normal(size=(6, 4096)) * 3
    for j in range(36):
        clouds[25, j] = centers[j // 6] + rng.normal(0, 0.5, 4096)
    return clouds, shape_labels, color_labels


def profile_device(fn) -> dict:
    """Wall time of fn() (synchronised host clock) and, from one more run
    under torch.profiler, the device's busy time, kernel count and idle
    share; the device time by kind (qmm, flash, GEMMs, other) and the top
    kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n_kernels = sum(ev.count for ev in prof.key_averages()
                    if ev.device_type == torch.autograd.DeviceType.CUDA)
    kinds = _device_time_by_kind(prof)
    busy_ms = kinds.pop("busy_ms")
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms if busy_ms > 0 else "not measured",
            "device_ops": n_kernels,
            "idle_share": (1 - busy_ms / wall_ms) if busy_ms > 0 else "not measured", **kinds}


def synthetic_capture(root: Path):
    """make_clouds() in the capture's nested-dict schema, with a
    metadata.json beside it, so that run_tda_sweep reads it as it reads
    a capture (sample ids sort in the clouds' order)."""
    clouds, shape_labels, color_labels = make_clouds()
    metadata = [{"id": f"synthetic_{j:02d}", "type": "bound", "shape": s, "color": c}
                for j, (s, c) in enumerate(zip(shape_labels, color_labels))]
    root.mkdir(parents=True, exist_ok=True)
    (root / "metadata.json").write_text(json.dumps(metadata))
    all_data = {m["id"]: {"metadata": m, "activations": {f"layer_{i}": clouds[i, j]
                                                         for i in range(clouds.shape[0])}}
                for j, m in enumerate(metadata)}
    labels = {"shape": shape_labels, "color": color_labels}
    return all_data, str(root / "metadata.json"), clouds, labels


def _check_stats(stats, n_layers, label):
    import numpy as np
    if len(stats) != n_layers:
        raise AssertionError(f"{label}: {len(stats)} stats entries, expected {n_layers}")
    for s in stats:
        if list(s) != STATS_KEYS:
            raise AssertionError(f"{label}: stats keys {list(s)} are not tdax's {STATS_KEYS}")
        values = [v for k, v in s.items() if k != "all_h1_persistence_values"]
        values += s["all_h1_persistence_values"]
        if not np.isfinite(np.asarray(values, dtype=np.float64)).all():
            raise AssertionError(f"{label}: non-finite stats at layer {s['layer']}")


def _check_sweep(result, n_layers, label):
    import numpy as np
    _check_stats(result["stats"], n_layers, label)
    if not np.isfinite(result["clouds_3d"]).all():
        raise AssertionError(f"{label}: non-finite embedding")


def phase_sweep(tmp: Path, smi: str) -> dict:
    """The port's run_tda_sweep on its own capture, then on bench.py's
    synthetic clouds on the card and on the CPU."""
    import importlib.util

    from tdax_torch.config import SweepConfig
    from tdax_torch.data.io import load_activations
    from tdax_torch.pipeline.tda_sweep import embed_and_silhouettes, peak, run_tda_sweep

    rendered = importlib.util.find_spec("matplotlib") is not None
    if not rendered:
        print("chip_smoke: matplotlib is not installed on this machine: the sweep ran with "
              "save_diagrams off, so its PNGs were not rendered on the card", flush=True)
    data_dir = tmp / "data"
    t0 = time.perf_counter()
    all_data = load_activations(str(data_dir / "all_activations.npz"))
    load_s = time.perf_counter() - t0
    out_dir = tmp / "tda_debug_output"
    cfg = SweepConfig(output_dir=str(out_dir), save_diagrams=rendered)
    t0 = time.perf_counter()
    result = run_tda_sweep(all_data, str(data_dir / "metadata.json"), cfg, verbose=False)
    sweep_s = time.perf_counter() - t0
    stats, peak_layer = result["stats"], result["peak_layer"]
    _check_sweep(result, 32, "capture sweep")
    if rendered:
        n_png = len(list((out_dir / "diagrams").glob("*.png")))
        if n_png != 32 or not (out_dir / "summary_evolution_plot.png").exists():
            raise AssertionError(f"sweep wrote {n_png} diagram PNGs and no evolution plot")
    written = json.loads((out_dir / "summary_stats.json").read_text())
    if not 0 <= peak_layer < 32 or written != stats:
        raise AssertionError(f"capture sweep: peak layer {peak_layer} / summary_stats.json "
                             f"differs from the returned stats")
    info = {"phase": "sweep", "nvidia_smi": smi, "clouds": [32, 36, 4096],
            "load_s": load_s, "sweep_s": sweep_s, "png_rendered": rendered,
            "peak_layer": peak_layer, "peak_rule": cfg.peak_rule,
            "peak_silhouette_shape": stats[peak_layer]["silhouette_shape"],
            "timings": result["timings"]}

    # bench.py's synthetic clouds: the card twice (first and steady state),
    # then the CPU
    all_data, meta_path, clouds, labels = synthetic_capture(tmp / "synthetic")
    runs = {}
    for dev, repeats in (("cuda", 2), ("cpu", 1)):
        for _ in range(repeats):
            res = run_tda_sweep(all_data, meta_path,
                                SweepConfig(output_dir=str(tmp / f"synthetic_{dev}"),
                                            save_diagrams=False),
                                verbose=False, device=dev)
            _check_sweep(res, 32, f"synthetic sweep on {dev}")
            runs.setdefault(dev, []).append(res)
    card, cpu = runs["cuda"][0]["stats"], runs["cpu"][0]["stats"]
    info["synthetic_embed_profile"] = profile_device(
        lambda: embed_and_silhouettes(clouds, SweepConfig(), labels))
    peaks = {dev: peak(r[0]["stats"], "shape_silhouette") for dev, r in runs.items()}
    sil_err = max(abs(a[k] - b[k]) for a, b in zip(card, cpu)
                  for k in ("silhouette_shape", "silhouette_color"))
    h1_err = max(abs(a["max_h1_persistence"] - b["max_h1_persistence"])
                 for a, b in zip(card, cpu))
    info.update({"synthetic_peak_card": peaks["cuda"], "synthetic_peak_cpu": peaks["cpu"],
                 "synthetic_peak_silhouette": card[25]["silhouette_shape"],
                 "card_vs_cpu_max_silhouette_diff": sil_err,
                 "card_vs_cpu_max_h1_diff": h1_err,
                 "tolerances": [SWEEP_SIL_TOL, SWEEP_H1_TOL],
                 "synthetic_card_first": runs["cuda"][0]["timings"],
                 "synthetic_card_again": runs["cuda"][1]["timings"],
                 "synthetic_cpu": runs["cpu"][0]["timings"],
                 "mean_max_h1": [sum(s["max_h1_persistence"] for s in st) / len(st)
                                 for st in (card, cpu)]})
    emit(info)
    if peaks["cuda"] != 25 or peaks["cpu"] != 25:
        raise AssertionError(f"synthetic sweep: shape-silhouette peak {peaks}, expected 25")
    if sil_err > SWEEP_SIL_TOL or h1_err > SWEEP_H1_TOL:
        raise AssertionError(f"synthetic sweep: card vs CPU silhouettes {sil_err:.4f} "
                             f"(limit {SWEEP_SIL_TOL}), max H1 {h1_err:.4f} "
                             f"(limit {SWEEP_H1_TOL})")
    return info


def phase_scale(smi: str) -> dict:
    """rips_at_scale at 10000 x 4096 on the card, and a small cloud against the CPU."""
    import numpy as np
    import torch
    import tdax_torch.ops.sqdist as sqdist
    from tdax_torch.metrics.persistence import bottleneck_distance
    from tdax_torch.ops.rips import rips_from_distances
    from tdax_torch.pipeline.scale import distance_matrix, rips_at_scale

    x_np, rng = scale_cloud()
    t0 = time.perf_counter()
    x = torch.as_tensor(x_np).to("cuda")
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0

    # the threshold as bench_scale.py:132-135 picks it: the median over 512
    # rows of each row's 40th-smallest distance (rounded to f32, the
    # precision both Boruvka and the f32 engine compare in)
    t0 = time.perf_counter()
    host = distance_matrix(x).cpu().numpy()
    sample = rng.choice(SCALE_N, size=min(512, SCALE_N), replace=False)
    kth = np.partition(host[sample], SCALE_DEGREE, axis=1)[:, SCALE_DEGREE]
    thresh = float(np.float32(np.median(kth)))
    thresh_s = time.perf_counter() - t0

    sqdist.LAUNCHES = 0
    t0 = time.perf_counter()
    out = rips_at_scale(x, maxdim=SCALE_MAXDIM, thresh=thresh)
    wall_s = time.perf_counter() - t0
    launches = sqdist.LAUNCHES
    if launches != 1:
        raise AssertionError(f"rips_at_scale launched the sqdist kernel {launches} times, "
                             f"expected 1")

    profile = profile_device(lambda: rips_at_scale(x, maxdim=SCALE_MAXDIM, thresh=thresh))

    # Boruvka's H0 against the engine's dim-0 bars on the same matrix
    engine0 = rips_from_distances(host, maxdim=0, thresh=thresh)["dgms"][0]
    mst0 = out["dgms"][0]
    same = (np.array_equal(np.sort(mst0[np.isfinite(mst0[:, 1]), 1]),
                           np.sort(engine0[np.isfinite(engine0[:, 1]), 1]))
            and np.isinf(mst0[:, 1]).sum() == np.isinf(engine0[:, 1]).sum())
    if not same:
        raise AssertionError("Boruvka H0 differs from the engine's dim-0 bars")
    bars = [int(len(g)) for g in out["dgms"]]
    if len(bars) != SCALE_MAXDIM + 1 or not all(np.isfinite(g[:, 0]).all() for g in out["dgms"]):
        raise AssertionError(f"rips_at_scale: diagrams {bars}")

    # a small cloud: the card's diagrams against the CPU's
    small_rng = np.random.default_rng(5)  # tests/test_scale_ops.py:78-95
    small = np.concatenate([small_rng.normal(0, 0.5, (30, 8)),
                            small_rng.normal(4, 0.5, (30, 8))]).astype(np.float32)
    card = rips_at_scale(torch.as_tensor(small).to("cuda"), maxdim=1, thresh=2.5)["dgms"]
    cpu = rips_at_scale(small, maxdim=1, thresh=2.5, device="cpu")["dgms"]
    small_bn = [bottleneck_distance(a, b) for a, b in zip(card, cpu)]
    info = {"phase": "scale", "nvidia_smi": smi, "n": SCALE_N, "dim": SCALE_D,
            "maxdim": SCALE_MAXDIM, "target_degree": SCALE_DEGREE, "thresh": thresh,
            "sqdist_launches": launches, "bars": bars, "h0_equals_engine": True,
            "upload_s": upload_s, "thresh_select_s": thresh_s, "rips_at_scale_s": wall_s,
            "timings": out["timings"], "profile": profile,
            "small_cloud_bottleneck_card_vs_cpu": small_bn}
    emit(info)
    if max(small_bn) > SMALL_BOTTLENECK_TOL:
        raise AssertionError(f"small cloud: card vs CPU bottleneck {small_bn}")
    return info


def phase_tiny_parity(tmp: Path) -> dict:
    """A tiny f32 model's capture: the card (kernels) against the CPU
    (plain attention), same parameters, same samples."""
    import numpy as np
    from tdax_torch.config import DatasetConfig, ExtractConfig
    from tdax_torch.data.dataset import generate_dataset
    from tdax_torch.models.qwen_vl.config import QwenVLConfig
    from tdax_torch.models.qwen_vl.model import init_params
    from tdax_torch.pipeline.extract import extract_activations

    cfg = QwenVLConfig.tiny(dtype="float32")
    metadata = generate_dataset(DatasetConfig(data_dir=str(tmp / "tiny_data")))
    cpu_params = init_params(cfg, "cpu", seed=7)

    card_params = _to_card(cpu_params)
    ecfg = ExtractConfig(batch_size=16)
    runs = {}
    for dev, params in (("cpu", cpu_params), ("cuda", card_params)):
        res = extract_activations(metadata, str(tmp / f"tiny_{dev}.pt"), cfg, ecfg,
                                  params=params, device=dev, verbose=False)
        runs[dev] = np.stack([np.stack([res[m["id"]]["activations"][f"layer_{i}"]
                                        for m in metadata]) for i in range(cfg.num_layers)])
    err = float(np.abs(runs["cuda"] - runs["cpu"]).max())
    scale = float(np.abs(runs["cpu"]).max())
    info = {"phase": "tiny_parity", "shape": list(runs["cuda"].shape), "max_abs_err": err,
            "max_abs_value": scale, "tolerance": TINY_TOL}
    emit(info)
    if not np.isfinite(runs["cuda"]).all() or err > TINY_TOL * max(1.0, scale):
        raise AssertionError(f"tiny capture: card vs CPU max abs err {err:.3e}")
    return info


def _to_card(tree):
    return {name: _to_card(leaf) if isinstance(leaf, dict) else leaf.to("cuda")
            for name, leaf in tree.items()}


def phase_tiny_int8(tmp: Path) -> dict:
    """A tiny f32 model's int8 tree: the int8 capture and generate on the
    card (kernels) against the same on the CPU (plain versions)."""
    import numpy as np
    import torch
    from tdax_torch.config import DatasetConfig, ExtractConfig
    from tdax_torch.data.dataset import generate_dataset
    from tdax_torch.models.qwen_vl.config import QwenVLConfig
    from tdax_torch.models.qwen_vl.generate import _decode_step, generate, prefill
    from tdax_torch.models.qwen_vl.model import init_params
    from tdax_torch.models.qwen_vl.preprocess import load_image_batch
    from tdax_torch.models.qwen_vl.quantize import quantize_params
    from tdax_torch.models.qwen_vl.tokenizer import ToyTokenizer, batch_encode
    from tdax_torch.pipeline.extract import extract_activations

    cfg = QwenVLConfig.tiny(dtype="float32")
    metadata = generate_dataset(DatasetConfig(data_dir=str(tmp / "tiny_int8_data")))
    cpu_params = quantize_params(init_params(cfg, "cpu", seed=7))
    params = {"cpu": cpu_params, "cuda": _to_card(cpu_params)}
    ecfg = ExtractConfig(batch_size=16, quantize_int8=True)
    enc = batch_encode(ToyTokenizer(cfg), metadata[:6], cfg)
    images = load_image_batch(enc["image_paths"], cfg.visual.image_size)
    acts, logits, toks = {}, {}, {}
    for dev in ("cpu", "cuda"):
        res = extract_activations(metadata, str(tmp / f"tiny_int8_{dev}.pt"), cfg, ecfg,
                                  params=params[dev], device=dev, verbose=False)
        acts[dev] = np.stack([np.stack([res[m["id"]]["activations"][f"layer_{i}"]
                                        for m in metadata]) for i in range(cfg.num_layers)])
        batch = {"input_ids": torch.as_tensor(enc["input_ids"], device=dev).long(),
                 "attn_mask": torch.as_tensor(enc["attn_mask"], device=dev),
                 "images": torch.as_tensor(images, device=dev),
                 "image_positions": torch.as_tensor(enc["image_positions"], device=dev).long()}
        lengths = batch["attn_mask"].sum(1).long()
        for kv_int8 in (False, True):
            with torch.inference_mode():
                _, ks, vs = prefill(params[dev], cfg, t_max=enc["input_ids"].shape[1] + 8,
                                    kv_int8=kv_int8, **batch)
                step, _, _ = _decode_step(params[dev], cfg, batch["input_ids"][:, 0], lengths,
                                          ks, vs)
            logits[dev, kv_int8] = step.cpu().numpy()
            toks[dev, kv_int8] = generate(params[dev], cfg, max_new_tokens=8, kv_int8=kv_int8,
                                          **batch).cpu().numpy()
    err = float(np.abs(acts["cuda"] - acts["cpu"]).max())
    scale = float(np.abs(acts["cpu"]).max())
    logit_err = {str(k): float(np.abs(logits["cuda", k] - logits["cpu", k]).max())
                 for k in (False, True)}
    logit_scale = max(float(np.abs(v).max()) for v in logits.values())
    same = {str(k): bool(np.array_equal(toks["cuda", k], toks["cpu", k])) for k in (False, True)}
    info = {"phase": "tiny_int8_parity", "capture_shape": list(acts["cuda"].shape),
            "capture_max_abs_err": err, "capture_max_abs_value": scale,
            "decode_logits_max_abs_err_by_kv_int8": logit_err, "logits_max_abs": logit_scale,
            "greedy_tokens_identical_by_kv_int8": same, "tokens": toks["cuda", False].tolist(),
            "tolerance": TINY_TOL, "kv_int8_logits_tolerance": TINY_KV_INT8_TOL}
    emit(info)
    if not np.isfinite(acts["cuda"]).all() or err > TINY_TOL * max(1.0, scale):
        raise AssertionError(f"tiny int8 capture: card vs CPU max abs err {err:.3e}")
    if (logit_err["False"] > TINY_TOL * max(1.0, logit_scale)
            or logit_err["True"] > TINY_KV_INT8_TOL * max(1.0, logit_scale)):
        raise AssertionError(f"tiny int8 decode logits: card vs CPU {logit_err}")
    if not all(same.values()):
        raise AssertionError(f"tiny int8 generate: card and CPU tokens differ {same}")
    return info


def phase_capture(tmp: Path, smi: str):
    """The port's main path at full width and depth; returns its record
    and the state the int8 and generate phases reuse (the bf16 params,
    the capture, the dataset and its encoding)."""
    import torch
    import tdax_torch.ops.flash_attention as fa
    import tdax_torch.ops.quant_matmul as qm
    from tdax_torch.config import DatasetConfig, ExtractConfig
    from tdax_torch.data.dataset import generate_dataset
    from tdax_torch.data.io import save_activations, save_activations_npz
    from tdax_torch.models.qwen_vl.config import QwenVLConfig
    from tdax_torch.models.qwen_vl.model import init_params
    from tdax_torch.models.qwen_vl.preprocess import load_image_batch
    from tdax_torch.models.qwen_vl.tokenizer import ToyTokenizer, batch_encode
    from tdax_torch.pipeline.extract import extract_activations

    cfg = QwenVLConfig()
    ds = DatasetConfig(data_dir=str(tmp / "data"))
    metadata = generate_dataset(ds)
    if len(metadata) != 48:
        raise AssertionError(f"dataset has {len(metadata)} samples, expected 48")

    t0 = time.perf_counter()
    params = init_params(cfg, "cuda", seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = 0
    stack = [params]
    while stack:
        for leaf in stack.pop().values():
            if isinstance(leaf, dict):
                stack.append(leaf)
            else:
                n_params += leaf.numel()

    ecfg = ExtractConfig(batch_size=16)
    out_path = str(tmp / "data" / "all_activations.pt")
    torch.cuda.reset_peak_memory_stats()
    fa.LAUNCHES = fa.LAUNCHES_SM90 = qm.LAUNCHES = 0
    t0 = time.perf_counter()
    results = extract_activations(metadata, out_path, cfg, ecfg, params=params,
                                  device="cuda", verbose=False)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches, sm90_launches, qmm_launches = fa.LAUNCHES, fa.LAUNCHES_SM90, qm.LAUNCHES
    peak = torch.cuda.max_memory_allocated()

    acts, ids = _check_capture(out_path, metadata, results, "bf16 capture")
    n_batches = math.ceil(len(metadata) / ecfg.batch_size)
    expected = n_batches * (cfg.visual.layers + 1 + cfg.num_layers)
    if launches != expected or sm90_launches != expected or qmm_launches != 0:
        raise AssertionError(f"flash kernels launched {launches} times ({sm90_launches} sm90), "
                             f"expected {expected}, all sm90; qmm {qmm_launches} times, "
                             "expected 0 (fp weights)")

    # the same run again, warm: the difference is first-call set-up
    t0 = time.perf_counter()
    extract_activations(metadata, str(tmp / "data" / "again.pt"), cfg, ecfg, params=params,
                        device="cuda", verbose=False)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    # the host stages of the capture, each alone on the same data
    host = {}
    t0 = time.perf_counter()
    encoded = batch_encode(ToyTokenizer(cfg), metadata, cfg)
    host["tokenize_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    load_image_batch(encoded["image_paths"], cfg.visual.image_size)
    host["images_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    save_activations_npz(str(tmp / "host.npz"), acts, ids, metadata)
    host["npz_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    save_activations(str(tmp / "host.pt"), acts, ids, metadata)
    host["pt_s"] = time.perf_counter() - t0
    max_len = math.ceil((encoded["input_ids"].shape[1] + 1) / 64) * 64
    tokens = n_batches * ecfg.batch_size * (max_len + cfg.visual.n_patches)
    info = {"phase": "capture", "nvidia_smi": smi, "params": n_params,
            "param_dtype": cfg.dtype, "init_s": init_s, "capture_shape": list(acts.shape),
            "finite": True, "flash_launches": launches, "flash_launches_sm90": sm90_launches,
            "expected_launches": expected,
            "qmm_launches": qmm_launches,
            "wall_s": wall_s, "max_len": max_len, "tokens": tokens, "tokens_per_s": tokens / wall_s,
            "wall_warm_s": warm_s, "tokens_per_s_warm": tokens / warm_s, "host": host,
            "max_memory_allocated_bytes": peak, "image_path": "PIL"}
    emit(info)
    info["profile"] = phase_profile(params, cfg, encoded, max_len, ecfg.batch_size, smi, "bf16")
    state = {"params": params, "acts": acts, "metadata": metadata, "encoded": encoded,
             "max_len": max_len}
    return info, state


def _check_capture(out_path: str, metadata, results, label):
    """The capture's files in tdax's schemas: [32, 48, 4096], finite, .npz
    ids and metadata, .pt entries equal to the .npz."""
    import numpy as np
    import torch
    from tdax_torch.data.io import load_activations_npz

    acts, ids, meta = load_activations_npz(out_path.rsplit(".", 1)[0] + ".npz")
    if acts.shape != (32, 48, 4096):
        raise AssertionError(f"{label}: shape {acts.shape}, expected (32, 48, 4096)")
    if not np.isfinite(acts).all():
        raise AssertionError(f"{label}: non-finite values")
    if ids != [m["id"] for m in metadata] or meta != metadata:
        raise AssertionError(f"{label}: .npz sample_ids / metadata_json do not match the dataset")
    pt = torch.load(out_path, map_location="cpu", weights_only=False)
    if list(pt) != ids:
        raise AssertionError(f"{label}: .pt keys do not match the sample ids")
    for j, sid in enumerate(ids):
        entry = pt[sid]
        if entry["metadata"] != metadata[j] or list(entry["activations"]) != [
                f"layer_{i}" for i in range(32)]:
            raise AssertionError(f"{label}: .pt entry {sid} does not have the tdax schema")
        if not np.array_equal(entry["activations"]["layer_31"].numpy(), acts[31, j]):
            raise AssertionError(f"{label}: .pt and .npz disagree for {sid}")
    if set(results) != set(ids):
        raise AssertionError(f"{label}: returned results do not cover the dataset")
    if np.abs(acts[:, 0] - acts[:, 1]).max() == 0:
        raise AssertionError(f"{label}: two different samples gave identical activations")
    return acts, ids


def _device_time_by_kind(prof) -> dict:
    """Device time (ms) of a profiled run, summed by kind, and the top
    kernels."""
    import torch
    kinds = {"qmm": 0.0, "flash": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0,
             "gemm": 0.0, "other": 0.0}
    top = []
    for ev in prof.key_averages():
        # a record_function range (torch.optim's "Optimizer.step#...") shows
        # as a device event spanning its kernels: not a kernel of its own
        if (ev.device_type != torch.autograd.DeviceType.CUDA
                or getattr(ev, "is_user_annotation", False)
                or ev.key.startswith("Optimizer.")):
            continue
        us = getattr(ev, "self_device_time_total", 0.0)
        name = ev.key.lower()
        kind = ("qmm" if "qmm_" in name else
                "flash" if "flash_fwd" in name else
                "flash_bwd_dq" if "bwd_dq_" in name else
                "flash_bwd_dkv" if "bwd_dkv_" in name else
                "gemm" if any(w in name for w in ("gemm", "nvjet", "cutlass", "xmma")) else
                "other")
        kinds[kind] += us / 1e3
        top.append((us / 1e3, ev.count, ev.key[:90]))
    top.sort(reverse=True)
    return {"busy_ms": sum(kinds.values()), **{f"{k}_ms": v for k, v in kinds.items()},
            "top_kernels_ms_count_name": top[:12]}


def phase_profile(params, cfg, encoded, max_len, bs, smi, label) -> dict:
    """Where one batch's forward spends the card's time: the forward
    alone (host clock, synchronised, median of 3 after one warm-up),
    then one forward under torch.profiler, kernel time summed by kind."""
    import numpy as np
    import torch
    from tdax_torch.models.qwen_vl.model import extract_layer_activations
    from tdax_torch.models.qwen_vl.preprocess import load_image_batch

    pad = max_len - encoded["input_ids"].shape[1]

    def dev(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a)).to("cuda", dtype)

    batch = (dev(np.pad(encoded["input_ids"][:bs], ((0, 0), (0, pad))), torch.long),
             dev(np.pad(encoded["attn_mask"][:bs], ((0, 0), (0, pad))), torch.int32),
             dev(encoded["last_token_idx"][:bs], torch.long),
             dev(load_image_batch(encoded["image_paths"][:bs], cfg.visual.image_size),
                 torch.float32),
             dev(encoded["image_positions"][:bs], torch.long))

    def forward():
        with torch.inference_mode():
            return extract_layer_activations(params, cfg, *batch)

    forward()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        forward()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    forward_ms = 1e3 * sorted(times)[1]

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        forward()
        torch.cuda.synchronize()
    kinds = _device_time_by_kind(prof)
    busy_ms = kinds.pop("busy_ms")
    info = {"phase": "profile", "weights": label, "nvidia_smi": smi, "batch": bs,
            "forward_ms": forward_ms, "forward_ms_runs": [1e3 * t for t in times],
            "device_busy_ms": busy_ms if busy_ms > 0 else "not measured",
            "idle_share": (1 - busy_ms / forward_ms) if busy_ms > 0 else "not measured",
            **kinds}
    emit(info)
    return info


def _fingerprint(params) -> list:
    """Slices of a few int8 leaves, to compare two int8 trees cheaply."""
    return [params["layers"]["attn_qkv_w"]["q"][-1, :64].clone(),
            params["layers"]["mlp_proj_w"]["s"][-1].clone(),
            params["lm_head"]["q"][:64, -1024:].clone(),
            params["visual"]["blocks"]["mlp_fc_w"]["q"][-1, :64].clone(),
            params["wte"]["s"].clone()]


def phase_int8_capture(tmp: Path, smi: str, state: dict, bf16_peak: int) -> dict:
    """The capture with int8 weight-only matmuls: the bf16 capture's own
    weights quantized on the card (the bf16 tree is then freed), then
    extract_activations with quantize_int8."""
    import numpy as np
    import torch
    import tdax_torch.ops.flash_attention as fa
    import tdax_torch.ops.quant_matmul as qm
    from tdax_torch.config import ExtractConfig
    from tdax_torch.models.qwen_vl.config import QwenVLConfig
    from tdax_torch.models.qwen_vl.quantize import quantize_params, quantized_bytes
    from tdax_torch.pipeline.extract import extract_activations

    cfg = QwenVLConfig()
    metadata = state["metadata"]
    bf16 = state.pop("params")
    bf16_bytes = quantized_bytes(bf16)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = quantize_params(bf16)
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    del bf16
    torch.cuda.empty_cache()
    int8_bytes = quantized_bytes(params)

    ecfg = ExtractConfig(batch_size=16, quantize_int8=True)
    out_dir = tmp / "int8"
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path = str(out_dir / "all_activations.pt")
    torch.cuda.reset_peak_memory_stats()
    fa.LAUNCHES = fa.LAUNCHES_SM90 = qm.LAUNCHES = 0
    t0 = time.perf_counter()
    results = extract_activations(metadata, out_path, cfg, ecfg, params=params, device="cuda",
                                  verbose=False)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {"qmm": qm.LAUNCHES, "flash_fwd": fa.LAUNCHES, "flash_fwd_sm90": fa.LAUNCHES_SM90}
    peak = torch.cuda.max_memory_allocated()

    acts, _ = _check_capture(out_path, metadata, results, "int8 capture")
    n_batches = math.ceil(len(metadata) / ecfg.batch_size)
    expected = {"qmm": n_batches * QMM_PER_CAPTURE_BATCH,
                "flash_fwd": n_batches * (cfg.visual.layers + 1 + cfg.num_layers),
                "flash_fwd_sm90": n_batches * (cfg.visual.layers + 1 + cfg.num_layers)}
    ref = state["acts"].astype(np.float64)
    got = acts.astype(np.float64)
    cos = (ref * got).sum(-1) / (np.linalg.norm(ref, axis=-1) * np.linalg.norm(got, axis=-1))
    tokens = n_batches * ecfg.batch_size * (state["max_len"] + cfg.visual.n_patches)
    info = {"phase": "int8_capture", "nvidia_smi": smi, "quantize_s": quantize_s,
            "weight_bytes_bf16": bf16_bytes, "weight_bytes_int8": int8_bytes,
            "capture_shape": list(acts.shape), "finite": True, "launches": launches,
            "expected_launches": expected, "wall_s": wall_s, "tokens": tokens,
            "tokens_per_s": tokens / wall_s, "max_memory_allocated_bytes": peak,
            "max_memory_allocated_bytes_bf16_capture": bf16_peak,
            "cosine_vs_bf16_min": float(cos.min()), "cosine_vs_bf16_median": float(np.median(cos)),
            "cosine_limit": INT8_MIN_COSINE}
    emit(info)
    if launches != expected:
        raise AssertionError(f"int8 capture launches {launches}, expected {expected}")
    if not cos.min() > INT8_MIN_COSINE:
        raise AssertionError(f"int8 capture: min cosine {cos.min():.4f} against the bf16 capture")
    info["profile"] = phase_profile(params, cfg, state["encoded"], state["max_len"],
                                    ecfg.batch_size, smi, "int8")
    info["fingerprint"] = _fingerprint(params)
    return info


def _cache_bytes(*caches) -> int:
    tensors = [t for c in caches for t in (c.values() if isinstance(c, dict) else [c])]
    return sum(t.numel() * t.element_size() for t in tensors)


def phase_generate(smi: str, state: dict, fingerprint: list) -> dict:
    """KV-cached greedy generation at full width from
    init_params_quantized, with bf16 caches and with int8 caches."""
    import numpy as np
    import torch
    import tdax_torch.ops.flash_attention as fa
    import tdax_torch.ops.quant_matmul as qm
    from tdax_torch.models.qwen_vl.config import QwenVLConfig
    from tdax_torch.models.qwen_vl.decoder import rms_norm
    from tdax_torch.models.qwen_vl.generate import _decode_step, generate, prefill
    from tdax_torch.models.qwen_vl.model import forward
    from tdax_torch.models.qwen_vl.preprocess import load_image_batch
    from tdax_torch.models.qwen_vl.quantize import init_params_quantized, qdot, quantized_bytes
    from tdax_torch.models.qwen_vl.tokenizer import ToyTokenizer

    cfg = QwenVLConfig()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = init_params_quantized(cfg, "cuda", seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    if not all(torch.equal(a, b) for a, b in zip(_fingerprint(params), fingerprint)):
        raise AssertionError("init_params_quantized differs from quantize_params(init_params)")

    enc, b = state["encoded"], GEN_BATCH
    pad = GEN_PROMPT_LEN - enc["input_ids"].shape[1]

    def dev(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a)).to("cuda", dtype)

    ids = dev(np.pad(enc["input_ids"][:b], ((0, 0), (0, pad)),
                     constant_values=ToyTokenizer(cfg).pad_id), torch.long)
    mask = dev(np.pad(enc["attn_mask"][:b], ((0, 0), (0, pad))), torch.int32)
    images = dev(load_image_batch(enc["image_paths"][:b], cfg.visual.image_size), torch.float32)
    pos = dev(enc["image_positions"][:b], torch.long)
    lengths = mask.sum(1).long()
    rows = torch.arange(b, device="cuda")
    t_max, n_steps = GEN_PROMPT_LEN + GEN_NEW_TOKENS, GEN_NEW_TOKENS - 1
    # the prefill's attention on the sm90 kernel, the decode steps' (Tq = 1)
    # on the mma kernel
    expected = {"qmm": QMM_PER_CAPTURE_BATCH + 1 + n_steps * QMM_PER_DECODE_STEP,
                "flash_fwd": cfg.visual.layers + 1 + cfg.num_layers + n_steps * cfg.num_layers,
                "flash_fwd_sm90": cfg.visual.layers + 1 + cfg.num_layers}

    runs = {}
    for kv_int8 in (False, True):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.LAUNCHES = fa.LAUNCHES_SM90 = qm.LAUNCHES = 0
        t0 = time.perf_counter()
        toks = generate(params, cfg, ids, mask, max_new_tokens=GEN_NEW_TOKENS, images=images,
                        image_positions=pos, kv_int8=kv_int8)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = {"qmm": qm.LAUNCHES, "flash_fwd": fa.LAUNCHES,
                    "flash_fwd_sm90": fa.LAUNCHES_SM90}
        peak = torch.cuda.max_memory_allocated()
        if toks.shape != (b, GEN_NEW_TOKENS) or not ((toks >= 0) & (toks < cfg.vocab_size)).all():
            raise AssertionError(f"generate: ids {tuple(toks.shape)} out of shape or range")
        if launches != expected:
            raise AssertionError(f"generate (kv_int8={kv_int8}): launches {launches}, "
                                 f"expected {expected}")

        # the same steps by hand: the prefill alone (timed), two decode steps
        with torch.inference_mode():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            hidden, ks, vs = prefill(params, cfg, ids, mask, images, pos, t_max=t_max,
                                     kv_int8=kv_int8)
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
            last = rms_norm(hidden[rows, lengths - 1], params["ln_f"], cfg.layer_norm_eps)
            logits = [qdot(last, params["lm_head"]).float()]
            tok = [logits[0].argmax(-1)]
            del hidden
            for i in range(2):
                step, ks, vs = _decode_step(params, cfg, tok[-1], lengths + i, ks, vs)
                logits.append(step)
                tok.append(step.argmax(-1))
            step_profile = profile_device(
                lambda: _decode_step(params, cfg, tok[-1], lengths + 2, ks, vs))
        runs[kv_int8] = {"tokens": toks, "logits": logits, "tok": tok, "info": {
            "kv_int8": kv_int8, "wall_s": wall_s, "prefill_s": prefill_s,
            "decode_ms_per_step": 1e3 * (wall_s - prefill_s) / n_steps,
            "tokens_per_s": b * GEN_NEW_TOKENS / wall_s, "cache_bytes": _cache_bytes(ks, vs),
            "max_memory_allocated_bytes": peak, "launches": launches,
            "expected_launches": expected, "decode_step_profile": step_profile}}
        del ks, vs
        torch.cuda.empty_cache()

    # the bf16-cache logits against the uncached forward on prompt + the
    # generated prefix, at each sample's last real position
    ref_run = runs[False]
    ids2, mask2 = ids.clone(), mask.clone()
    for j in range(2):
        ids2[rows, lengths + j] = ref_run["tok"][j]
        mask2[rows, lengths + j] = 1
    with torch.inference_mode():
        full = forward(params, cfg, ids2, mask2, images, pos)
        ref = [full[rows, lengths - 1 + j] for j in range(3)]
    del full
    cache_err = [float((c - r).abs().max() / r.abs().max())
                 for c, r in zip(ref_run["logits"], ref)]
    cache_agree = [float((c.argmax(-1) == r.argmax(-1)).float().mean())
                   for c, r in zip(ref_run["logits"], ref)]
    l_bf16, l_int8 = runs[False]["logits"][1], runs[True]["logits"][1]
    kv_err = float((l_int8 - l_bf16).abs().max() / l_bf16.abs().max())
    token_agree = float((runs[True]["tokens"] == runs[False]["tokens"]).float().mean())
    info = {"phase": "generate", "nvidia_smi": smi, "init_s": init_s,
            "weight_bytes_int8": quantized_bytes(params), "batch": b,
            "prompt_len": GEN_PROMPT_LEN, "prompt_lengths": lengths.tolist(),
            "max_new_tokens": GEN_NEW_TOKENS, "t_max": t_max,
            "runs": [runs[k]["info"] for k in (False, True)],
            "cached_vs_uncached_max_err_over_max_logit": cache_err,
            "cached_vs_uncached_argmax_agreement": cache_agree, "cache_tolerance": CACHE_TOL,
            "kv_int8_vs_bf16_cache_max_err_over_max_logit": kv_err,
            "kv_int8_tolerance": KV_INT8_TOL,
            "kv_int8_vs_bf16_cache_token_agreement": token_agree,
            "tokens_bf16_cache_first_rows": runs[False]["tokens"][:2].tolist()}
    emit(info)
    if max(cache_err) > CACHE_TOL:
        raise AssertionError(f"generate: cached vs uncached logits {cache_err} over {CACHE_TOL}")
    if kv_err > KV_INT8_TOL:
        raise AssertionError(f"generate: kv_int8 vs bf16 cache logits {kv_err} over "
                             f"{KV_INT8_TOL}")
    if not torch.equal(ref_run["tokens"][:, :3], torch.stack(ref_run["tok"], 1)):
        raise AssertionError("generate's first tokens differ from the same steps by hand")
    return info


def _visible_pairs(tq, tk, causal) -> int:
    """(query, key) pairs a causal or dense tile walk must compute."""
    if not causal:
        return tq * tk
    return sum(min(i + 1, tk) for i in range(tq))


def bwd_bound(b, tq, tk, nh, hd, causal, itemsize, products, out_rows):
    """(ms, 'operations' | 'bytes') of one backward kernel: `products`
    matrix products of 2 hd flops over the visible pairs; q, k, v, dO,
    bias, lse and delta read once, `out_rows` rows of hd written once."""
    flops = 2.0 * products * b * nh * _visible_pairs(tq, tk, causal) * hd
    nbytes = ((2 * b * tq + 2 * b * tk + out_rows) * nh * hd * itemsize
              + 4 * (b * tk + 2 * b * nh * tq))
    peak = BF16_PEAK if itemsize == 2 else F32_PEAK
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _bwd_terms(fa, q, k, v, bias, lse, delta, do, causal):
    """The magnitude of the terms each gradient sums: |ds| (in f32 its
    size bound, as ds cancels dp against delta) times |k| or |q|; p |dO|."""
    import torch
    p, mag = fa._probs_and_ds(q, k, v, bias, lse, delta, do, causal)
    if q.dtype == torch.float32:
        dp_mag = torch.einsum("bqhd,bkhd->bhqk", do.float().abs(), v.float().abs())
        mag = p * (dp_mag + delta.abs()[..., None]) / math.sqrt(q.shape[-1])
        del dp_mag
    mag = mag.abs_()
    return {"dq": torch.einsum("bhqk,bkhd->bqhd", mag, k.float().abs()),
            "dk": torch.einsum("bhqk,bqhd->bkhd", mag, q.float().abs()),
            "dv": torch.einsum("bhqk,bqhd->bkhd", p, do.float().abs())}


def _bwd_counts(fa) -> list:
    return [fa.BWD_DQ_LAUNCHES, fa.BWD_DKV_LAUNCHES, fa.BWD_DQ_LAUNCHES_SM90,
            fa.BWD_DKV_LAUNCHES_SM90]


def _bwd_check(fa, q, k, v, do, bias, causal, label, kernel=None):
    """The forward's lse and one backward kernel pair (the routed one, or
    ``kernel="mma"``) against their plain versions; the launch counters
    must move as the choice says.  Returns (max |kernel - plain| per
    output, lse, delta)."""
    import torch
    o, lse = fa.flash_attention(q, k, v, bias, causal, return_lse=True)
    _, lse_plain = fa.flash_attention_plain(q, k, v, bias, causal, return_lse=True)
    lse_excess = float(((lse - lse_plain).abs() - LSE_TOL * (1 + lse_plain.abs())).max())
    if lse.shape != lse_plain.shape or lse_excess > 0:
        raise AssertionError(f"{label}: lse differs from the plain version's")
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    sm90 = int((kernel or fa._bwd_route(q, k, v, do)) == "sm90")
    before = _bwd_counts(fa)
    got = {"dq": fa.flash_bwd_dq(q, k, v, bias, lse, delta, do, causal, _kernel=kernel)}
    got["dk"], got["dv"] = fa.flash_bwd_dkv(q, k, v, bias, lse, delta, do, causal,
                                            _kernel=kernel)
    torch.cuda.synchronize()
    moved = [a - b for a, b in zip(_bwd_counts(fa), before)]
    if moved != [1, 1, sm90, sm90]:
        raise AssertionError(f"{label}: backward launch counters moved {moved}")
    want = {"dq": fa.flash_bwd_dq_plain(q, k, v, bias, lse, delta, do, causal)}
    want["dk"], want["dv"] = fa.flash_bwd_dkv_plain(q, k, v, bias, lse, delta, do, causal)
    terms = _bwd_terms(fa, q, k, v, bias, lse, delta, do, causal)
    errs = {"lse": float((lse - lse_plain).abs().max())}
    for name in ("dq", "dk", "dv"):
        g, w = got[name], want[name]
        if g.shape != w.shape or g.dtype != q.dtype or not torch.isfinite(g).all():
            raise AssertionError(f"{label} {name}: shape/dtype {tuple(g.shape)} {g.dtype} "
                                 f"or non-finite")
        err = (g.float() - w.float()).abs_()
        if q.dtype == torch.bfloat16:
            ref = w.float().abs_()
            limit = ref.mul_(BWD_BF16_RTOL).add_(BWD_BF16_ATOL_OF_MAX * float(ref.max()))
            limit.add_(terms[name], alpha=BWD_BF16_TERMS)
        else:
            limit = terms[name] * BWD_F32_REL_TOL
        excess = float((err - limit).max())
        errs[name] = float(err.max())
        if excess > 0:
            raise AssertionError(f"{label} {name}: max |kernel - plain| = {errs[name]:.3e} is "
                                 f"outside the tolerance by {excess:.3e}")
    return errs, lse, delta


def _device_ms(fn, iters: int) -> float:
    """The card's kernel time per call of ``fn`` (torch.profiler, summed
    over every kernel it launches): free of host gaps between launches,
    such as autograd's hand-off to its device thread."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(ev, "self_device_time_total", 0.0) for ev in prof.key_averages()
             if ev.device_type == torch.autograd.DeviceType.CUDA)
    return us / 1e3 / iters if us > 0 else "not measured"


def _median_spread(fn, iters: int) -> tuple:
    """(median, max - min) ms of BWD_REPEATS timings of ``iters`` calls."""
    runs = sorted(cuda_ms(fn, iters) for _ in range(BWD_REPEATS))
    return runs[len(runs) // 2], runs[-1] - runs[0]


def phase_flash_bwd(smi: str) -> dict:
    """The flash backward kernels and the forward's lse against their
    plain versions at the training path's shapes, bf16 and f32; at each
    site the route sends to flash_bwd_sm90.cu, that pair and flash_bwd.cu
    (forced) both, bitwise repeats at the training shape; times."""
    import torch
    import torch.nn.functional as F
    import tdax_torch.ops.flash_attention as fa
    from tdax_torch.runtime import get_device

    device = get_device()
    gen = torch.Generator(device=device).manual_seed(97)
    sites, f32_errs = [], {}
    for dtype in (torch.bfloat16, torch.float32):
        for name, b, tq, tk, nh, hd, causal, calls in BWD_SHAPES:
            q, k, v = _case_inputs(gen, b, tq, tk, nh, hd, dtype, device,
                                   strided_kv=name == "decoder", strided_q=name == "vit")
            do = torch.randn((b, tq, nh, hd), generator=gen, device=device, dtype=dtype)
            valid = torch.ones((b, tk), dtype=torch.int32, device=device)
            if name == "decoder":
                valid[-1, -TRAIN_MASKED:] = 0
            elif name == "ragged":
                valid[0, -20:] = 0
            bias = torch.where(valid > 0, 0.0, fa.NEG_INF).to(torch.float32)
            label = f"{str(dtype)[6:]} {name}"
            route = fa._bwd_route(q, k, v, do)
            if route != ("sm90" if dtype == torch.bfloat16 else "mma"):
                raise AssertionError(f"{label}: the backward is routed to the {route} kernels")
            errs, lse, delta = _bwd_check(fa, q, k, v, do, bias, causal, f"{label} ({route})")
            if dtype == torch.float32:
                f32_errs[name] = errs
                continue
            errs_mma, _, _ = _bwd_check(fa, q, k, v, do, bias, causal, f"{label} (mma)", "mma")
            args = (q, k, v, bias, lse, delta, do, causal)
            if name == "decoder":  # no atomics: the same inputs give the same bits
                first, again = ([fa.flash_bwd_dq(*args), *fa.flash_bwd_dkv(*args)]
                                for _ in range(2))
                torch.cuda.synchronize()
                if not all(torch.equal(x, y) for x, y in zip(first, again)):
                    raise AssertionError(f"{label}: two runs of the sm90 backward differ")
                del first, again
            site = {"site": name, "shape": [b, tq, tk, nh, hd], "causal": causal,
                    "dtype": "bfloat16", "route": route, "key_mask": "last row's final 128 keys"
                    if name == "decoder" else "first row's final 20 keys"
                    if name == "ragged" else None,
                    "calls_per_train_step": calls, "max_abs_err": errs,
                    "max_abs_err_mma": errs_mma, "bitwise_repeat": name == "decoder" or None,
                    "timing": f"median and spread of {BWD_REPEATS} x 10 calls; *_device_ms: "
                              "profiled kernel time per call over 10"}
            for kind, fn in (("dq", fa.flash_bwd_dq), ("dkv", fa.flash_bwd_dkv)):
                site[f"{kind}_ms"], site[f"{kind}_spread_ms"] = _median_spread(
                    lambda: fn(*args), 10)
                site[f"{kind}_ms_mma"], site[f"{kind}_spread_ms_mma"] = _median_spread(
                    lambda: fn(*args, _kernel="mma"), 10)
            site.update({
                "fwd_lse_ms": cuda_ms(lambda: fa.flash_attention(
                    q, k, v, bias, causal, return_lse=True), iters=10),
                "plain_dq_ms": cuda_ms(lambda: fa.flash_bwd_dq_plain(*args), iters=3),
                "plain_dkv_ms": cuda_ms(lambda: fa.flash_bwd_dkv_plain(*args), iters=3)})
            # SDPA (is_causal, no key mask): its whole backward (dq, dk, dv)
            # alone, autograd.grad over a retained graph
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
            dot = do.transpose(1, 2)
            out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
            site["library_bwd_ms"], site["library_bwd_spread_ms"] = _median_spread(
                lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True), 10)
            for key, fn in (("library_bwd_device_ms", lambda: torch.autograd.grad(
                    out, (qt, kt, vt), dot, retain_graph=True)),
                    ("dq_device_ms", lambda: fa.flash_bwd_dq(*args)),
                    ("dkv_device_ms", lambda: fa.flash_bwd_dkv(*args))):
                site[key] = _device_ms(fn, 10)
            site["library_mask"] = f"is_causal={causal}, no key mask"
            site["dq_bound_ms"], site["dq_bound_by"] = bwd_bound(b, tq, tk, nh, hd, causal, 2,
                                                                 3, b * tq)
            site["dkv_bound_ms"], site["dkv_bound_by"] = bwd_bound(b, tq, tk, nh, hd, causal,
                                                                   2, 4, 2 * b * tk)
            # the yardstick: SDPA's profiled device time (its CUDA-event time
            # carries autograd's host hand-off and spread 0.4 ms in one run)
            profiled = isinstance(site["library_bwd_device_ms"], float)
            site["library_ms"] = site["library_bwd_device_ms" if profiled else "library_bwd_ms"]
            site["library_timed_by"] = "torch.profiler device time" if profiled else "CUDA events"
            site["pair_ms"] = site["dq_ms"] + site["dkv_ms"]
            site["pair_over_library"] = site["pair_ms"] / site["library_ms"]
            emit({"phase": "kernel_case", "kernel": "flash_bwd", "nvidia_smi": smi, **site})
            sites.append(site)
            del q, k, v, do, qt, kt, vt, dot, out, lse, delta, args
            torch.cuda.empty_cache()
    emit({"phase": "kernel_flash_bwd_f32", "max_abs_err": f32_errs,
          "tolerance": f"{BWD_F32_REL_TOL} x the summed terms' magnitude"})
    return {"sites": sites, "f32_max_abs_err": f32_errs}


def _tree_to(tree, device):
    """A copy of a params tree on ``device`` (training updates in place)."""
    return {name: _tree_to(leaf, device) if isinstance(leaf, dict)
            else leaf.to(device, copy=True) for name, leaf in tree.items()}


def _tree_err(got, want, path=""):
    """{path: (max |got - want|, max |want|)} over two trees of tensors."""
    out = {}
    for name, w in want.items():
        if isinstance(w, dict):
            out.update(_tree_err(got[name], w, f"{path}{name}/"))
        else:
            g = got[name].detach().cpu().float()
            w = w.detach().cpu().float()
            out[path + name] = (float((g - w).abs().max()), float(w.abs().max()))
    return out


def _tiny_batch(cfg, seed, device, images=False):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    b, t = 2, 24
    ids = rng.integers(1, 64, (b, t))
    mask = np.ones((b, t), np.int32)
    mask[-1, t - 5:] = 0
    batch = {"input_ids": torch.as_tensor(ids, device=device).long(),
             "attn_mask": torch.as_tensor(mask, device=device)}
    if images:
        nq, size = cfg.visual.n_queries, cfg.visual.image_size
        pos = np.full((b, nq), -1)
        pos[0] = np.arange(2, 2 + nq)
        batch["image_positions"] = torch.as_tensor(pos, device=device).long()
        batch["images"] = torch.as_tensor(
            rng.normal(size=(b, 3, size, size)).astype(np.float32), device=device)
    return batch


def phase_tiny_train(tmp: Path) -> dict:
    """The tiny f32 config trained on the card (kernels) and on the CPU
    (plain versions), and a bitwise resume on the card."""
    import torch
    import tdax_torch.ops.flash_attention as fa
    from tdax_torch.models.qwen_vl.config import QwenVLConfig
    from tdax_torch.models.qwen_vl.model import init_params
    from tdax_torch.parallel import (default_optimizer, lm_loss, make_train_step, train_loop,
                                     warmup_cosine_lr)

    cfg = QwenVLConfig.tiny(dtype="float32")
    text_tree = init_params(cfg, "cpu", seed=11, with_visual=False)
    info = {"phase": "tiny_train", "grad_tolerance": TINY_GRAD_TOL,
            "param_tolerance": [TINY_PARAM_RTOL, TINY_PARAM_ATOL]}

    # loss and every gradient
    grads, losses = {}, {}
    for dev in ("cpu", "cuda"):
        state = default_optimizer().init(_tree_to(text_tree, dev))
        batch = _tiny_batch(cfg, 1, dev)
        loss = lm_loss(state.tree, cfg, batch["input_ids"], batch["attn_mask"])
        grads[dev] = state.stack(torch.autograd.grad(loss, state.leaves))
        losses[dev] = float(loss.detach())
    grad_err = _tree_err(grads["cuda"], grads["cpu"])
    info["loss_card_cpu"] = [losses["cuda"], losses["cpu"]]
    info["grad_max_err_over_max"] = max(e / max(m, 1e-30) for e, m in grad_err.values())
    if (abs(losses["cuda"] - losses["cpu"]) > 1e-5 * abs(losses["cpu"])
            or info["grad_max_err_over_max"] > TINY_GRAD_TOL):
        raise AssertionError(f"tiny train: card vs CPU loss {info['loss_card_cpu']} or "
                             f"gradients {grad_err}")

    # three make_train_step steps
    runs = {}
    for dev in ("cpu", "cuda"):
        opt = default_optimizer(warmup_cosine_lr(1e-3, 2, 6))
        params = _tree_to(text_tree, dev)
        state = opt.init(params)
        step = make_train_step(cfg, opt, device=dev)
        step_losses = []
        for i in range(3):
            params, state, loss = step(params, state, _tiny_batch(cfg, 10 + i, dev))
            step_losses.append(float(loss))
        runs[dev] = (params, state, step_losses)
    param_err = _tree_err(runs["cuda"][0], runs["cpu"][0])
    mu_err = _tree_err(runs["cuda"][1].mu, runs["cpu"][1].mu)
    info["step_losses_card_cpu"] = [runs["cuda"][2], runs["cpu"][2]]
    info["param_max_abs_err"] = max(e for e, _ in param_err.values())
    info["mu_max_err_over_max"] = max(e / max(m, 1e-30) for e, m in mu_err.values())
    bad = [k for k, (e, m) in param_err.items() if e > TINY_PARAM_ATOL + TINY_PARAM_RTOL * m]
    if bad or info["mu_max_err_over_max"] > TINY_GRAD_TOL or any(
            abs(a - b) > 1e-5 * abs(b) for a, b in zip(*info["step_losses_card_cpu"])):
        raise AssertionError(f"tiny train steps: card vs CPU params {bad}, moments "
                             f"{info['mu_max_err_over_max']:.3e}, losses "
                             f"{info['step_losses_card_cpu']}")

    # a with_images step: the ViT's and the resampler's backward
    vis_tree = init_params(cfg, "cpu", seed=12)
    img_losses = {}
    for dev in ("cpu", "cuda"):
        opt = default_optimizer(1e-3)
        params = _tree_to(vis_tree, dev)
        state = opt.init(params)
        step = make_train_step(cfg, opt, with_images=True, device=dev)
        fa.LAUNCHES = fa.BWD_DQ_LAUNCHES = fa.BWD_DKV_LAUNCHES = 0
        _, _, loss = step(params, state, _tiny_batch(cfg, 20, dev, images=True))
        img_losses[dev] = float(loss)
        launches = [fa.LAUNCHES, fa.BWD_DQ_LAUNCHES, fa.BWD_DKV_LAUNCHES]
    expected = cfg.num_layers + cfg.visual.layers + 1
    info["images_step_loss_card_cpu"] = [img_losses["cuda"], img_losses["cpu"]]
    info["images_step_launches_fwd_dq_dkv"] = launches
    if launches != [expected] * 3 or abs(img_losses["cuda"] - img_losses["cpu"]) > 1e-5 * abs(
            img_losses["cpu"]):
        raise AssertionError(f"tiny with_images step: launches {launches} (expected "
                             f"{expected} each), losses {info['images_step_loss_card_cpu']}")

    # train_loop stopped at step 4 and resumed to 6, on the card
    fixed = [_tiny_batch(cfg, 40 + i, "cuda") for i in range(6)]

    def loop(n_steps, **kw):
        return train_loop(_tree_to(text_tree, "cuda"), cfg, lambda i: fixed[i], n_steps,
                          optimizer=default_optimizer(warmup_cosine_lr(1e-3, 2, 6)),
                          device="cuda", **kw)

    straight, s_state, all_losses = loop(6)
    ck = str(tmp / "tiny_train_ck")
    loop(4, checkpoint_path=ck, checkpoint_every=4)
    resumed, r_state, rest = loop(6, checkpoint_path=ck, checkpoint_every=100)
    same = (rest == all_losses[4:] and r_state.count == s_state.count == 6 and all(
        e == 0 for tree_a, tree_b in ((straight, resumed), (s_state.mu, r_state.mu),
                                      (s_state.nu, r_state.nu))
        for e, _ in _tree_err(tree_a, tree_b).values()))
    info["resume_bitwise"] = same
    info["resume_losses"] = [all_losses, rest]
    emit(info)
    if not same:
        raise AssertionError("tiny train_loop resumed from its checkpoint differs from the "
                             "uninterrupted run")
    return info


def train_flops(cfg, b, t) -> float:
    """bench_train.py's count for one step: 3 x the forward (decoder
    matmuls, LM head, attention), remat's recompute not credited."""
    h, ff = cfg.hidden_size, cfg.ff_half
    per_token = cfg.num_layers * 2 * (h * 3 * h + h * h + 3 * h * ff)
    fwd = b * t * (per_token + 2 * h * cfg.vocab_size) + cfg.num_layers * 4 * t * t * h * b
    return 3.0 * fwd


def phase_train(smi: str, seed: int) -> dict:
    """The training step at the full decoder width on the card."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    import tdax_torch.ops.flash_attention as fa
    from tdax_torch.models.qwen_vl.config import QwenVLConfig
    from tdax_torch.models.qwen_vl.model import init_params
    from tdax_torch.parallel import default_optimizer, make_train_step, warmup_cosine_lr

    cfg = QwenVLConfig()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, "cuda", seed=seed, with_visual=False)
    opt = default_optimizer(warmup_cosine_lr(1e-4, 2, 8))
    state = opt.init(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(leaf.numel() for leaf in state.leaves)
    step = make_train_step(cfg, opt, remat=True)

    rng = np.random.default_rng(seed)
    ids = rng.integers(1, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ))
    mask = np.ones((TRAIN_BATCH, TRAIN_SEQ), np.int32)
    mask[-1, -TRAIN_MASKED:] = 0
    batch = {"input_ids": torch.as_tensor(ids, device="cuda").long(),
             "attn_mask": torch.as_tensor(mask, device="cuda")}

    losses = []
    t0 = time.perf_counter()
    params, state, loss = step(params, state, batch)
    losses.append(loss)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    fa.LAUNCHES = fa.LAUNCHES_SM90 = fa.BWD_DQ_LAUNCHES = fa.BWD_DKV_LAUNCHES = 0
    fa.BWD_DQ_LAUNCHES_SM90 = fa.BWD_DKV_LAUNCHES_SM90 = 0
    t0 = time.perf_counter()
    for _ in range(TRAIN_TIMED_STEPS):
        params, state, loss = step(params, state, batch)
        losses.append(loss)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / TRAIN_TIMED_STEPS
    launches = {"flash_fwd": fa.LAUNCHES, "flash_fwd_sm90": fa.LAUNCHES_SM90,
                "flash_bwd_dq": fa.BWD_DQ_LAUNCHES, "flash_bwd_dkv": fa.BWD_DKV_LAUNCHES,
                "flash_bwd_dq_sm90": fa.BWD_DQ_LAUNCHES_SM90,
                "flash_bwd_dkv_sm90": fa.BWD_DKV_LAUNCHES_SM90}
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]

    # one more step split in two (host clock), then one profiled the same way
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, grads = step.loss_and_grads(params, state, batch)
    torch.cuda.synchronize()
    parts = {"loss_and_grads_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    state.update(grads)
    torch.cuda.synchronize()
    parts["update_s"] = time.perf_counter() - t0
    losses.append(float(loss))
    del grads

    profiled = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loss, grads = step.loss_and_grads(params, state, batch)
        torch.cuda.synchronize()
        profiled["loss_and_grads_wall_ms"] = 1e3 * (time.perf_counter() - t0)
    kinds = _device_time_by_kind(prof)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state.update(grads)
        torch.cuda.synchronize()
        profiled["update_wall_ms"] = 1e3 * (time.perf_counter() - t0)
    opt_kinds = _device_time_by_kind(prof)
    del grads
    busy = kinds["busy_ms"] + opt_kinds["busy_ms"]
    wall = profiled["loss_and_grads_wall_ms"] + profiled["update_wall_ms"]
    profiled.update({
        "gemm_ms": kinds["gemm_ms"], "flash_fwd_ms": kinds["flash_ms"],
        "flash_bwd_dq_ms": kinds["flash_bwd_dq_ms"], "flash_bwd_dkv_ms": kinds["flash_bwd_dkv_ms"],
        "elementwise_and_other_ms": kinds["other_ms"], "optimizer_ms": opt_kinds["busy_ms"],
        "optimizer_gemm_ms": opt_kinds["gemm_ms"],
        "device_busy_ms": busy if busy > 0 else "not measured",
        "idle_share": (1 - busy / wall) if busy > 0 else "not measured",
        "top_kernels_ms_count_name": kinds["top_kernels_ms_count_name"][:8],
        "optimizer_top_kernels": opt_kinds["top_kernels_ms_count_name"][:5]})

    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = train_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    expected = {"flash_fwd": 2 * cfg.num_layers * TRAIN_TIMED_STEPS,
                "flash_fwd_sm90": 2 * cfg.num_layers * TRAIN_TIMED_STEPS,
                "flash_bwd_dq": cfg.num_layers * TRAIN_TIMED_STEPS,
                "flash_bwd_dkv": cfg.num_layers * TRAIN_TIMED_STEPS,
                "flash_bwd_dq_sm90": cfg.num_layers * TRAIN_TIMED_STEPS,
                "flash_bwd_dkv_sm90": cfg.num_layers * TRAIN_TIMED_STEPS}
    ref_gap = (max(abs(a - b) for a, b in zip(losses, TRAIN_REF_LOSSES_SEED0))
               if seed == 0 else None)
    info = {"phase": "train", "nvidia_smi": smi, "params": n_params, "dtype": cfg.dtype,
            "batch": [TRAIN_BATCH, TRAIN_SEQ], "masked_positions": TRAIN_MASKED,
            "remat": True, "seed": seed, "init_s": init_s, "warm_step_s": warm_s,
            "step_s": step_s, "tokens_per_s": tokens / step_s,
            "flops_per_step": flops, "tflops": flops / step_s / 1e12,
            "share_of_989_tflops": flops / step_s / BF16_PEAK,
            "max_memory_allocated_bytes": peak, "launches": launches,
            "expected_launches": expected, "losses": losses,
            "max_gap_to_reference_losses": ref_gap, "split_step": parts,
            "profiled_step": profiled}
    emit(info)
    if n_params != 7_721_324_544:
        raise AssertionError(f"train: {n_params} parameters, expected 7,721,324,544")
    if launches != expected:
        raise AssertionError(f"train: launches {launches}, expected {expected}")
    if not np.isfinite(losses).all() or not losses[TRAIN_TIMED_STEPS] < losses[0]:
        raise AssertionError(f"train: losses {losses} not finite or not decreasing")
    if ref_gap is not None and ref_gap > TRAIN_LOSS_TOL:
        raise AssertionError(f"train: losses {losses} leave the reference trajectory "
                             f"{TRAIN_REF_LOSSES_SEED0} by {ref_gap:.4f}")
    return info


def _qmm_totals(sites, calls_key) -> dict:
    """Kernel, plain, library and bound ms summed over the sites of one
    capture batch or one decode step, each weighted by its calls."""
    out = {key: sum(s[key] * s[calls_key] for s in sites)
           for key in ("ms", "plain_ms", "bound_ms", "library_ms")}
    by_ops = sum(s["bound_ms"] * s[calls_key] for s in sites if s["bound_by"] == "operations")
    out["bound_by"] = "operations" if by_ops >= out["bound_ms"] - by_ops else "bytes"
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0, help="the training batch's seed")
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    import_port()
    from tdax_torch.runtime import get_device
    get_device()  # cuda, with TF32 off

    env = phase_env()
    smi = env["nvidia_smi"]
    kern = phase_kernels()
    sq = phase_sqdist()
    qmm = phase_qmm()
    fbwd = phase_flash_bwd(smi)
    with tempfile.TemporaryDirectory(prefix="tdax_torch_smoke_") as tmp:
        phase_tiny_parity(Path(tmp))
        phase_tiny_int8(Path(tmp))
        phase_tiny_train(Path(tmp))
        capture, state = phase_capture(Path(tmp), smi)
        int8 = phase_int8_capture(Path(tmp), smi, state, capture["max_memory_allocated_bytes"])
        gen = phase_generate(smi, state, int8.pop("fingerprint"))
        del state
        torch.cuda.empty_cache()
        phase_sweep(Path(tmp), smi)
    scale = phase_scale(smi)
    gc.collect()
    torch.cuda.empty_cache()
    train = phase_train(smi, args.seed)

    def total(key):
        return sum(s[key] * s["calls_per_batch"] for s in kern["sites"])

    dec = next(s for s in fbwd["sites"] if s["site"] == "decoder")
    calls = dec["calls_per_train_step"]
    by_ops = sum(s["bound_ms"] * s["calls_per_batch"] for s in kern["sites"]
                 if s["bound_by"] == "operations")
    by_bytes = total("bound_ms") - by_ops
    tr = kern["train"]
    emit({"kernels": [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "tdax_torch/ops/csrc/flash_fwd_sm90.cu",
        "sources": {"sm90": "tdax_torch/ops/csrc/flash_fwd_sm90.cu",
                    "mma": "tdax_torch/ops/csrc/flash_fwd.cu"},
        "replaces": "tdax/ops/flash_attention.py:164",
        "launches": capture["flash_launches_sm90"],
        "launches_by_kernel": {
            "capture": {"sm90": capture["flash_launches_sm90"],
                        "mma": capture["flash_launches"] - capture["flash_launches_sm90"]},
            "int8_capture": {"sm90": int8["launches"]["flash_fwd_sm90"],
                             "mma": int8["launches"]["flash_fwd"]
                             - int8["launches"]["flash_fwd_sm90"]},
            "generate": {"sm90": gen["runs"][0]["launches"]["flash_fwd_sm90"],
                         "mma": gen["runs"][0]["launches"]["flash_fwd"]
                         - gen["runs"][0]["launches"]["flash_fwd_sm90"]},
            "train": {"sm90": train["launches"]["flash_fwd_sm90"],
                      "mma": train["launches"]["flash_fwd"]
                      - train["launches"]["flash_fwd_sm90"]}},
        "max_abs_err": max(s["max_abs_err"] for s in kern["sites"] + [tr]),
        "ms": total("ms"),
        "ms_mma": total("ms_mma"),
        "plain_ms": total("plain_ms"),
        "bound_ms": total("bound_ms"),
        "bound_by": "operations" if by_ops >= by_bytes else "bytes",
        "library_ms": total("library_ms"),
        "per": "one batch of 16: 48 ViT + 1 resampler + 32 decoder calls, bf16, on the sm90 "
               "kernel the route picks; ms_mma is flash_fwd.cu at the same calls",
        "decode_step": {"kernel": "mma", **{k: kern["decode"][k] for k in (
            "shape", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "calls_per_decode_step")}},
        "train_step_with_lse": {k: tr[k] for k in ("shape", "ms", "ms_mma", "plain_ms",
                                                   "bound_ms", "bound_by", "library_ms",
                                                   "lse_max_abs_err", "calls_per_train_step")},
    }, *({
        "name": f"flash_bwd_{kind}",
        "route": "cuda",
        "source": "tdax_torch/ops/csrc/flash_bwd_sm90.cu",
        "sources": {"sm90": "tdax_torch/ops/csrc/flash_bwd_sm90.cu",
                    "mma": "tdax_torch/ops/csrc/flash_bwd.cu"},
        "replaces": f"tdax/ops/flash_attention.py:{line}",
        "launches": train["launches"][f"flash_bwd_{kind}"],
        "launches_by_kernel": {"train": {
            "sm90": train["launches"][f"flash_bwd_{kind}_sm90"],
            "mma": train["launches"][f"flash_bwd_{kind}"]
            - train["launches"][f"flash_bwd_{kind}_sm90"]}},
        "max_abs_err": max(s["max_abs_err"][o] for s in fbwd["sites"] for o in outs),
        "max_abs_err_mma": max(s["max_abs_err_mma"][o] for s in fbwd["sites"] for o in outs),
        "ms": dec[f"{kind}_ms"] * calls,
        "ms_mma": dec[f"{kind}_ms_mma"] * calls,
        "plain_ms": dec[f"plain_{kind}_ms"] * calls,
        "bound_ms": dec[f"{kind}_bound_ms"] * calls,
        "bound_by": dec[f"{kind}_bound_by"],
        "library_ms": dec["library_ms"] * calls,
        "per": f"one training step ({TRAIN_TIMED_STEPS} timed steps' launches): {calls} calls "
               "at [4, 1024, 32, 128] causal bf16 on the sm90 kernels the route picks (medians "
               f"of {BWD_REPEATS} x 10 calls); ms_mma is flash_bwd.cu at the same calls; "
               "library_ms is SDPA's whole backward (dq, dk and dv) alone at that shape, "
               f"is_causal=True without the key mask, by {dec['library_timed_by']}",
    } for kind, line, outs in (("dq", 395, ("dq",)), ("dkv", 446, ("dk", "dv")))), {
        "name": "sqdist",
        "route": "cuda",
        "source": "tdax_torch/ops/csrc/sqdist.cu",
        "replaces": "tdax/ops/pallas_distances.py:27",
        "launches": scale["sqdist_launches"],
        "max_abs_err": sq["max_abs_err"],
        "ms": sq["site"]["ms"],
        "plain_ms": sq["site"]["plain_ms"],
        "bound_ms": sq["site"]["bound_ms"],
        "bound_by": sq["site"]["bound_by"],
        "library_ms": sq["site"]["library_ms"],
        "per": "one call at the scale path's [10000, 4096] f32; library_ms is torch.cdist, "
               "the Euclidean function, whose wrapper (kernel + sqrt + zero diagonal) takes "
               f"{sq['site']['euclid_ms']:.4f} ms",
    }, {
        "name": "qmm",
        "route": "cuda",
        "source": "tdax_torch/ops/csrc/qmm.cu",
        "replaces": "tdax/ops/quant_matmul.py:40",
        "launches": int8["launches"]["qmm"],
        "launches_generate": gen["runs"][0]["launches"]["qmm"],
        "max_abs_err": qmm["max_abs_err"],
        **_qmm_totals(qmm["sites"], "calls_per_capture_batch"),
        "per": f"one int8 capture batch of 16 ({QMM_PER_CAPTURE_BATCH} calls); library_ms is "
               "torch.matmul on the same weight pre-converted to bf16",
        "decode_step": {"calls": QMM_PER_DECODE_STEP,
                        **_qmm_totals(qmm["sites"], "calls_per_decode_step")},
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
