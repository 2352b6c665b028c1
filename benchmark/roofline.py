"""The benchmark's yardstick: the card's peaks and the least time a piece
of work needs on it.

Peaks are NVIDIA's data sheet for one H100 SXM (dense, no sparsity, at
the 700 W limit).  A bound counts each input byte read once and each
output byte written once, and the operations the algorithm needs; causal
attention counts the visible (query, key) pairs only.  Each function
returns the bound in seconds.
"""

from __future__ import annotations

BF16_PEAK = 989e12      # dense bf16 tensor-core FLOP/s
F32_PEAK = 67e12        # f32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12


def _seconds(flops: float, nbytes: float, peak: float) -> float:
    return max(flops / peak, nbytes / HBM_BYTES_PER_S)


def visible_pairs(tq: int, tk: int, causal: bool) -> int:
    """(query, key) pairs a causal or dense attention must compute."""
    if not causal:
        return tq * tk
    return sum(min(i + 1, tk) for i in range(tq))


def attn_fwd_bound(b, tq, tk, nh, hd, causal, itemsize=2, hd_v=None) -> float:
    """One flash forward call with q and k of head width ``hd`` and v and
    o of ``hd_v`` (``hd`` where None; latent attention's differ):
    2 b nh tq tk (hd + hd_v) flops (halved when causal); q, k, v, the key
    bias read and o written once."""
    hd_v = hd if hd_v is None else hd_v
    flops = 2.0 * b * nh * tq * tk * (hd + hd_v) / (2 if causal else 1)
    nbytes = (b * tq + b * tk) * nh * (hd + hd_v) * itemsize + 4 * b * tk
    return _seconds(flops, nbytes, BF16_PEAK if itemsize == 2 else F32_PEAK)


def attn_bwd_bound(b, tq, tk, nh, hd, causal, itemsize, products, out_rows) -> float:
    """One backward kernel: ``products`` matrix products of 2 hd flops over
    the visible pairs; q, k, v, dO, bias, lse and delta read once,
    ``out_rows`` rows of hd written once."""
    flops = 2.0 * products * b * nh * visible_pairs(tq, tk, causal) * hd
    nbytes = ((2 * b * tq + 2 * b * tk + out_rows) * nh * hd * itemsize
              + 4 * (b * tk + 2 * b * nh * tq))
    return _seconds(flops, nbytes, BF16_PEAK if itemsize == 2 else F32_PEAK)


def attn_bwd_pair_bound(b, tq, tk, nh, hd, causal, itemsize=2) -> tuple[float, float]:
    """(dq kernel, dk/dv kernel): dq recomputes s and dP and forms dq
    (3 products, writes Tq rows); dk/dv recomputes s and dP and forms dk
    and dv (4 products, writes 2 Tk rows)."""
    return (attn_bwd_bound(b, tq, tk, nh, hd, causal, itemsize, 3, b * tq),
            attn_bwd_bound(b, tq, tk, nh, hd, causal, itemsize, 4, 2 * b * tk))


def qmm_bound(m, k, n, x_bytes=2) -> float:
    """One int8 weight-only product: 2 m n k tensor-core flops; x, the int8
    weight and its f32 scales read once, the output written once."""
    nbytes = m * k * x_bytes + k * n + 4 * n + m * n * x_bytes
    return _seconds(2.0 * m * n * k, nbytes, BF16_PEAK)
