"""Pairwise distances (port of ``tdax/ops/distances.py``).

Host numpy paths in float64 difference form (the PH oracle's and the
small-cloud Rips path's exact distances) and PyTorch paths on tensors
of shape ``[..., n, d]``, so one call serves a single cloud and a stack
of layer clouds alike.

Euclidean: ``exact=True`` is the difference form ``sum((x - y)^2)``;
``exact=False`` the expansion ``|x|^2 + |y|^2 - 2 x.y`` through one
matrix product (true f32: ``runtime.get_device`` turns TF32 off), which
loses up to ~1e-4 absolute to cancellation for nearby points.  The
10k-point scale path's expansion form is the hand-written kernel in
``tdax_torch.ops.sqdist``.
"""

from __future__ import annotations

import numpy as np
import torch


def pairwise_euclidean_np(x: np.ndarray, dtype=np.float64) -> np.ndarray:
    """Exact pairwise Euclidean distances, difference form, float64 accumulate."""
    x = np.asarray(x, dtype=dtype)
    diff = x[:, None, :] - x[None, :, :]
    return np.sqrt(np.einsum("ijk,ijk->ij", diff, diff))


def pairwise_cosine_np(x: np.ndarray, dtype=np.float64) -> np.ndarray:
    x = np.asarray(x, dtype=dtype)
    norms = np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-30)
    xn = x / norms
    d = 1.0 - xn @ xn.T
    np.clip(d, 0.0, 2.0, out=d)
    np.fill_diagonal(d, 0.0)
    return d


def _off_diagonal(d: torch.Tensor) -> torch.Tensor:
    """``d`` with its (last two axes') diagonal set to exactly 0."""
    n = d.shape[-1]
    eye = torch.eye(n, dtype=torch.bool, device=d.device)
    return d.masked_fill(eye, 0.0)


def pairwise_sq_euclidean(x: torch.Tensor, exact: bool = False) -> torch.Tensor:
    """Squared Euclidean distances ``[..., n, n]`` of ``x [..., n, d]``."""
    if exact:
        diff = x[..., :, None, :] - x[..., None, :, :]
        return (diff * diff).sum(-1)
    sq = (x * x).sum(-1)
    g = x @ x.transpose(-1, -2)
    return (sq[..., :, None] + sq[..., None, :] - 2.0 * g).clamp_min(0.0)


def pairwise_euclidean(x: torch.Tensor, exact: bool = False) -> torch.Tensor:
    """Euclidean distances with an exactly zero diagonal."""
    return _off_diagonal(pairwise_sq_euclidean(x, exact=exact).sqrt())


def pairwise_cosine(x: torch.Tensor) -> torch.Tensor:
    """Cosine distance ``1 - cos(x_i, x_j)`` clipped to [0, 2], diagonal exactly 0."""
    xn = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-30)
    sim = xn @ xn.transpose(-1, -2)
    return _off_diagonal((1.0 - sim).clamp(0.0, 2.0))


def pairwise_distances(x, metric: str = "euclidean", backend: str = "torch",
                       device=None) -> np.ndarray:
    """Host numpy [n, n] distances of ``x`` [n, d] (tdax's unified entry).
    ``backend="numpy"``: the float64 host paths above.  ``"torch"`` (tdax's
    ``"jax"``): f32 on ``device`` (the card unless the caller asks for the
    CPU), Euclidean in difference form while n * d < 2^22 and in the
    expansion form above that, as tdax."""
    if backend == "numpy":
        if metric == "euclidean":
            return pairwise_euclidean_np(x)
        if metric == "cosine":
            return pairwise_cosine_np(x)
        raise ValueError(f"unknown metric {metric!r}")
    if backend != "torch":
        raise ValueError(f"unknown backend {backend!r}")
    from tdax_torch.runtime import as_device_f32

    xt = as_device_f32(x, device)
    if metric == "euclidean":
        return pairwise_euclidean(xt, exact=xt.shape[0] * xt.shape[-1] < 2**22).cpu().numpy()
    if metric == "cosine":
        return pairwise_cosine(xt).cpu().numpy()
    raise ValueError(f"unknown metric {metric!r}")
