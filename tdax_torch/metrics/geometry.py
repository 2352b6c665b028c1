"""Geometry metrics (port of ``tdax/metrics/geometry.py``).

The reference's geometry library (its root ``metrics.py``): effective
dimensionality, TwoNN intrinsic dimensionality, both over fixed windows,
per-example token accuracy and the matrix entropy of the Gram spectrum.
The edge-case conventions are tdax's: window truncation, NaN returns,
TwoNN's outlier discard counted against the sample count, the unbiased
variance guards and the (0, 1000) slope bound.

The tensor metrics take numpy arrays or tensors, in float32, through
``as_device_f32``: a tensor stays on its device, anything else goes to
the card unless the caller passes ``device="cpu"``.  They return
tensors on that device.  ``compute_accuracy_by_example`` is host numpy
(a regex over string labels), as in tdax.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from tdax_torch.runtime import as_device_f32


def compute_effective_dimensionality(activations_batch, device=None) -> torch.Tensor:
    """Normalised participation ratio of the singular values
    (reference metrics.py:5-44): [(sum s)^2 / sum s^2] / min(N, D).

    [batch, n_samples, embed_dim] -> [batch]."""
    x = as_device_f32(activations_batch, device)
    s = torch.linalg.svdvals(x)
    sum_s = s.sum(dim=1)
    sum_s2 = torch.clamp((s * s).sum(dim=1), min=1e-10)
    pr = (sum_s * sum_s) / sum_s2
    min_dim = float(min(x.shape[1], x.shape[2]))
    return pr / max(min_dim, 1.0)


def _windows(x: torch.Tensor, n_windows: int, window_size: int) -> torch.Tensor:
    """[batch, seq, dim] -> [n_windows * batch, window_size, dim],
    window-major, the sequence truncated to n_windows * window_size."""
    batch, _, dim = x.shape
    w = x[:, :n_windows * window_size, :].reshape(batch, n_windows, window_size, dim)
    return w.transpose(0, 1).reshape(n_windows * batch, window_size, dim)


def compute_fixed_window_ed(activations_batch, n_windows: int, device=None) -> torch.Tensor:
    """ED over fixed non-overlapping windows (reference metrics.py:47-109).

    [batch, seq, dim] -> [batch, n_windows].  Truncates the sequence to
    a multiple of n_windows; n_windows > seq_len degrades to per-token
    windows; window_size 0 repeats the full-sequence ED."""
    if n_windows <= 0:
        raise ValueError("n_windows must be positive")
    x = as_device_f32(activations_batch, device)
    batch, seq_len, _ = x.shape
    n_windows = min(n_windows, seq_len)
    window_size = seq_len // n_windows
    if n_windows * window_size == 0:
        return compute_effective_dimensionality(x)[:, None].repeat(1, n_windows)
    ed = compute_effective_dimensionality(_windows(x, n_windows, window_size))
    return ed.reshape(n_windows, batch).transpose(0, 1)


def _mask_self(dist: torch.Tensor) -> torch.Tensor:
    """+inf on the diagonal of [batch, n, n] distances, the rest as is.
    tdax adds ``eye * inf``, which XLA folds under jit; computed eagerly,
    ``0 * inf`` is NaN off the diagonal, so the port writes the diagonal."""
    n = dist.shape[-1]
    eye = torch.eye(n, dtype=torch.bool, device=dist.device)
    return dist.masked_fill(eye, float("inf"))


def compute_intrinsic_dimensionality(data, discard_fraction: float = 0.1,
                                     eps: float = 1e-10, device=None) -> torch.Tensor:
    """TwoNN intrinsic dimensionality (reference metrics.py:112-208):
    mu = r2/r1 ratios, discard top fraction, zero-intercept regression of
    -log(1 - F_emp) on log(mu).  [batch, n, d] -> [batch] (NaN on failure)."""
    x = as_device_f32(data, device)
    batch, n, _ = x.shape
    if n <= 5:
        return torch.full((batch,), float("nan"), dtype=torch.float32, device=x.device)

    # difference form, as tdax: the expansion form quantizes nearby
    # distances, and mu is a ratio of nearest-neighbour distances
    dist = _mask_self(torch.cdist(x, x, compute_mode="donot_use_mm_for_euclid_dist"))
    r = torch.topk(dist, 2, dim=-1, largest=False).values
    r1, r2 = r[..., 0], r[..., 1]
    valid = (r1 > eps) & (r2 > eps)
    mu = torch.where(valid, r2 / torch.clamp(r1, min=eps), float("inf"))

    mu_sorted = torch.sort(mu, dim=1).values                  # inf (invalid) last
    n_valid = torch.isfinite(mu_sorted).sum(dim=1)            # [batch]
    # a float32 product, as tdax's: at n = 10 it gives 9, where float32
    # 0.9 multiplied in float64 (numpy's int32 * float32) gives 8
    keep_share = torch.tensor(1.0 - discard_fraction, dtype=torch.float32, device=x.device)
    n_keep = torch.clamp((n_valid.to(torch.float32) * keep_share).to(torch.int32), min=5)

    slot = torch.arange(n, device=x.device)[None, :]
    keep = slot < n_keep[:, None]
    f_emp = (slot + 1.0) / float(n)
    safe_mu = torch.where(keep, mu_sorted, 1.0)
    xr = torch.where(keep, torch.log(safe_mu + eps), 0.0)
    yr = torch.where(keep, -torch.log(1.0 - f_emp + eps), 0.0)

    k = torch.clamp(n_keep.to(torch.float32), min=1.0)
    mean_x = xr.sum(dim=1) / k
    mean_y = yr.sum(dim=1) / k
    var_x = torch.where(keep, (xr - mean_x[:, None]) ** 2, 0.0).sum(dim=1) / torch.clamp(
        k - 1, min=1.0)
    var_y = torch.where(keep, (yr - mean_y[:, None]) ** 2, 0.0).sum(dim=1) / torch.clamp(
        k - 1, min=1.0)

    num = (xr * yr).sum(dim=1)
    den = (xr * xr).sum(dim=1)
    slope = num / torch.where(den.abs() < eps, 1.0, den)

    ok = ((n_valid >= 5) & (var_x >= eps) & (var_y >= eps)
          & (den.abs() >= eps) & torch.isfinite(slope)
          & (slope > 0.0) & (slope < 1000.0))
    return torch.where(ok, slope, float("nan"))


def compute_fixed_window_id(activations_batch, n_windows: int, discard_fraction: float = 0.1,
                            device=None) -> torch.Tensor:
    """Windowed TwoNN (reference metrics.py:211-265): NaN when windows are
    too small (min 6 samples per window)."""
    x = as_device_f32(activations_batch, device)
    batch, seq_len, _ = x.shape
    nan = torch.full((batch, max(n_windows, 1)), float("nan"), dtype=torch.float32,
                     device=x.device)
    if n_windows <= 0 or seq_len < n_windows or seq_len < 6:
        return nan
    window_size = seq_len // n_windows
    if window_size < 6:
        return nan
    ids = compute_intrinsic_dimensionality(_windows(x, n_windows, window_size), discard_fraction)
    return ids.reshape(n_windows, batch).transpose(0, 1)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def compute_accuracy_by_example(gt_ids, pred_ids, token_labels,
                                accuracy_mode: str = "all") -> np.ndarray:
    """Per-example token accuracy keyed by 'ex<N>_answer' labels
    (reference metrics.py:268-342).  Host-side numpy."""
    gt = _host(gt_ids)
    pred = _host(pred_ids)
    batch_size = gt.shape[0]

    all_labels_str = " ".join(map(str, np.asarray(token_labels).flatten()))
    all_ints = [int(d) for d in re.findall(r"\d+", all_labels_str)]
    max_example_idx = max(all_ints) if all_ints else 0
    if max_example_idx == 0:
        return np.empty((batch_size, 0), dtype=np.float32)

    acc = np.full((batch_size, max_example_idx), np.nan, dtype=np.float32)
    for b in range(batch_size):
        labels = token_labels[b]
        for ex in range(1, max_example_idx + 1):
            mask = np.array([str(l) == f"ex{ex}_answer" for l in labels])
            if not mask.any():
                continue
            g, p = gt[b][mask], pred[b][mask]
            if g.size == 0:
                continue
            if accuracy_mode == "all":
                acc[b, ex - 1] = float(np.all(g == p))
            elif accuracy_mode == "first_token":
                acc[b, ex - 1] = float(g[0] == p[0])
            elif accuracy_mode == "token_wise":
                acc[b, ex - 1] = float(np.mean(g == p))
            else:
                raise ValueError(f"Invalid accuracy_mode: {accuracy_mode}")
    return acc


def matrix_entropy(matrix, alpha: float = 1.0, eps: float = 1e-10, device=None) -> torch.Tensor:
    """Matrix-based Renyi/Shannon entropy of the Gram spectrum
    (reference metrics.py:344-398).  [..., N, D] -> [...]."""
    z = as_device_f32(matrix, device)
    ev = torch.clamp(torch.linalg.eigvalsh(z @ z.transpose(-2, -1)), min=0.0)
    trace = ev.sum(dim=-1) + eps
    p = ev / trace[..., None]
    if abs(alpha - 1.0) < eps:
        return -torch.special.xlogy(p, p).sum(dim=-1)
    return torch.log(torch.pow(p, alpha).sum(dim=-1)) / (1.0 - alpha)
