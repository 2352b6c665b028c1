"""Silhouette score in PyTorch (port of ``tdax/metrics/silhouette.py``).

sklearn.metrics.silhouette_score as the reference uses it
(debug_tda_pipeline.py:117-118): mean silhouette over samples,
Euclidean metric.  ``silhouette`` takes a leading batch of clouds, so
every layer of the sweep is scored against one label set in one call.
"""

from __future__ import annotations

import numpy as np
import torch


def silhouette(x: torch.Tensor, labels: torch.Tensor, n_classes: int) -> torch.Tensor:
    """x [..., n, d] float, labels [n] int in [0, n_classes) -> [...] scores."""
    diff = x[..., :, None, :] - x[..., None, :, :]
    dist = (diff * diff).sum(-1).clamp_min(0.0).sqrt()

    onehot = torch.nn.functional.one_hot(labels.long(), n_classes).to(x.dtype)   # [n, C]
    counts = onehot.sum(0)                                                         # [C]
    sums = dist @ onehot                                                           # [..., n, C]

    own_count = counts[labels]                                                     # [n]
    own_sum = sums.gather(-1, labels.long().expand(*sums.shape[:-1])[..., None])[..., 0]
    # a(i): mean intra-cluster distance excluding self
    a = torch.where(own_count > 1, own_sum / (own_count - 1).clamp_min(1), 0.0)

    # b(i): min over the other clusters of the mean distance
    mean_other = sums / counts.clamp_min(1)
    is_own = onehot.bool()
    mean_other = torch.where(is_own | (counts == 0), float("inf"), mean_other)
    b = mean_other.amin(-1)

    s = torch.where(own_count > 1, (b - a) / torch.maximum(a, b).clamp_min(1e-30), 0.0)
    return s.mean(-1)


def encode_labels(labels) -> tuple[np.ndarray, int]:
    """String/object labels -> (int codes in sorted-unique order, class count)."""
    uniq, enc = np.unique(np.asarray(labels), return_inverse=True)
    return enc.astype(np.int64), len(uniq)


def silhouette_score(x, labels, device=None) -> float:
    """sklearn-compatible entry: one cloud, string/object labels (placed
    by ``runtime.as_device_f32``)."""
    from tdax_torch.runtime import as_device_f32

    xt = as_device_f32(x, device)
    enc, n_classes = encode_labels(labels)
    if n_classes < 2 or n_classes >= len(enc):
        raise ValueError("silhouette requires 2 <= n_labels <= n_samples - 1")
    return float(silhouette(xt, torch.as_tensor(enc, device=xt.device), n_classes))
