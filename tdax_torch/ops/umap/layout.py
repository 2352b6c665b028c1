"""Epoch-synchronous UMAP layout, dense small-n path (port of
``tdax/ops/umap/layout.py``).

umap-learn's ``optimize_layout_euclidean`` semantics: per-edge sampling
schedules (epochs_per_sample), attractive gradient
-2ab d^(2b-2) / (1 + a d^2b), repulsive gradient
2 gamma b / ((0.001 + d^2)(1 + a d^2b)), per-dimension clip to [-4, 4],
alpha decaying linearly to 0.  As in tdax, each epoch computes every
active gradient against the epoch-start embedding and applies one
mean-force update, and negative sampling is applied in exact
expectation (mean-field) over all tails, so the loop has no RNG.  The
umap quirks tdax keeps are kept: a zero-distance draw of the head
vertex itself is skipped, any other zero-distance draw gives the +4
kick, edges below max_weight / n_epochs are pruned, schedules start at
epochs_per_sample.

The loop over epochs is a Python loop over tensors with a leading batch
of clouds (``[..., n, d]``): one set of launches per epoch for all the
sweep's layers.  Scalar constants are rounded to f32 as tdax's traced
f32 arithmetic rounds them.
"""

from __future__ import annotations

import numpy as np
import torch


def make_epochs_per_sample(weights: torch.Tensor, n_epochs: int) -> torch.Tensor:
    """umap's make_epochs_per_sample on dense weights [..., nh, nt]; inf = never."""
    wmax = weights.amax((-2, -1), keepdim=True)
    n_samples = n_epochs * (weights / wmax.clamp_min(1e-30))
    return torch.where(n_samples > 0, n_epochs / n_samples.clamp_min(1e-30), float("inf"))


def _f32(v) -> float:
    return float(np.float32(v))


def _epoch_forces(head, tail, graph_active, n_neg, a, b, gamma):
    """(head_force, head_count, tail_force, tail_count) for one epoch.

    head [..., nh, d], tail [..., nt, d]: epoch-start embeddings.
    graph_active [..., nh, nt] bool; n_neg [..., nh, nt] f32 owed
    negative draws per edge (0 where inactive).  Counts are the number
    of contributing micro-updates; the caller takes the mean force.
    Repulsion in expectation over uniform tail draws:
    E[force_i] = (M_i S_i - 4 Z_i) / nt, with S_i the per-pair repulsive
    gradients (kicks included) summed over the tails, M_i = sum_j n_neg,
    and Z_i = M_i [d2(i, i) = 0, i < nt] removing the skipped self-draw.
    """
    nh, nt = head.shape[-2], tail.shape[-2]
    a32, b32, g32 = np.float32(a), np.float32(b), np.float32(gamma)
    diff = head[..., :, None, :] - tail[..., None, :, :]          # [..., nh, nt, d]
    d2 = (diff * diff).sum(-1)
    d2c = d2.clamp_min(1e-12)
    pd2b = torch.pow(d2c, float(b32))
    denom = float(a32) * pd2b + 1.0

    # attractive
    att_coeff = torch.where(d2 > 0.0, (_f32(np.float32(-2.0) * a32 * b32) * pd2b / d2c) / denom,
                            0.0)
    att_grad = (att_coeff[..., None] * diff).clamp(-4.0, 4.0)
    att_grad = torch.where(graph_active[..., None], att_grad, 0.0)
    head_force = att_grad.sum(-2)
    tail_force = -att_grad.sum(-3)
    head_count = graph_active.sum(-1).to(head.dtype)
    tail_count = graph_active.sum(-2).to(head.dtype)

    # repulsive, in expectation over uniform tail draws
    rep_coeff = _f32(np.float32(2.0) * g32 * b32) / ((0.001 + d2) * denom)
    rep_grad = (rep_coeff[..., None] * diff).clamp(-4.0, 4.0)
    zero_d = d2 <= 0.0
    rep_grad = torch.where(zero_d[..., None], 4.0, rep_grad)   # +4 kick
    s_i = rep_grad.sum(-2)
    m_i = n_neg.sum(-1)
    i = torch.arange(nh, device=head.device)
    self_zero = zero_d[..., i, i.clamp_max(nt - 1)] & (i < nt)
    z_i = m_i * self_zero.to(head.dtype)
    head_force = head_force + (m_i[..., None] * s_i - 4.0 * z_i[..., None]) / nt
    head_count = head_count + m_i - z_i / nt
    return head_force, head_count, tail_force, tail_count


def optimize_layout(head_embedding: torch.Tensor, tail_embedding: torch.Tensor,
                    graph: torch.Tensor, n_epochs: int, a: float, b: float,
                    gamma: float = 1.0, initial_alpha: float = 1.0,
                    negative_sample_rate: int = 5, move_other: bool = True) -> torch.Tensor:
    """Optimize head_embedding [..., nh, d] against tail_embedding [..., nt, d].

    graph[..., i, j] > 0 is a directed edge pulling head i toward tail j.
    move_other=True is fit mode (head and tail are one embedding: pass
    the same tensor); move_other=False is transform mode, tails fixed."""
    wmax = graph.amax((-2, -1), keepdim=True)
    graph = torch.where(graph < wmax / n_epochs, 0.0, graph)
    eps_mat = make_epochs_per_sample(graph, n_epochs)
    epns_mat = eps_mat / negative_sample_rate
    edge_mask = torch.isfinite(eps_mat)
    eons = torch.where(edge_mask, eps_mat, float("inf"))
    eonns = torch.where(edge_mask, epns_mat, float("inf"))

    emb = head_embedding.to(torch.float32)
    tail_fixed = tail_embedding.to(torch.float32)
    alpha0, n_ep = np.float32(initial_alpha), np.float32(n_epochs)
    for epoch in range(n_epochs):
        tail = emb if move_other else tail_fixed
        e = np.float32(epoch)
        alpha = float(alpha0 * (np.float32(1.0) - e / n_ep))

        active = edge_mask & (eons <= float(e))
        n_neg = torch.where(active, (float(e) - eonns) / epns_mat, 0.0)
        n_neg = torch.trunc(n_neg)  # tdax's cast to int32 and back
        head_force, head_count, tail_force, tail_count = _epoch_forces(
            emb, tail, active, n_neg, a, b, gamma)

        if move_other:
            count = (head_count + tail_count).clamp_min(1.0)
            emb = emb + (head_force + tail_force) / count[..., None] * alpha
        else:
            emb = emb + head_force / head_count.clamp_min(1.0)[..., None] * alpha

        eons = torch.where(active, eons + eps_mat, eons)
        eonns = torch.where(active, eonns + n_neg * epns_mat, eonns)
    return emb
