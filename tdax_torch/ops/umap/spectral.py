"""Spectral initialization of the embedding (port of ``tdax/ops/umap/spectral.py``).

umap-learn initializes from the bottom eigenvectors of the symmetric
normalized Laplacian of the fuzzy graph, rescaled to max-abs 10, plus a
tiny Gaussian jitter.  At the sweep's cloud sizes a dense batched
``torch.linalg.eigh`` is exact.  On a disconnected graph the bottom
eigenvectors span component indicators, which separates components.

Eigenvectors are defined up to sign (and up to rotation where
eigenvalues repeat), and tdax's Threefry jitter cannot be reproduced
here: the jitter comes from a ``torch.Generator`` seeded with
``random_state``, drawn on the CPU so every device gets the same numbers.
Like tdax, which hands every layer the same key, every cloud of a batch
gets the same jitter.
"""

from __future__ import annotations

import torch


def spectral_embedding(w: torch.Tensor, n_components: int) -> torch.Tensor:
    """[..., n, n_components]: eigenvectors 1..n_components of the
    normalized Laplacian of ``w [..., n, n]``, scaled to max-abs 10."""
    n = w.shape[-1]
    deg = w.sum(-1)
    inv_sqrt = torch.where(deg > 0, 1.0 / torch.sqrt(deg.clamp_min(1e-12)), 0.0)
    eye = torch.eye(n, dtype=w.dtype, device=w.device)
    lap = eye - inv_sqrt[..., :, None] * w * inv_sqrt[..., None, :]
    # ascending eigenvalues; skip the trivial 0-eigenvector
    _, vecs = torch.linalg.eigh(lap)
    emb = vecs[..., :, 1:n_components + 1]
    expansion = 10.0 / emb.abs().amax((-2, -1), keepdim=True).clamp_min(1e-12)
    return emb * expansion


def _jitter(shape: tuple[int, int], random_state: int) -> torch.Tensor:
    """[n, n_components] standard normal draws from a seeded CPU generator."""
    gen = torch.Generator(device="cpu").manual_seed(int(random_state))
    return torch.randn(shape, generator=gen, dtype=torch.float32)


def spectral_init(w: torch.Tensor, n_components: int, random_state: int) -> torch.Tensor:
    """[..., n, n_components] spectral layout scaled to max-abs 10, plus
    1e-4 jitter, in f32."""
    emb = spectral_embedding(w, n_components)
    noise = _jitter(tuple(emb.shape[-2:]), random_state).to(emb.device, emb.dtype) * 1e-4
    return (emb + noise).to(torch.float32)
