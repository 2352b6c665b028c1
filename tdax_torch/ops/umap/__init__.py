"""UMAP in PyTorch (port of ``tdax.ops.umap``).

Cosine/euclidean kNN, smooth-kNN sigma calibration, fuzzy simplicial
set, spectral initialization and tdax's epoch-synchronous mean-field
layout, batched over a leading axis of clouds so the 32-layer sweep
runs as one set of launches per stage; past 2048 points the edge-list
path (``sparse_path.py``: blocked kNN, COO symmetrization, LOBPCG
spectral init, edge-list SGD layout and transform).
"""

from tdax_torch.ops.umap.umap import UMAP, fit_transform_batched, shared_transform_batched

__all__ = ["UMAP", "fit_transform_batched", "shared_transform_batched"]
