"""Public Rips API, ripser-compatible (port of ``tdax/ops/rips/api.py``).

``rips(X, maxdim=1)``: a point cloud in, ``{"dgms": [(k, 2) float arrays,
one per dimension, np.inf deaths for essential classes]}`` out, with Z/2
coefficients (ripser's default).  Backends, as tdax's:
  * ``"native"``: the C++ cohomology engine in ``cpp/`` (maxdim <= 3);
  * ``"python"``: the numpy oracle, ``tdax_torch.ops.rips.reference``;
  * ``"auto"``: native up to maxdim 3, the oracle above it.
Where tdax's ``"auto"`` also takes the oracle when the engine is not
built, the port's raises with g++'s output: a failed build is a fault
to see, not a slower answer.
"""

from __future__ import annotations

import numpy as np

from tdax_torch.ops.distances import pairwise_cosine_np, pairwise_euclidean_np
from tdax_torch.ops.rips.reference import rips_reference


def rips_from_distances(dist: np.ndarray, maxdim: int = 1, thresh: float = np.inf,
                        coeff: int = 2, backend: str = "auto") -> dict:
    if coeff != 2:
        raise NotImplementedError("only Z/2 coefficients are supported (ripser default)")
    # float32 inputs stay float32 (the native engine has an exact f32 path);
    # everything else runs in float64
    keep = np.float32 if np.asarray(dist).dtype == np.float32 else np.float64
    dist = np.ascontiguousarray(dist, dtype=keep)
    if backend == "auto":
        # the native engine's fixed vertex buffers cap it at maxdim 3
        backend = "native" if maxdim <= 3 else "python"
    if backend == "native":
        from tdax_torch.ops.rips.native import rips_native
        dgms = rips_native(dist, maxdim=maxdim, thresh=thresh)
    elif backend == "python":
        dgms = rips_reference(dist, maxdim=maxdim, thresh=thresh)
    else:
        raise ValueError(f"unknown backend {backend!r}")
    return {"dgms": [np.asarray(d, dtype=np.float64).reshape(-1, 2) for d in dgms]}


def rips(x: np.ndarray, maxdim: int = 1, thresh: float = np.inf, coeff: int = 2,
         metric: str = "euclidean", backend: str = "auto") -> dict:
    """Vietoris-Rips persistence of a point cloud.

    Distances are computed in float64 (Euclidean in difference form),
    then rounded to float32 and back (ripser casts its input to float32),
    so diagram values agree with ripser's to float32 round-off."""
    x = np.asarray(x)
    if metric == "euclidean":
        dist = pairwise_euclidean_np(x)
    elif metric == "cosine":
        dist = pairwise_cosine_np(x)
    else:
        raise ValueError(f"unknown metric {metric!r}")
    dist = dist.astype(np.float32).astype(np.float64)
    return rips_from_distances(dist, maxdim=maxdim, thresh=thresh, coeff=coeff,
                               backend=backend)
