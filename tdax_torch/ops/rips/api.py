"""Public Rips API, ripser-compatible (port of ``tdax/ops/rips/api.py``).

``rips(X, maxdim=1)``: Euclidean point cloud in, ``{"dgms": [(k, 2)
float arrays, one per dimension, np.inf deaths for essential classes]}``
out, with Z/2 coefficients (ripser's default).  The port runs the native
C++ engine only; tdax's python oracle and batched device reduction come
in a later slice.
"""

from __future__ import annotations

import numpy as np

from tdax_torch.ops.distances import pairwise_euclidean_np


def rips_from_distances(dist: np.ndarray, maxdim: int = 1, thresh: float = np.inf) -> dict:
    if maxdim > 3:
        raise NotImplementedError("the native engine stops at maxdim 3; the python oracle "
                                  "for higher dimensions is not in the port yet")
    from tdax_torch.ops.rips.native import rips_native

    # float32 inputs stay float32 (the native engine has an exact f32 path);
    # everything else runs in float64
    keep = np.float32 if np.asarray(dist).dtype == np.float32 else np.float64
    dist = np.ascontiguousarray(dist, dtype=keep)
    dgms = rips_native(dist, maxdim=maxdim, thresh=thresh)
    return {"dgms": [np.asarray(d, dtype=np.float64).reshape(-1, 2) for d in dgms]}


def rips(x: np.ndarray, maxdim: int = 1) -> dict:
    """Vietoris-Rips persistence of a Euclidean point cloud.

    Distances are computed in float64 difference form, then rounded to
    float32 and back (ripser casts its input to float32), so diagram
    values agree with ripser's to float32 round-off."""
    dist = pairwise_euclidean_np(np.asarray(x)).astype(np.float32).astype(np.float64)
    return rips_from_distances(dist, maxdim=maxdim)
