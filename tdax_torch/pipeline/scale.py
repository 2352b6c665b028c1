"""Large-cloud Vietoris-Rips, dense path (port of ``tdax/pipeline/scale.py:37-76``).

BASELINE.json configs[4]: 10k points, raw 4096-d, H0..H2 under a
threshold.  Division of labour:

  * the O(n^2 d) distance matrix on the card, through the hand-written
    kernel (``tdax_torch.ops.sqdist``, replacing tdax's Pallas
    ``_sqdist_kernel``), in the expansion form;
  * H0 on the card (Boruvka MST, ``tdax_torch.ops.rips.mst``) on the
    copy of the matrix already there;
  * H1/H2 in the native C++ cohomology engine on the host, with an
    explicit threshold (at 10k points the full complex has ~1.7e11
    triangles).

The sparse path (tdax's ``rips_at_scale_sparse``: kNN edge extraction
with refined edge values into the CSR engine) comes in a later slice.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from tdax_torch.ops.rips import rips_from_distances
from tdax_torch.ops.rips.mst import h0_diagram_device
from tdax_torch.ops.sqdist import euclidean
from tdax_torch.runtime import as_device_f32


def distance_matrix(x, device=None) -> torch.Tensor:
    """[n, d] -> [n, n] f32 Euclidean distances on the device (tdax's
    ``distance_matrix_tpu``, which returns the host copy).  Symmetrized
    exactly, (d + d^T) * 0.5 in f32, for the combinatorial engine."""
    d = euclidean(as_device_f32(x, device))
    d = d + d.T
    return d.mul_(0.5)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def rips_at_scale(x, maxdim: int = 2, thresh: float = np.inf, device=None) -> dict:
    """VR persistence of a large cloud: distances and H0 on the card, H1+
    in the native engine.  Returns {"dgms": [...], "timings": {stage: s}}
    (host clock; each device stage ends in a synchronise)."""
    timings = {}
    t = time.perf_counter()
    dist = distance_matrix(x, device)
    _sync(dist.device)
    timings["distance_s"] = time.perf_counter() - t

    t = time.perf_counter()
    dgm0 = h0_diagram_device(dist, thresh)
    timings["h0_s"] = time.perf_counter() - t
    if maxdim == 0:
        return {"dgms": [dgm0], "timings": timings}

    t = time.perf_counter()
    host = dist.cpu().numpy()
    del dist
    timings["to_host_s"] = time.perf_counter() - t
    t = time.perf_counter()
    result = rips_from_distances(host, maxdim=maxdim, thresh=thresh)
    timings["engine_s"] = time.perf_counter() - t
    # the on-device H0 replaces the engine's dim-0 output
    result["dgms"][0] = dgm0
    result["timings"] = timings
    return result
