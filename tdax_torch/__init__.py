"""tdax_torch — the PyTorch/CUDA port of tdax.

It sits beside the JAX package ``tdax`` and computes the same things on
an NVIDIA H100: plain tensor code is PyTorch, and each Pallas TPU kernel
of ``tdax`` becomes a kernel written by hand for Hopper (CUDA C++ under
``tdax_torch/ops/csrc/``, built at first use into ``build/tdax_torch/``).

The port imports ``torch``, numpy, scipy, Pillow and the standard
library, and matplotlib only when a plot is drawn — never
``jax`` and nothing of ``tdax``; it keeps its own copies of the JAX-free
pieces it needs.  Its entry points run on the card unless the caller
passes ``device="cpu"`` (see ``tdax_torch.runtime.get_device``).

Layout mirrors ``tdax/``:
  - ``tdax_torch.config``          dataset / extraction / UMAP / Rips / sweep configs
  - ``tdax_torch.data``            dataset generator, activation IO
  - ``tdax_torch.models.qwen_vl``  Qwen-VL-Chat forward and capture
  - ``tdax_torch.ops``             flash attention and pairwise distances (CUDA
                                   kernels + plain versions), dense UMAP, Rips
                                   (native engine binding, Boruvka H0)
  - ``tdax_torch.metrics``         silhouette, persistence summaries and distances,
                                   geometry metrics
  - ``tdax_torch.viz``             diagram and evolution plots (matplotlib), 3-D HTML
  - ``tdax_torch.pipeline``        extraction, the per-layer sweep, the scale path,
                                   the peak-layer HTML and the legacy sweep
"""

__version__ = "0.1.0"


# Top-level convenience names, resolved on first use so that
# ``import tdax_torch`` stays light (no scipy.optimize, no matplotlib,
# no kernel build)
def __getattr__(name):
    if name == "rips":
        from tdax_torch.ops.rips import rips
        return rips
    if name == "UMAP":
        from tdax_torch.ops.umap import UMAP
        return UMAP
    if name == "silhouette_score":
        from tdax_torch.metrics import silhouette_score
        return silhouette_score
    if name == "bottleneck_distance":
        from tdax_torch.metrics import bottleneck_distance
        return bottleneck_distance
    if name == "wasserstein_distance":
        from tdax_torch.metrics import wasserstein_distance
        return wasserstein_distance
    raise AttributeError(f"module 'tdax_torch' has no attribute {name!r}")
