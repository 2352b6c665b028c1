"""tdax_torch — the PyTorch/CUDA port of tdax.

It sits beside the JAX package ``tdax`` and computes the same things on
an NVIDIA H100: plain tensor code is PyTorch, and each Pallas TPU kernel
of ``tdax`` becomes a kernel written by hand for Hopper (CUDA C++ under
``tdax_torch/ops/csrc/``, built at first use into ``build/tdax_torch/``).

The port imports ``torch``, numpy and the standard library only — never
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
  - ``tdax_torch.metrics``         silhouette, persistence summaries
  - ``tdax_torch.viz``             diagram and evolution plots (matplotlib)
  - ``tdax_torch.pipeline``        extraction, the per-layer sweep, the scale path
"""

__version__ = "0.1.0"
