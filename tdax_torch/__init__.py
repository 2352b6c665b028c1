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
  - ``tdax_torch.config``          dataset / extraction configs
  - ``tdax_torch.data``            dataset generator, activation IO
  - ``tdax_torch.models.qwen_vl``  Qwen-VL-Chat forward and capture
  - ``tdax_torch.ops``             flash attention (CUDA kernel + plain version)
  - ``tdax_torch.pipeline``        batched activation extraction
"""

__version__ = "0.1.0"
