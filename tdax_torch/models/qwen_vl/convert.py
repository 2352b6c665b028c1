"""Parameters from a tree of numpy arrays.

``params_from_numpy`` takes a tdax-layout parameter tree whose leaves
are numpy arrays (for example ``jax.tree.map(np.asarray,
tdax.models.qwen_vl.init_params(...))``: [in, out] weights, layer
weights stacked [n_layers, ...]) and returns the port's parameters: the
same tree of tensors on ``device`` in ``dtype``.  The port keeps tdax's
layout, so this is a leaf-by-leaf copy and both packages compute the
same function of the same numbers.

The Hugging Face checkpoint loader (tdax's ``convert.py``) waits until
the checkpoint files are in the repository.
"""

from __future__ import annotations

import numpy as np
import torch

from tdax_torch.models.qwen_vl.model import torch_dtype


def params_from_numpy(tree: dict, device, dtype) -> dict:
    """Nested dict of numpy arrays -> the same nested dict of tensors."""
    dtype = torch_dtype(dtype)
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            out[name] = params_from_numpy(leaf, device, dtype)
        else:
            arr = np.asarray(leaf, dtype=np.float32)
            out[name] = torch.from_numpy(arr.copy()).to(device=device, dtype=dtype)
    return out
