"""Parameters from a tree of numpy arrays.

``params_from_numpy`` takes a tdax-layout parameter tree whose leaves
are numpy arrays (for example ``jax.tree.map(np.asarray,
tdax.models.qwen_vl.init_params(...))``: [in, out] weights, layer
weights stacked [n_layers, ...]) and returns the port's parameters: the
same tree of tensors on ``device`` in ``dtype``.  The port keeps tdax's
layout, so this is a leaf-by-leaf copy and both packages compute the
same function of the same numbers.

An int8 tree (tdax's ``quantize_params`` or ``init_params_quantized``)
crosses as it is: int8 leaves stay int8, and the scales of a
``{"q", "s"}`` node stay f32 whatever the model dtype, as tdax keeps
them.  Every leaf owns its storage (a contiguous copy of the input), so
it can be trained: the training step updates it in place.

``params_to_numpy`` is the inverse, into tdax's layout: float leaves as
float32 arrays (numpy has no bfloat16), int8 leaves as int8.

The Hugging Face checkpoint loader (tdax's ``convert.py``) waits until
the checkpoint files are in the repository.
"""

from __future__ import annotations

import numpy as np
import torch

from tdax_torch.models.qwen_vl.model import torch_dtype
from tdax_torch.models.qwen_vl.quantize import is_quantized


def params_from_numpy(tree: dict, device, dtype) -> dict:
    """Nested dict of numpy arrays -> the same nested dict of tensors."""
    dtype = torch_dtype(dtype)
    out = {}
    for name, leaf in tree.items():
        if is_quantized(leaf):
            out[name] = {"q": _tensor(leaf["q"], np.int8, device, torch.int8),
                         "s": _tensor(leaf["s"], np.float32, device, torch.float32)}
        elif isinstance(leaf, dict):
            out[name] = params_from_numpy(leaf, device, dtype)
        elif np.asarray(leaf).dtype == np.int8:
            out[name] = _tensor(leaf, np.int8, device, torch.int8)
        else:
            out[name] = _tensor(leaf, np.float32, device, dtype)
    return out


def _tensor(leaf, np_dtype, device, dtype: torch.dtype) -> torch.Tensor:
    arr = np.array(leaf, dtype=np_dtype)  # a copy, writable
    return torch.from_numpy(arr).to(device=device, dtype=dtype).contiguous()


def params_to_numpy(tree: dict) -> dict:
    """Nested dict of tensors -> the same nested dict of numpy arrays."""
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            out[name] = params_to_numpy(leaf)
        else:
            t = leaf.detach().cpu()
            out[name] = np.array((t if t.dtype == torch.int8 else t.float()).numpy())  # a copy
    return out
