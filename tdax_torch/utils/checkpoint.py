"""Parameter and training-state checkpoints (port of ``tdax/utils/checkpoint.py``).

Flat ``.npz`` files with tdax's keys: a nested dict's leaf ``a/b/c``
under the key ``"a/b/c"``, layer weights stacked [n_layers, ...].  numpy
cannot hold bfloat16, so such a leaf is stored as its flat byte view
with ``[dtype name, shape]`` recorded under tdax's ``__tdax_dtypes__``
manifest key, exactly as tdax stores it: tdax's ``load_params`` reads
the port's params (and the ``p/`` subtree of a training state), and the
port reads tdax's.  tdax's orbax branch (sharded trees in a directory)
is not ported.

The training state is one file written atomically (a temporary file,
then ``os.replace``): params under ``p/``, the optimizer state under
``o/`` (``OptState.to_flat``: the AdamW moments ``o/mu/...`` and
``o/nu/...`` in the params' stacked layout and the update count
``o/count``) and ``step``.  Reading it back gives the same bits.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

_DTYPE_MANIFEST_KEY = "__tdax_dtypes__"
_BYTE_DTYPES = {"bfloat16": torch.bfloat16}


def _pack(leaf) -> tuple[np.ndarray, list | None]:
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf), None
    t = leaf.detach().cpu().contiguous()
    for name, dtype in _BYTE_DTYPES.items():
        if t.dtype == dtype:
            return t.reshape(-1).view(torch.uint8).numpy(), [name, list(t.shape)]
    return t.numpy(), None


def _unpack(arr: np.ndarray, entry) -> torch.Tensor:
    if entry is None:
        return torch.from_numpy(np.array(arr))  # a copy, writable
    if not isinstance(entry, list) or len(entry) != 2 or entry[0] not in _BYTE_DTYPES:
        raise ValueError(f"checkpoint leaf with manifest entry {entry!r} cannot be read by "
                         f"the port (it reads [dtype name, shape] for {sorted(_BYTE_DTYPES)})")
    name, shape = entry
    return torch.from_numpy(np.array(arr, dtype=np.uint8)).view(_BYTE_DTYPES[name]).reshape(shape)


def _flatten(tree: dict, prefix: str, out: dict) -> dict:
    for name, node in tree.items():
        if isinstance(node, dict):
            _flatten(node, f"{prefix}{name}/", out)
        else:
            out[f"{prefix}{name}"] = node
    return out


def _insert(tree: dict, key: str, value) -> None:
    parts = key.split("/")
    for part in parts[:-1]:
        tree = tree.setdefault(part, {})
    tree[parts[-1]] = value


def _savez_atomic(path: str, flat: dict) -> None:
    """``path`` (ending in .npz) written through a temporary file."""
    packed, manifest = {}, {}
    for key, leaf in flat.items():
        packed[key], entry = _pack(leaf)
        if entry is not None:
            manifest[key] = entry
    packed[_DTYPE_MANIFEST_KEY] = np.frombuffer(json.dumps(manifest).encode(), dtype=np.uint8)
    tmp = path[: -len(".npz")] + ".tmp.npz"
    np.savez(tmp, **packed)
    os.replace(tmp, path)


def _read(path: str) -> dict:
    """Every leaf of an .npz as a CPU tensor (step and friends included)."""
    with np.load(path) as z:
        manifest = (json.loads(bytes(z[_DTYPE_MANIFEST_KEY]).decode())
                    if _DTYPE_MANIFEST_KEY in z.files else {})
        return {key: _unpack(z[key], manifest.get(key))
                for key in z.files if key != _DTYPE_MANIFEST_KEY}


def save_params(path: str, params: dict) -> None:
    """``params`` to ``path + ".npz"``, tdax's flat layout."""
    _savez_atomic(path + ".npz", _flatten(params, "", {}))


def load_params(path: str) -> dict:
    """Inverse of ``save_params`` (also reads tdax's ``.npz`` params):
    the nested dict of CPU tensors."""
    tree: dict = {}
    for key, t in _read(path + ".npz").items():
        _insert(tree, key, t)
    return tree


def save_train_state(path: str, params: dict, opt_state, step: int) -> None:
    """Crash-resumable training checkpoint: params, optimizer state and
    step in ``path + ".npz"``, written atomically."""
    flat = _flatten(params, "p/", {})
    flat.update({f"o/{key}": value for key, value in opt_state.to_flat().items()})
    flat["step"] = np.asarray(step, dtype=np.int64)
    _savez_atomic(path + ".npz", flat)


def load_train_state(path: str, optimizer, device) -> tuple[dict, object, int]:
    """Inverse of ``save_train_state``: (params on ``device``, the
    optimizer state ``optimizer.init(params)`` with the saved moments and
    count, step)."""
    params: dict = {}
    opt_flat = {}
    step = 0
    for key, t in _read(path + ".npz").items():
        if key == "step":
            step = int(t)
        elif key.startswith("p/"):
            _insert(params, key[2:], t.to(device))
        elif key.startswith("o/"):
            opt_flat[key[2:]] = t
    opt_state = optimizer.init(params)
    opt_state.load_flat(opt_flat)
    return params, opt_state, step
