"""Activation / metadata IO (port of ``tdax/data/io.py``).

Two formats with tdax's schemas:
  * ``.pt``: the reference's nested dict ``{sample_id: {"metadata":
    item, "activations": {"layer_i": Tensor[hidden]}}}``;
  * ``.npz``: ``activations`` as one ``[n_layers, n_samples, hidden]``
    array, ``sample_ids``, and the metadata as JSON (``metadata_json``).
"""

from __future__ import annotations

import json
from typing import Any

import numpy as np
import torch


def load_metadata(path: str) -> list[dict]:
    with open(path) as f:
        return json.load(f)


def save_activations_npz(path: str, activations: np.ndarray,
                         sample_ids: list[str], metadata: list[dict]) -> None:
    """Save ``[n_layers, n_samples, hidden]`` activations + aligned metadata."""
    if activations.ndim != 3:
        raise ValueError(f"expected [n_layers, n_samples, hidden], got {activations.shape}")
    if activations.shape[1] != len(sample_ids):
        raise ValueError("sample_ids length must match activations' sample axis")
    np.savez_compressed(
        path,
        activations=activations,
        sample_ids=np.array(sample_ids),
        metadata_json=np.array(json.dumps(metadata)),
    )


def load_activations_npz(path: str) -> tuple[np.ndarray, list[str], list[dict]]:
    with np.load(path, allow_pickle=False) as z:
        acts = z["activations"]
        ids = [str(s) for s in z["sample_ids"]]
        metadata = json.loads(str(z["metadata_json"]))
    return acts, ids, metadata


def save_activations(path: str, activations: np.ndarray,
                     sample_ids: list[str], metadata: list[dict]) -> None:
    """The reference's nested-dict ``.pt`` schema (one CPU tensor per
    sample and layer)."""
    meta_by_id = {m["id"]: m for m in metadata}
    results = {}
    for j, sid in enumerate(sample_ids):
        results[sid] = {
            "metadata": meta_by_id[sid],
            "activations": {f"layer_{i}": torch.from_numpy(np.array(activations[i, j]))
                            for i in range(activations.shape[0])},
        }
    torch.save(results, path)


def dump_json(obj: Any, path: str) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=2)
