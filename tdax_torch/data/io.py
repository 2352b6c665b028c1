"""Activation / metadata IO (port of ``tdax/data/io.py``).

Two formats with tdax's schemas:
  * ``.pt``: the reference's nested dict ``{sample_id: {"metadata":
    item, "activations": {"layer_i": Tensor[hidden]}}}``;
  * ``.npz``: ``activations`` as one ``[n_layers, n_samples, hidden]``
    array, ``sample_ids``, and the metadata as JSON (``metadata_json``).
"""

from __future__ import annotations

import json
import os
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


def load_activations_pt(path: str) -> dict[str, dict]:
    data = torch.load(path, map_location="cpu", weights_only=False)
    out: dict[str, dict] = {}
    for sid, entry in data.items():
        out[sid] = {
            "metadata": entry["metadata"],
            "activations": {name: np.asarray(t, dtype=np.float64)
                            for name, t in entry["activations"].items()},
        }
    return out


def load_activations(path: str) -> dict[str, dict]:
    """Load either format into the reference's nested-dict schema
    (activation vectors as float64 numpy arrays)."""
    if not path.endswith(".npz"):
        return load_activations_pt(path)
    acts, ids, metadata = load_activations_npz(path)
    meta_by_id = {m["id"]: m for m in metadata}
    return {sid: {"metadata": meta_by_id[sid],
                  "activations": {f"layer_{i}": np.asarray(acts[i, j], dtype=np.float64)
                                  for i in range(acts.shape[0])}}
            for j, sid in enumerate(ids)}


def activations_to_layer_clouds(all_data: dict[str, dict], n_layers: int,
                                point_cloud_type: str | None = "bound"
                                ) -> tuple[np.ndarray, list[str]]:
    """Stack per-sample activation dicts into ``[n_layers, n, hidden]`` clouds,
    sorted sample ids filtered by metadata ``type`` (debug_tda_pipeline.py:46-65)."""
    ids = sorted(sid for sid, entry in all_data.items()
                 if point_cloud_type is None or entry["metadata"].get("type") == point_cloud_type)
    clouds = np.stack([
        np.stack([np.asarray(all_data[sid]["activations"][f"layer_{i}"], dtype=np.float64)
                  for sid in ids])
        for i in range(n_layers)
    ])
    return clouds, ids


def ensure_dir(path: str) -> str:
    os.makedirs(path, exist_ok=True)
    return path


def dump_json(obj: Any, path: str) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=2)
