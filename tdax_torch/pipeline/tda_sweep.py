"""Per-layer UMAP + persistence sweep (port of ``tdax/pipeline/tda_sweep.py``).

The reference's main analysis loop (debug_tda_pipeline.py:92-150):

  1. embed every layer cloud (UMAP, 4096-d -> 3-d) with the layer axis
     as a leading batch dimension, on the card;
  2. score every layer against the shape and colour labels (silhouette),
     in the same batched calls;
  3. Vietoris-Rips H0/H1 per layer in the native C++ engine, in a thread
     pool (ctypes releases the GIL), or the whole batch on the device with
     ``RipsConfig(backend="device")``.

Artifacts and JSON schemas are tdax's (and the reference's):
point_clouds_3d/layer_i_cloud.npy, diagrams/layer_i_diagram.png,
summary_stats.json, summary_evolution_plot.png, and both peak rules
(shape-silhouette argmax, debug_tda_pipeline.py:195; max-H1 argmax,
analyze_tda_over_layers.py:126).
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import json
import os
import shutil
import time

import numpy as np
import torch

from tdax_torch.config import SweepConfig
from tdax_torch.data.io import activations_to_layer_clouds, dump_json, ensure_dir, load_metadata
from tdax_torch.metrics.persistence import diagram_stats
from tdax_torch.metrics.silhouette import encode_labels, silhouette
from tdax_torch.ops.rips import rips
from tdax_torch.ops.umap.umap import (UMAP, _default_epochs, _prepare, _transform_epochs,
                                      batched_embed, batched_shared_embed)
from tdax_torch.parallel.mesh import barrier, is_writer
from tdax_torch.runtime import as_device_f32
from tdax_torch.utils.log import log_event


def batched_silhouettes(clouds, label_sets: dict[str, list[str]],
                        device=None) -> dict[str, np.ndarray]:
    """Silhouette of every layer cloud [L, n, d] against every label set."""
    cs = as_device_f32(clouds, device)
    out = {}
    for name, labels in label_sets.items():
        enc, n_classes = encode_labels(labels)
        out[name] = silhouette(cs, torch.as_tensor(enc, device=cs.device), n_classes).cpu().numpy()
    return out


def embed_layers(clouds, cfg: SweepConfig, device=None) -> torch.Tensor:
    """[L, n, D] -> [L, n, 3] f32 on the device, in the configured reducer
    mode; the per-layer mode is batched and dense at any n, as tdax's.
    Under a process group whose size divides L the per-layer mode and
    the dense shared mode split the layers over its ranks and gather
    them (collective: every rank calls it with the same stack); the
    shared mode past the sparse threshold runs whole on every rank, as
    tdax's does."""
    ucfg, cs, n, k, (a, b) = _prepare(clouds, cfg.umap, None, device)
    if cfg.reducer_mode == "per_layer":
        return batched_embed(cs, ucfg, k, _default_epochs(n, ucfg.n_epochs), a, b)
    if cfg.reducer_mode == "shared":
        # fit on the LAST layer, transform every layer (same "camera"),
        # analyze_tda_over_layers.py:65-72: batched at dense sizes, a
        # serial fit/transform loop on the edge list past the threshold
        if n <= UMAP.sparse_threshold:
            return batched_shared_embed(cs, ucfg, k, _default_epochs(n, ucfg.n_epochs),
                                        _transform_epochs(ucfg.n_epochs, n), a, b)
        reducer = UMAP.from_config(ucfg, device=cs.device)
        reducer.n_neighbors = k
        reducer.fit(cs[-1])
        return torch.stack([torch.as_tensor(reducer.transform(c)) for c in cs]).to(cs.device)
    raise ValueError(f"unknown reducer_mode {cfg.reducer_mode!r}")


def embed_and_silhouettes(clouds, cfg: SweepConfig, label_sets: dict[str, list[str]],
                          device=None) -> tuple[np.ndarray, dict[str, np.ndarray]]:
    """Stages 1 + 2: the embedding of every layer and every layer x
    label-set silhouette, computed on the device; one copy of the
    results to the host.  A tensor stack is used where it lies (a stack
    on the card makes no host round trip)."""
    # row-major whatever the path (the layout inherits eigh's column-major
    # vectors, a gather over ranks returns rows): the silhouettes' sums,
    # and so the stats, then round alike, and the .npy clouds are
    # C-ordered as tdax's
    embs = embed_layers(clouds, cfg, device).contiguous()
    sils = batched_silhouettes(embs, label_sets)
    return embs.cpu().numpy().astype(np.float32), sils


def persistence_per_layer(clouds_3d: np.ndarray, maxdim: int = 1, backend: str = "auto",
                          max_workers: int | None = None, device=None) -> list[list[np.ndarray]]:
    """VR diagrams of each layer cloud.

    ``backend="device"`` reduces the whole batch on the device
    (``ops.rips.tiny_device.rips_tiny_batched``, on ``device``: the card
    unless the caller asks for the CPU) and lets its errors through.
    Every other backend runs ``rips`` per layer in a thread pool (ctypes
    releases the GIL); ``"auto"`` is the native engine there.  tdax's
    ``"auto"`` takes the device batch only when no native engine is built
    (``TDAX_NO_DEVICE_PH=1`` forbids even that); the port's native engine
    is built or raises, so its ``"auto"`` never takes it."""
    n_layers = clouds_3d.shape[0]
    if backend == "device":
        from tdax_torch.ops.rips.tiny_device import rips_tiny_batched
        return rips_tiny_batched(clouds_3d, maxdim=maxdim, device=device)

    max_workers = max_workers or min(n_layers, os.cpu_count() or 8)

    def one(i: int):
        return rips(np.asarray(clouds_3d[i], dtype=np.float64), maxdim=maxdim,
                    backend=backend)["dgms"]

    with cf.ThreadPoolExecutor(max_workers=max_workers) as pool:
        return list(pool.map(one, range(n_layers)))


def run_tda_sweep(all_data: dict[str, dict], metadata_path: str,
                  cfg: SweepConfig | None = None, verbose: bool = True, device=None) -> dict:
    """Full sweep; returns {"stats": [...], "peak_layer": int,
    "clouds_3d": [L, n, 3], "diagrams": [...], "sample_ids": [...],
    "timings": {stage: s}} and writes the artifact tree.  Runs on the
    card unless ``device="cpu"``.  With ``cfg.save_diagrams`` off it
    draws no PNG at all and needs no matplotlib.

    Under a process group the call is collective: the embedding splits
    the layers over the ranks (``embed_and_silhouettes``), every rank
    returns the whole result, and rank 0 alone prints, wipes the output
    directory and writes the files, the others waiting for it."""
    from tdax_torch.runtime import get_device

    cfg = cfg or SweepConfig()
    device = get_device(device)
    writer = is_writer()
    verbose = verbose and writer

    diagram_dir = os.path.join(cfg.output_dir, "diagrams")
    cloud_dir = os.path.join(cfg.output_dir, "point_clouds_3d")
    if writer:
        if os.path.exists(cfg.output_dir):
            shutil.rmtree(cfg.output_dir)  # the reference wipes per run
        ensure_dir(diagram_dir)
        ensure_dir(cloud_dir)

    metadata_map = {m["id"]: m for m in load_metadata(metadata_path)}

    # fewer layers in the data than configured (e.g. the toy model): use them
    n_avail = len(next(iter(all_data.values()))["activations"])
    if n_avail < cfg.n_layers:
        if verbose:
            print(f"[tdax_torch] data has {n_avail} layers (config: {cfg.n_layers}); "
                  f"using {n_avail}")
        cfg = dataclasses.replace(cfg, n_layers=n_avail)

    clouds, sample_ids = activations_to_layer_clouds(
        all_data, cfg.n_layers, point_cloud_type=cfg.point_cloud_type)
    color_labels = [metadata_map[i]["color"] for i in sample_ids]
    shape_labels = [metadata_map[i]["shape"] for i in sample_ids]
    if verbose:
        print(f"Found {len(sample_ids)} samples for type '{cfg.point_cloud_type}'")

    timings = {}
    t = time.perf_counter()
    clouds_3d, sil = embed_and_silhouettes(
        clouds, cfg, {"shape": shape_labels, "color": color_labels}, device)
    timings["embed_silhouettes_s"] = time.perf_counter() - t
    if verbose:
        print(f"[tdax_torch] embed+silhouettes ({cfg.reducer_mode}): "
              f"{timings['embed_silhouettes_s']:.1f}s", flush=True)
    if writer:
        log_event("embed", mode=cfg.reducer_mode, n_layers=cfg.n_layers,
                  seconds=round(timings["embed_silhouettes_s"], 2))

    t = time.perf_counter()
    dgms_per_layer = persistence_per_layer(clouds_3d, maxdim=cfg.rips.maxdim,
                                           backend=cfg.rips.backend, device=device)
    timings["persistence_s"] = time.perf_counter() - t
    if verbose:
        print(f"[tdax_torch] persistence: {timings['persistence_s']:.1f}s", flush=True)
    if writer:
        log_event("persistence", n_layers=cfg.n_layers,
                  seconds=round(timings["persistence_s"], 2))

    t = time.perf_counter()
    all_stats = []
    for i in range(cfg.n_layers):
        if cfg.save_clouds and writer:
            np.save(os.path.join(cloud_dir, f"layer_{i}_cloud.npy"), clouds_3d[i])
        stats = diagram_stats(dgms_per_layer[i], layer=i)
        stats["silhouette_shape"] = float(sil["shape"][i])
        stats["silhouette_color"] = float(sil["color"][i])
        all_stats.append(stats)
        if verbose:
            print(f"\n--- Layer {i} Stats ---")
            print(f"  Max H1 Pers: {stats['max_h1_persistence']:.4f} "
                  f"(n={stats['n_h1_features']})")
            print(f"  Max H0 Pers: {stats['max_h0_persistence']:.4f}")
            print(f"  SILHOUETTE (Shape): {stats['silhouette_shape']:.4f}")
            print(f"  SILHOUETTE (Color): {stats['silhouette_color']:.4f}")

    if writer:
        dump_json(all_stats, os.path.join(cfg.output_dir, "summary_stats.json"))
    if cfg.save_diagrams and writer:
        # the only matplotlib in the sweep; tdax draws the evolution plot
        # even without the diagrams
        from tdax_torch.viz.diagrams import save_diagram_png
        from tdax_torch.viz.evolution import plot_evolution_2x2

        def render(i: int) -> None:
            s = all_stats[i]
            save_diagram_png(
                dgms_per_layer[i], os.path.join(diagram_dir, f"layer_{i}_diagram.png"),
                title=f"Layer {i} Diagram | Shape Score: {s['silhouette_shape']:.2f} | "
                      f"Color Score: {s['silhouette_color']:.2f}")
        with cf.ThreadPoolExecutor(max_workers=4) as pool:
            list(pool.map(render, range(cfg.n_layers)))
        plot_evolution_2x2(all_stats, os.path.join(cfg.output_dir, "summary_evolution_plot.png"))
    barrier()
    timings["artifacts_s"] = time.perf_counter() - t

    peak_layer = peak(all_stats, cfg.peak_rule)
    if verbose:
        print("\n--- Overall Result ---")
        print(f"Peak layer ({cfg.peak_rule}): {peak_layer}")
        print(json.dumps(all_stats[peak_layer], indent=2))

    return {"stats": all_stats, "peak_layer": peak_layer, "clouds_3d": clouds_3d,
            "diagrams": dgms_per_layer, "sample_ids": sample_ids, "timings": timings}


def peak(stats: list[dict], rule: str) -> int:
    """The peak layer: shape-silhouette argmax or max-H1 argmax."""
    if rule == "shape_silhouette":
        return int(np.argmax([s["silhouette_shape"] for s in stats]))
    if rule == "max_h1":
        return int(np.argmax([s["max_h1_persistence"] for s in stats]))
    raise ValueError(f"unknown peak_rule {rule!r}")
