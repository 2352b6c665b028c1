"""Adversarial compositional-binding TDA analysis (port of
``tdax/pipeline/adversarial.py``).

The reference's ``analyze_adversarial_tda.py``: for each of the four
conditions, every layer's cloud of that condition's samples goes
through the main sweep's stages (UMAP and four silhouettes on the card,
Vietoris-Rips H0/H1 in the native engine), with tdax's artifact tree
(``{condition}/{diagrams,point_clouds}``, ``layer_stats.json``,
``comparison/all_conditions_comparison.png``, ``summary.json``) and stat
schema (analyze_adversarial_tda.py:113-122).

The conditions run one after another: tdax's thread fan-out overlaps
XLA compilations, which the port does not have.  With
``cfg.save_diagrams`` off no PNG is drawn, the comparison figure
included, so the sweep runs without matplotlib (the main sweep's
departure from tdax, which draws the figure regardless).
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import os

import numpy as np

from tdax_torch.config import SweepConfig
from tdax_torch.data.adversarial import CONDITIONS
from tdax_torch.data.io import activations_to_layer_clouds, dump_json, ensure_dir
from tdax_torch.metrics.persistence import get_persistence
from tdax_torch.parallel.mesh import barrier, is_writer
from tdax_torch.pipeline.tda_sweep import embed_and_silhouettes, persistence_per_layer
from tdax_torch.runtime import get_device

LABEL_KEYS = ("img_color", "img_shape", "txt_color", "txt_shape")


def _pin_protocol(cfg: SweepConfig) -> SweepConfig:
    """The reference fits a fresh UMAP per condition and layer with
    n_neighbors = min(6, n - 1) hard-coded (analyze_adversarial_tda.py:85-91),
    whatever the main sweep's knobs say; both are pinned here, and
    ``embed_and_silhouettes`` applies the min(n_neighbors, n - 1) clamp."""
    if cfg.reducer_mode != "per_layer" or cfg.umap.n_neighbors != 6:
        cfg = dataclasses.replace(cfg, reducer_mode="per_layer",
                                  umap=dataclasses.replace(cfg.umap, n_neighbors=6))
    return cfg


def compute_tda_for_condition(condition: str, clouds: np.ndarray,
                              labels: dict[str, list[str]], output_subdir: str,
                              cfg: SweepConfig, verbose: bool = True,
                              device=None) -> list[dict]:
    """clouds [L, n, hidden]; labels: img_color/img_shape/txt_color/txt_shape.
    Writes the condition's point clouds, diagrams and layer_stats.json
    and returns its per-layer stats.  Under a process group: collective,
    the layers split over the ranks, rank 0 alone printing and writing."""
    writer = is_writer()
    if verbose and writer:
        print(f"\n--- Analyzing {condition} ---")
    diag_dir = os.path.join(output_subdir, "diagrams")
    cloud_dir = os.path.join(output_subdir, "point_clouds")
    if writer:
        ensure_dir(diag_dir)
        ensure_dir(cloud_dir)

    cfg = _pin_protocol(cfg)
    clouds_3d, sil = embed_and_silhouettes(clouds, cfg, labels, device)
    dgms_per_layer = persistence_per_layer(clouds_3d, maxdim=cfg.rips.maxdim,
                                           backend=cfg.rips.backend, device=device)

    all_stats = []
    for i in range(cfg.n_layers):
        if cfg.save_clouds and writer:
            np.save(os.path.join(cloud_dir, f"layer_{i}_cloud.npy"), clouds_3d[i])
        dgms = dgms_per_layer[i]
        _, max_h0 = get_persistence(dgms[0])
        h1_pers, max_h1 = get_persistence(dgms[1])
        all_stats.append({
            "layer": i,
            "n_h1_features": int(len(h1_pers)),
            "max_h1_persistence": float(max_h1),
            "max_h0_persistence": float(max_h0),
            "silhouette_img_color": float(sil["img_color"][i]),
            "silhouette_img_shape": float(sil["img_shape"][i]),
            "silhouette_txt_color": float(sil["txt_color"][i]),
            "silhouette_txt_shape": float(sil["txt_shape"][i]),
        })

    if not writer:
        return all_stats
    if cfg.save_diagrams:
        from tdax_torch.viz.diagrams import save_diagram_png

        def render(i: int) -> None:
            s = all_stats[i]
            save_diagram_png(dgms_per_layer[i], os.path.join(diag_dir, f"layer_{i}_diagram.png"),
                             title=f"{condition} - Layer {i} | H1={s['n_h1_features']} | "
                                   f"Max Pers={s['max_h1_persistence']:.3f}")
        with cf.ThreadPoolExecutor(max_workers=4) as pool:
            list(pool.map(render, range(cfg.n_layers)))

    dump_json(all_stats, os.path.join(output_subdir, "layer_stats.json"))
    return all_stats


def plot_comparison(condition_stats: dict[str, list[dict]], n_layers: int,
                    out_path: str) -> None:
    """The 2x3 cross-condition figure, with the persistence-disruption
    panel matched - mismatched (analyze_adversarial_tda.py:158-239)."""
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(2, 3, figsize=(18, 12))
    layers = range(n_layers)
    panels = [
        (axes[0, 0], "max_h1_persistence", "Max H1 Persistence by Condition", "Max Persistence"),
        (axes[0, 1], "n_h1_features", "Number of H1 Features by Condition", "Number of Features"),
        (axes[0, 2], "silhouette_img_color", "Image Color Clustering (by actual image)",
         "Silhouette Score"),
        (axes[1, 0], "silhouette_txt_color", "Text Color Clustering (by text prompt)",
         "Silhouette Score"),
        (axes[1, 1], "silhouette_img_shape", "Image Shape Clustering", "Silhouette Score"),
    ]
    for ax, key, title, ylabel in panels:
        for condition in CONDITIONS:
            if condition in condition_stats:
                ax.plot(layers, [s[key] for s in condition_stats[condition]],
                        "o-", label=condition, linewidth=2)
        ax.set_title(title)
        ax.set_xlabel("Layer")
        ax.set_ylabel(ylabel)
        ax.legend()
        ax.grid(True)

    ax = axes[1, 2]
    if "matched" in condition_stats:
        matched = np.array([s["max_h1_persistence"] for s in condition_stats["matched"]])
        for condition in ("color_mismatch", "shape_mismatch", "both_mismatch"):
            if condition in condition_stats:
                mism = np.array([s["max_h1_persistence"] for s in condition_stats[condition]])
                ax.plot(layers, matched - mism, "o-", label=f"{condition} disruption",
                        linewidth=2)
    ax.set_title("Persistence Disruption: Matched - Mismatched")
    ax.set_xlabel("Layer")
    ax.set_ylabel("Persistence Difference")
    ax.legend()
    ax.grid(True)
    ax.axhline(y=0, color="k", linestyle="--", alpha=0.3)

    plt.tight_layout()
    plt.savefig(out_path)
    plt.close(fig)


def run_adversarial_sweep(all_data: dict[str, dict], output_dir: str,
                          cfg: SweepConfig | None = None, verbose: bool = True,
                          device=None) -> dict:
    """The four conditions' sweeps; returns and writes summary.json
    ({"condition_stats": {condition: [per-layer stats]},
    "n_samples_per_condition": {condition: n}}).  Runs on the card
    unless ``device="cpu"``.  Under a process group the call is
    collective (each condition's layers split over the ranks), every
    rank returns the summary, and rank 0 alone prints and writes, the
    others waiting for it."""
    cfg = cfg or SweepConfig()
    device = get_device(device)
    writer = is_writer()
    verbose = verbose and writer
    if writer:
        ensure_dir(os.path.join(output_dir, "comparison"))

    n_avail = len(next(iter(all_data.values()))["activations"])
    if n_avail < cfg.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_avail)
    cfg = _pin_protocol(cfg)

    n_per_condition: dict[str, int] = {}
    condition_stats: dict[str, list[dict]] = {}
    for condition in CONDITIONS:
        if not any(e["metadata"].get("condition") == condition for e in all_data.values()):
            if verbose:
                print(f"Warning: No samples for {condition}")
            continue
        clouds, ids = activations_to_layer_clouds(all_data, cfg.n_layers,
                                                  point_cloud_type=None, condition=condition)
        n_per_condition[condition] = len(ids)
        labels = {key: [all_data[i]["metadata"][key] for i in ids] for key in LABEL_KEYS}
        condition_stats[condition] = compute_tda_for_condition(
            condition, clouds, labels, os.path.join(output_dir, condition), cfg,
            verbose=verbose, device=device)

    if cfg.save_diagrams and writer:
        plot_comparison(condition_stats, cfg.n_layers,
                        os.path.join(output_dir, "comparison", "all_conditions_comparison.png"))

    summary = {"condition_stats": condition_stats, "n_samples_per_condition": n_per_condition}
    if writer:
        dump_json(summary, os.path.join(output_dir, "summary.json"))
    barrier()
    if verbose:
        print(f"\n--- Analysis Complete ---\nResults saved to: {output_dir}")
    return summary
