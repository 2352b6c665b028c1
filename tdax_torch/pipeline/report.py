"""The reference's last two root scripts, ported: the peak layer's
interactive 3-D HTML (``visualize_peak_layer.py`` / ``visualize.py``)
and the legacy sweep with one UMAP reducer shared by every layer
(``analyze_tda_over_layers.py``).

``visualize_peak_layer`` reads the sweep's
``point_clouds_3d/layer_<peak>_cloud.npy`` and writes two HTML scatters
(coloured by colour with symbols by shape, and the transpose).
``run_legacy_sweep`` runs ``run_tda_sweep`` with ``legacy_sweep_config``
(fit on the last layer, ``transform`` of every layer, peak by max H1)
and draws what tdax's script draws: the sweep's 2x2 evolution figure
(tdax's ``run_tda_sweep`` draws it even without the diagrams), the 1x3
evolution figure and the peak layer's diagram.  Those PNGs need
matplotlib, which is imported after the sweep's own files are written.
"""

from __future__ import annotations

import json
import os

from tdax_torch.config import DatasetConfig, SweepConfig, UMAPConfig

PEAK_LAYER = 25          # reference visualize.py:10 (hand-edited there)
DEBUG_DIR = "tda-output"  # reference visualize.py:12
POINT_CLOUD_TYPE = "bound"


def visualize_peak_layer(peak_layer: int = PEAK_LAYER, debug_dir: str = DEBUG_DIR,
                         metadata_path: str | None = None,
                         png_fallback: bool = True) -> tuple[str, str]:
    """Write the peak layer's two HTML scatters (and their PNGs when
    ``png_fallback``) into ``debug_dir``, falling back to
    ``tda_debug_output`` when ``debug_dir`` does not exist; returns the
    two HTML paths.  Raises SystemExit when the metadata's bound samples
    and the cloud's rows differ in number."""
    import numpy as np

    from tdax_torch.viz.scatter3d import write_scatter3d_html

    metadata_path = metadata_path or DatasetConfig().metadata_path
    if not os.path.isdir(debug_dir) and os.path.isdir("tda_debug_output"):
        debug_dir = "tda_debug_output"

    cloud_file = os.path.join(debug_dir, "point_clouds_3d", f"layer_{peak_layer}_cloud.npy")
    print(f"Loading 3D point cloud from {cloud_file}...")
    cloud_3d = np.load(cloud_file)

    print(f"Loading metadata from {metadata_path}...")
    with open(metadata_path) as f:
        all_metadata = json.load(f)
    bound = [m for m in all_metadata if m["type"] == POINT_CLOUD_TYPE]
    print(f"Loaded {len(bound)} metadata entries.")
    if len(bound) != cloud_3d.shape[0]:
        print(f"Error: Metadata count ({len(bound)}) does not match point "
              f"cloud size ({cloud_3d.shape[0]})")
        raise SystemExit(1)
    # cloud rows follow sorted sample ids (debug_tda_pipeline.py:46-49)
    bound = sorted(bound, key=lambda m: m["id"])

    colors = [m["color"] for m in bound]
    shapes = [m["shape"] for m in bound]
    ids = [m["id"] for m in bound]

    print("Generating 3D plot colored by 'color'...")
    color_path = os.path.join(debug_dir, f"layer_{peak_layer}_3D_plot_by_color.html")
    write_scatter3d_html(cloud_3d, colors, shapes, ids, color_path,
                         title=f"Layer {peak_layer} UMAP Embedding (Colored by Color)",
                         png_fallback=png_fallback)
    print(f"Saved color plot to {color_path}")

    print("Generating 3D plot colored by 'shape'...")
    shape_path = os.path.join(debug_dir, f"layer_{peak_layer}_3D_plot_by_shape.html")
    write_scatter3d_html(cloud_3d, shapes, colors, ids, shape_path,
                         title=f"Layer {peak_layer} UMAP Embedding (Colored by Shape)",
                         png_fallback=png_fallback)
    print(f"Saved shape plot to {shape_path}")
    return color_path, shape_path


def legacy_sweep_config(all_data: dict[str, dict],
                        output_dir: str = "tda_legacy_output") -> SweepConfig:
    """analyze_tda_over_layers.py's sweep: one reducer fit on the last
    layer and applied to every layer, n_neighbors = max(2, n // 2) of the
    bound samples, peak by max H1, no diagram PNGs."""
    n_samples = sum(1 for d in all_data.values()
                    if d["metadata"]["type"] == POINT_CLOUD_TYPE)
    return SweepConfig(point_cloud_type=POINT_CLOUD_TYPE, output_dir=output_dir,
                       umap=UMAPConfig(n_neighbors=max(2, n_samples // 2)),
                       reducer_mode="shared", peak_rule="max_h1", save_diagrams=False)


def run_legacy_sweep(all_data: dict[str, dict], metadata_path: str, device=None) -> dict:
    """The legacy sweep on the card (unless ``device="cpu"``) into
    ``tda_legacy_output/`` (with its ``summary_evolution_plot.png``),
    then ``tda_evolution_bound_umap.png`` and
    ``peak_layer_<p>_diagram_umap.png`` in the working directory, as
    tdax's script writes them; returns the sweep's result.  Under a
    process group the call is collective and rank 0 alone draws."""
    from tdax_torch.parallel.mesh import barrier, is_writer
    from tdax_torch.pipeline.tda_sweep import run_tda_sweep

    cfg = legacy_sweep_config(all_data)
    result = run_tda_sweep(all_data, metadata_path, cfg, device=device)
    if is_writer():
        _legacy_plots(result, cfg)
    barrier()
    return result


def _legacy_plots(result: dict, cfg) -> None:
    from tdax_torch.viz.diagrams import plot_diagrams
    from tdax_torch.viz.evolution import _plt, plot_evolution_1x3, plot_evolution_2x2

    plot_evolution_2x2(result["stats"], os.path.join(cfg.output_dir, "summary_evolution_plot.png"))

    plot_evolution_1x3(result["stats"], f"tda_evolution_{POINT_CLOUD_TYPE}_umap.png",
                       POINT_CLOUD_TYPE)
    print(f"Saved plot to tda_evolution_{POINT_CLOUD_TYPE}_umap.png")

    peak = result["peak_layer"]
    print(f"Peak $H_1$ persistence is at layer: {peak}")
    plt = _plt()
    fig = plt.figure()
    plot_diagrams(result["diagrams"][peak],
                  title=f"Persistence Diagram at Peak Layer {peak} (UMAP-3D)")
    plt.savefig(f"peak_layer_{peak}_diagram_umap.png")
    plt.close(fig)
    print(f"Saved diagram for peak layer {peak}")
