"""The port's plots and its two report commands against tdax's, on the
CPU: the 3-D HTML byte for byte, the evolution PNGs and the diagrams
pixel for pixel, ``python -m tdax_torch visualize`` against
``visualize_peak_layer.py`` on the same sweep output, and ``python -m
tdax_torch sweep --legacy`` against ``analyze_tda_over_layers.py``'s
file names and peak rule."""

import importlib.util
import io
import json
import pathlib
import re

import numpy as np
import pytest

import matplotlib

matplotlib.use("Agg")
import matplotlib.image as mpimg
import matplotlib.pyplot as plt
from matplotlib.backends.backend_agg import FigureCanvasAgg
from matplotlib.figure import Figure

from tdax.viz import diagrams as jdiagrams
from tdax.viz import evolution as jevolution
from tdax.viz import scatter3d as jscatter

from tdax_torch.viz import diagrams, evolution, scatter3d

ROOT = pathlib.Path(__file__).resolve().parents[1]
_SRC = re.compile(r"""src\s*=\s*["']?https?:""", re.IGNORECASE)


def _root_script(name):
    spec = importlib.util.spec_from_file_location(f"_root_{name}", ROOT / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pixels(path):
    return mpimg.imread(str(path))


def _labelled_cloud(seed=0, n=36):
    rng = np.random.default_rng(seed)
    cloud = rng.normal(size=(n, 3)).astype(np.float32)
    colors = [f"c{i % 6}" for i in range(n)]
    shapes = [f"s{i // 6}" for i in range(n)]
    ids = [f"{c}_{s}_{i}" for i, (c, s) in enumerate(zip(colors, shapes))]
    return cloud, colors, shapes, ids


# --- 3-D HTML -----------------------------------------------------------------------

@pytest.mark.parametrize("png", [False, True])
@pytest.mark.parametrize("transpose", [False, True], ids=["by_color", "by_shape"])
def test_scatter3d_html_is_byte_identical_to_tdax(tmp_path, png, transpose):
    cloud, colors, shapes, ids = _labelled_cloud()
    labels = (shapes, colors) if transpose else (colors, shapes)
    for mod, name in ((scatter3d, "port"), (jscatter, "tdax")):
        mod.write_scatter3d_html(cloud, *labels, ids, str(tmp_path / f"{name}.html"),
                                 title="Layer 2 UMAP Embedding", png_fallback=png)
    html = (tmp_path / "port.html").read_bytes()
    assert html == (tmp_path / "tdax.html").read_bytes()
    assert not _SRC.search(html.decode())
    assert (tmp_path / "port.png").exists() == png
    if png:
        np.testing.assert_array_equal(_pixels(tmp_path / "port.png"),
                                      _pixels(tmp_path / "tdax.png"))


def test_scatter3d_html_holds_every_point_once(tmp_path):
    cloud, colors, shapes, ids = _labelled_cloud(1)
    out = tmp_path / "x.html"
    scatter3d.write_scatter3d_html(cloud, colors, shapes, ids, str(out), png_fallback=False)
    traces = json.loads(re.search(r"var traces = (.*);\n", out.read_text()).group(1))
    assert [t["name"] for t in traces] == [f"c{c}, s{s}" for c in range(6) for s in range(6)]
    got = {t["text"][0]: (t["x"][0], t["y"][0], t["z"][0]) for t in traces}
    assert sorted(got) == sorted(ids)
    for k, sid in enumerate(ids):
        np.testing.assert_array_equal(got[sid], cloud[k].astype(float))


# --- evolution figures and diagrams ---------------------------------------------------

def _stats(seed=0, n_layers=6):
    rng = np.random.default_rng(seed)
    return [{"layer": i, "n_h1_features": int(rng.integers(0, 9)),
             "max_h1_persistence": float(rng.uniform()), "max_h0_persistence": float(rng.uniform()),
             "silhouette_shape": float(rng.uniform(-1, 1)),
             "silhouette_color": float(rng.uniform(-1, 1))} for i in range(n_layers)]


@pytest.mark.parametrize("figure", ["plot_evolution_1x3", "plot_evolution_2x2"])
def test_evolution_png_is_pixel_identical_to_tdax(tmp_path, figure):
    stats = _stats()
    getattr(evolution, figure)(stats, str(tmp_path / "port.png"))
    getattr(jevolution, figure)(stats, str(tmp_path / "tdax.png"))
    np.testing.assert_array_equal(_pixels(tmp_path / "port.png"), _pixels(tmp_path / "tdax.png"))


def test_evolution_1x3_names_the_point_cloud_type(tmp_path):
    stats = _stats(1)
    evolution.plot_evolution_1x3(stats, str(tmp_path / "port.png"), "unbound")
    jevolution.plot_evolution_1x3(stats, str(tmp_path / "tdax.png"), "unbound")
    evolution.plot_evolution_1x3(stats, str(tmp_path / "bound.png"))
    port = _pixels(tmp_path / "port.png")
    np.testing.assert_array_equal(port, _pixels(tmp_path / "tdax.png"))
    assert not np.array_equal(port, _pixels(tmp_path / "bound.png"))


def _diagrams(seed=0):
    rng = np.random.default_rng(seed)
    b0 = np.zeros(8)
    h0 = np.stack([b0, np.append(rng.uniform(0.1, 1, 7), np.inf)], 1)
    b1 = rng.uniform(0.2, 0.8, 4)
    h1 = np.stack([b1, b1 + rng.uniform(0.05, 0.3, 4)], 1)
    return [h0, h1]


def _draw_on_axis(mod, dgms):
    fig = Figure(figsize=(5, 5))
    FigureCanvasAgg(fig)
    ax = fig.add_subplot()
    assert mod.plot_diagrams(dgms, ax, False, "Peak") is ax  # tdax's positional order
    buf = io.BytesIO()
    fig.savefig(buf, format="png")
    buf.seek(0)
    return mpimg.imread(buf), ax


def _draw_on_pyplot(mod, dgms):
    fig = plt.figure()
    ax = mod.plot_diagrams(dgms, title="Peak")
    assert ax is fig.axes[0]
    buf = io.BytesIO()
    plt.savefig(buf, format="png")
    plt.close(fig)
    buf.seek(0)
    return mpimg.imread(buf)


@pytest.mark.parametrize("seed", [0, 1])
def test_plot_diagrams_draws_what_tdax_draws(seed):
    dgms = _diagrams(seed)
    port, ax = _draw_on_axis(diagrams, dgms)
    want, jax_ax = _draw_on_axis(jdiagrams, dgms)
    np.testing.assert_array_equal(port, want)
    offsets = [c.get_offsets() for c in ax.collections]
    for got, exp in zip(offsets, [c.get_offsets() for c in jax_ax.collections], strict=True):
        np.testing.assert_array_equal(got, exp)
    np.testing.assert_array_equal(_draw_on_pyplot(diagrams, dgms), _draw_on_pyplot(jdiagrams, dgms))


def test_plot_diagrams_show_calls_pyplot_show(monkeypatch):
    shown = []
    monkeypatch.setattr(plt, "show", lambda: shown.append(True))
    fig = plt.figure()
    diagrams.plot_diagrams(_diagrams(), show=True)
    plt.close(fig)
    assert shown == [True]


# --- the two report commands --------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_capture(tmp_path_factory):
    """The 6x6 dataset's metadata and a 3-layer, 16-wide capture of it,
    as the port's ``extract`` would write them (.npz)."""
    from tdax_torch.config import DatasetConfig
    from tdax_torch.data.dataset import generate_dataset
    from tdax_torch.data.io import save_activations_npz
    root = tmp_path_factory.mktemp("tiny_capture")
    ds = DatasetConfig(data_dir=str(root / "data" / "physics_experiment_6x6"))
    md = generate_dataset(ds, render=False)
    acts = np.random.default_rng(3).normal(size=(3, len(md), 16)).astype(np.float32)
    save_activations_npz(ds.activations_path.replace(".pt", ".npz"), acts,
                         [m["id"] for m in md], md)
    return root


def _copy_capture(src, dst):
    import shutil
    shutil.copytree(src / "data", dst / "data")


def test_legacy_sweep_command_writes_tdax_file_names(tiny_capture, tmp_path, monkeypatch):
    """``sweep --legacy --device cpu`` writes the files tdax's
    analyze_tda_over_layers.py writes, and its peak is the max-H1 layer."""
    from tdax_torch.__main__ import main
    port, ref = tmp_path / "port", tmp_path / "tdax"
    for d in (port, ref):
        _copy_capture(tiny_capture, d)
    monkeypatch.chdir(port)
    main(["sweep", "--legacy", "--device", "cpu"])
    stats = json.loads((port / "tda_legacy_output" / "summary_stats.json").read_text())
    peak = int(np.argmax([s["max_h1_persistence"] for s in stats]))
    assert [s["layer"] for s in stats] == [0, 1, 2]
    assert (port / f"peak_layer_{peak}_diagram_umap.png").exists()

    legacy = _root_script("analyze_tda_over_layers")
    monkeypatch.setattr(legacy, "setup_runtime", lambda: None)
    monkeypatch.chdir(ref)
    legacy.main()
    jstats = json.loads((ref / "tda_legacy_output" / "summary_stats.json").read_text())
    jpeak = int(np.argmax([s["max_h1_persistence"] for s in jstats]))

    def names(root, p):
        files = {str(f.relative_to(root)) for f in root.rglob("*")
                 if f.is_file() and "data" not in f.relative_to(root).parts}
        return {f.replace(f"peak_layer_{p}_", "peak_layer_P_") for f in files}
    assert names(port, peak) == names(ref, jpeak)
    assert [list(s) for s in stats] == [list(s) for s in jstats]
    assert "tda_evolution_bound_umap.png" in names(port, peak)


def test_visualize_command_matches_visualize_peak_layer(tiny_capture, tmp_path, monkeypatch):
    """``visualize`` on a sweep's output writes the two HTML files that
    visualize_peak_layer.main writes on the same directory, byte for byte."""
    from tdax_torch.__main__ import main
    from tdax_torch.config import DatasetConfig, SweepConfig, UMAPConfig
    from tdax_torch.data.io import load_activations
    from tdax_torch.pipeline.tda_sweep import run_tda_sweep
    _copy_capture(tiny_capture, tmp_path)
    monkeypatch.chdir(tmp_path)
    ds = DatasetConfig()
    result = run_tda_sweep(load_activations(ds.activations_path.replace(".pt", ".npz")),
                           ds.metadata_path,
                           SweepConfig(umap=UMAPConfig(n_epochs=20), save_diagrams=False),
                           verbose=False, device="cpu")
    peak = result["peak_layer"]
    out = tmp_path / "tda_debug_output"  # "tda-output" is absent: the fallback
    main(["visualize", "--peak-layer", str(peak), "--no-png"])
    names = [f"layer_{peak}_3D_plot_by_{k}.html" for k in ("color", "shape")]
    port = {n: (out / n).read_bytes() for n in names}
    assert not list(out.glob("*.png"))
    for n in names:
        (out / n).unlink()
    _root_script("visualize_peak_layer").main(peak, "tda-output")
    for n in names:
        assert (out / n).read_bytes() == port[n], n
        assert not _SRC.search(port[n].decode())
    assert len(list(out.glob("*.png"))) == 2  # tdax's PNGs beside its HTML


def test_visualize_raises_when_the_counts_differ(tiny_capture, tmp_path, monkeypatch):
    from tdax_torch.pipeline.report import visualize_peak_layer
    _copy_capture(tiny_capture, tmp_path)
    monkeypatch.chdir(tmp_path)
    (tmp_path / "tda-output" / "point_clouds_3d").mkdir(parents=True)
    np.save(tmp_path / "tda-output" / "point_clouds_3d" / "layer_25_cloud.npy",
            np.zeros((35, 3), np.float32))
    with pytest.raises(SystemExit):
        visualize_peak_layer(png_fallback=False)


def test_legacy_sweep_without_matplotlib_raises_after_the_sweep(tiny_capture, tmp_path,
                                                                 monkeypatch):
    """The legacy command's plots need matplotlib: without it the command
    raises ImportError, and the sweep's own files are already written."""
    import sys

    from tdax_torch.__main__ import main
    _copy_capture(tiny_capture, tmp_path)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError):
        main(["sweep", "--legacy", "--device", "cpu"])
    out = tmp_path / "tda_legacy_output"
    assert len(json.loads((out / "summary_stats.json").read_text())) == 3
    assert len(list((out / "point_clouds_3d").glob("*.npy"))) == 3
    assert not list(tmp_path.glob("*.png"))
