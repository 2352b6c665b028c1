"""tdax's package-level names resolve in the port: every name of the
``__all__`` of ``tdax.data``, ``tdax.metrics``, ``tdax.viz``,
``tdax.pipeline`` (resolved on first use, as ``tdax_torch.parallel``'s
names), ``tdax.ops.rips``, ``tdax.ops.umap`` and ``tdax.models.qwen_vl``,
and the five lazy top-level names of ``tdax``."""

import importlib

import pytest

import tdax
import tdax_torch

TOP_LEVEL = ["rips", "UMAP", "silhouette_score", "bottleneck_distance", "wasserstein_distance"]


@pytest.mark.parametrize("sub", ["data", "metrics", "viz", "pipeline", "ops.rips", "ops.umap",
                                 "models.qwen_vl"])
def test_subpackage_names_match_tdax(sub):
    want = importlib.import_module(f"tdax.{sub}").__all__
    port = importlib.import_module(f"tdax_torch.{sub}")
    assert port.__all__ == want
    for name in want:
        obj = getattr(port, name)
        assert callable(obj), name
        assert obj.__module__.startswith("tdax_torch."), (name, obj.__module__)


@pytest.mark.parametrize("name", TOP_LEVEL)
def test_top_level_lazy_names(name):
    obj = getattr(tdax_torch, name)
    assert obj.__module__.startswith("tdax_torch.")
    assert getattr(tdax, name).__name__ == obj.__name__


def test_unknown_top_level_name_raises_attribute_error():
    with pytest.raises(AttributeError, match="module 'tdax_torch' has no attribute 'nope'"):
        tdax_torch.nope
    with pytest.raises(AttributeError, match="module 'tdax' has no attribute 'nope'"):
        tdax.nope
    assert not hasattr(tdax_torch, "plot_diagrams")


def test_pipeline_names_import_from_the_package():
    """The reference's scripts import the sweeps from the package
    (debug_tda_pipeline.py:16, analyze_tda_over_layers.py:18)."""
    from tdax_torch.pipeline import run_adversarial_sweep, run_tda_sweep
    from tdax_torch.pipeline.adversarial import run_adversarial_sweep as adversarial
    from tdax_torch.pipeline.tda_sweep import run_tda_sweep as sweep
    assert (run_tda_sweep, run_adversarial_sweep) == (sweep, adversarial)
    with pytest.raises(AttributeError, match="'tdax_torch.pipeline' has no attribute 'nope'"):
        import tdax_torch.pipeline
        tdax_torch.pipeline.nope


def test_parallel_names_are_tdax_names():
    """``tdax_torch.parallel`` names tdax's 17 names, in tdax's order, and
    no other (the mesh helpers the port adds stay in
    ``tdax_torch.parallel.mesh``), each resolving to the port's, the 1F1B
    pipeline's five among them (context parallelism adds no name: it is
    ``make_mesh(cp=)``, ``flash_sharding(seq_axis=)`` and ``cp_mesh=``)."""
    import tdax.parallel as jpar
    import tdax_torch.parallel as par
    assert par.__all__ == jpar.__all__
    assert len(par.__all__) == 17
    for name in par.__all__:
        assert getattr(par, name).__module__.startswith("tdax_torch.parallel."), name
    assert {getattr(par, name).__module__ for name in (
        "make_pp_mesh", "pipeline_forward", "shard_params_pp", "make_train_step_pp",
        "pipeline_1f1b_grads")} == {"tdax_torch.parallel.pipeline"}
