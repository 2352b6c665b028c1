"""tdax's package-level names resolve in the port: every name of
``tdax.data``, ``tdax.metrics`` and ``tdax.viz``'s ``__all__``, and the
five lazy top-level names of ``tdax``."""

import importlib

import pytest

import tdax
import tdax_torch

TOP_LEVEL = ["rips", "UMAP", "silhouette_score", "bottleneck_distance", "wasserstein_distance"]


@pytest.mark.parametrize("sub", ["data", "metrics", "viz"])
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

