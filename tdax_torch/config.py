"""Typed configuration: the port's copy of ``tdax/config.py``.

What the captures and the sweeps need is copied here (dataset constants,
``DatasetConfig``, ``ExtractConfig``, ``UMAPConfig``, ``RipsConfig``,
``SweepConfig``); defaults are the reference constants, as in tdax.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Mapping, Sequence

# --- Dataset constants (reference generate_dataset.py:7-17) ---------------

COLORS: Mapping[str, tuple[int, int, int]] = {
    "red": (255, 60, 60),
    "green": (60, 255, 60),
    "blue": (60, 60, 255),
    "yellow": (255, 255, 60),
    "cyan": (60, 255, 255),
    "magenta": (255, 60, 255),
    "grey": (128, 128, 128),  # controls only
}
SHAPES: Sequence[str] = ("cube", "sphere", "pyramid", "cone", "torus", "cylinder")
NON_GREY_COLORS: Sequence[str] = tuple(c for c in COLORS if c != "grey")


@dataclasses.dataclass(frozen=True)
class DatasetConfig:
    """6x6 color x shape synthetic dataset (reference generate_dataset.py)."""

    data_dir: str = "data/physics_experiment_6x6"
    image_size: int = 200

    @property
    def image_dir(self) -> str:
        return os.path.join(self.data_dir, "images")

    @property
    def metadata_path(self) -> str:
        return os.path.join(self.data_dir, "metadata.json")

    @property
    def adversarial_metadata_path(self) -> str:
        return os.path.join(self.data_dir, "adversarial_metadata.json")

    @property
    def activations_path(self) -> str:
        return os.path.join(self.data_dir, "all_activations.pt")

    @property
    def adversarial_activations_path(self) -> str:
        return os.path.join(self.data_dir, "adversarial_activations.pt")


@dataclasses.dataclass(frozen=True)
class UMAPConfig:
    """UMAP hyperparameters (reference debug_tda_pipeline.py:96-102)."""

    n_neighbors: int = 6
    n_components: int = 3
    min_dist: float = 0.1
    spread: float = 1.0
    metric: str = "cosine"
    random_state: int = 42
    n_epochs: int | None = None  # None -> 500 for small datasets (umap-learn default)
    learning_rate: float = 1.0
    negative_sample_rate: int = 5
    repulsion_strength: float = 1.0
    set_op_mix_ratio: float = 1.0
    local_connectivity: float = 1.0
    init: str = "spectral"


@dataclasses.dataclass(frozen=True)
class RipsConfig:
    """Vietoris-Rips persistence (reference debug_tda_pipeline.py:21,109)."""

    maxdim: int = 1
    thresh: float = float("inf")
    coeff: int = 2  # only Z/2 supported, matching the as-used ripser default
    backend: str = "auto"  # "auto" | "native" | "python" | "device" (the sweep's batch)


@dataclasses.dataclass(frozen=True)
class SweepConfig:
    """Per-layer TDA sweep (reference debug_tda_pipeline.py:17-32)."""

    point_cloud_type: str = "bound"
    n_layers: int = 32
    output_dir: str = "tda_debug_output"
    umap: UMAPConfig = dataclasses.field(default_factory=UMAPConfig)
    rips: RipsConfig = dataclasses.field(default_factory=RipsConfig)
    # "per_layer" fits a fresh reducer per layer (debug_tda_pipeline.py:96-104);
    # "shared" fits once on the last layer then transforms every layer
    # (analyze_tda_over_layers.py:65-72).
    reducer_mode: str = "per_layer"
    # peak rule: "shape_silhouette" (debug_tda_pipeline.py:195) or
    # "max_h1" (analyze_tda_over_layers.py:126).
    peak_rule: str = "shape_silhouette"
    save_diagrams: bool = True  # the diagram PNGs and the evolution plot (matplotlib)
    save_clouds: bool = True


@dataclasses.dataclass(frozen=True)
class ExtractConfig:
    """Activation extraction (reference extract_activations.py:10-13,
    extract_adversarial_activations.py:58).

    ``model_dir`` is the Hugging Face snapshot the weights and the
    tokenizer come from when it holds them (random weights and the
    byte-level tokenizer otherwise).  The model's dtype is
    ``QwenVLConfig.dtype``.  ``quantize_int8`` runs the capture with
    int8 weight-only matmuls (tdax's ``extract_activations.py --int8``)."""

    model_dir: str | None = "./qwen-vl-chat-local"
    batch_size: int = 16
    save_interval: int = 50  # samples between incremental checkpoints
    quantize_int8: bool = False
