"""Typed configuration: the port's copy of ``tdax/config.py``.

Only what the capture slice needs is copied here (dataset constants,
``DatasetConfig``, ``ExtractConfig``); defaults are the reference
constants, as in tdax.
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
    def activations_path(self) -> str:
        return os.path.join(self.data_dir, "all_activations.pt")


@dataclasses.dataclass(frozen=True)
class ExtractConfig:
    """Activation extraction (reference extract_activations.py:10-13).

    The model's dtype is ``QwenVLConfig.dtype``; ``model_dir`` returns
    with the checkpoint loader."""

    batch_size: int = 16
    save_interval: int = 50  # samples between incremental checkpoints
