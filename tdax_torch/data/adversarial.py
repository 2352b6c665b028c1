"""Adversarial compositional-binding pairs (port of
``tdax/data/adversarial.py``).

From the 36 bound base images, 720 image-text pairs in four conditions
per base image: 1 matched, 5 color_mismatch, 5 shape_mismatch and 9
both_mismatch (the first 3 x first 3 of the *other* colours and shapes),
in the reference's order (generate_adversarial_metadata.py:42-111).
"""

from __future__ import annotations

import json
from itertools import product
from typing import Sequence

from tdax_torch.config import NON_GREY_COLORS, SHAPES, DatasetConfig

CONDITIONS: Sequence[str] = ("matched", "color_mismatch", "shape_mismatch", "both_mismatch")


def _sample(base_id: str, image_path: str, suffix: str, condition: str,
            img_color: str, img_shape: str, txt_color: str, txt_shape: str) -> dict:
    return {
        "id": f"{base_id}_{suffix}",
        "base_id": base_id,
        "image_path": image_path,
        "prompt": f"a photo of a {txt_color} {txt_shape}",
        "condition": condition,
        "img_color": img_color,
        "img_shape": img_shape,
        "txt_color": txt_color,
        "txt_shape": txt_shape,
        "color_match": txt_color == img_color,
        "shape_match": txt_shape == img_shape,
    }


def generate_adversarial_metadata(base_metadata: list[dict],
                                  cfg: DatasetConfig | None = None,
                                  save: bool = True) -> list[dict]:
    """The 720-sample adversarial set from the base metadata's bound
    images; with ``save`` also written to ``cfg.adversarial_metadata_path``."""
    cfg = cfg or DatasetConfig()
    image_lookup = {(item["color"], item["shape"]): item["image_path"]
                    for item in base_metadata if item["type"] == "bound"}

    samples: list[dict] = []
    for img_color, img_shape in product(NON_GREY_COLORS, SHAPES):
        image_path = image_lookup.get((img_color, img_shape))
        if not image_path:
            continue
        base_id = f"{img_color}_{img_shape}"

        samples.append(_sample(base_id, image_path, "matched", "matched",
                               img_color, img_shape, img_color, img_shape))
        for txt_color in NON_GREY_COLORS:
            if txt_color != img_color:
                samples.append(_sample(base_id, image_path, f"color_{txt_color}",
                                       "color_mismatch",
                                       img_color, img_shape, txt_color, img_shape))
        for txt_shape in SHAPES:
            if txt_shape != img_shape:
                samples.append(_sample(base_id, image_path, f"shape_{txt_shape}",
                                       "shape_mismatch",
                                       img_color, img_shape, img_color, txt_shape))
        # both mismatched: a balanced 3 x 3 subset per base image
        other_colors = [c for c in NON_GREY_COLORS if c != img_color]
        other_shapes = [s for s in SHAPES if s != img_shape]
        for txt_color, txt_shape in product(other_colors[:3], other_shapes[:3]):
            samples.append(_sample(base_id, image_path, f"both_{txt_color}_{txt_shape}",
                                   "both_mismatch",
                                   img_color, img_shape, txt_color, txt_shape))

    if save:
        with open(cfg.adversarial_metadata_path, "w") as f:
            json.dump(samples, f, indent=2)
    return samples


def condition_counts(samples: list[dict]) -> dict[str, int]:
    counts: dict[str, int] = {}
    for s in samples:
        counts[s["condition"]] = counts.get(s["condition"], 0) + 1
    return counts
