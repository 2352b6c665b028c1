"""Synthetic 6x6 color x shape dataset (port of ``tdax/data/dataset.py``).

48 samples (36 "bound" color x shape, 6 "color_only" colored cubes, 6
"shape_only" grey shapes), each a 200x200 PNG of a 2-D primitive on a
grey background, plus ``metadata.json`` with
``{id, image_path, prompt, type, color, shape}`` per sample, in the
reference's order.  Rendering is host-side PIL, as in tdax.
"""

from __future__ import annotations

import json
import os
from typing import Iterable

from PIL import Image, ImageDraw

from tdax_torch.config import COLORS, NON_GREY_COLORS, SHAPES, DatasetConfig


def create_image(img_path: str, color_name: str, shape_name: str, size: int = 200) -> None:
    """Render one colored-shape PNG: cube=rectangle, sphere=ellipse,
    pyramid/cone=triangles of differing base width, torus=thick ellipse
    outline, cylinder=rectangle+top ellipse."""
    img = Image.new("RGB", (size, size), color="grey")
    draw = ImageDraw.Draw(img)
    rgb = COLORS[color_name]
    s = size / 200.0  # scale factor relative to the reference 200px canvas

    def pt(x: float, y: float) -> tuple[float, float]:
        return (x * s, y * s)

    if shape_name == "cube":
        draw.rectangle([pt(50, 50), pt(150, 150)], fill=rgb, outline="black")
    elif shape_name == "sphere":
        draw.ellipse([pt(50, 50), pt(150, 150)], fill=rgb, outline="black")
    elif shape_name == "pyramid":
        draw.polygon([pt(100, 50), pt(50, 150), pt(150, 150)], fill=rgb, outline="black")
    elif shape_name == "cone":
        draw.polygon([pt(100, 50), pt(40, 150), pt(160, 150)], fill=rgb, outline="black")
    elif shape_name == "torus":
        draw.ellipse([pt(50, 50), pt(150, 150)], fill=None, outline=rgb,
                     width=max(1, round(20 * s)))
    elif shape_name == "cylinder":
        draw.rectangle([pt(60, 50), pt(140, 150)], fill=rgb, outline="black")
        draw.ellipse([pt(60, 40), pt(140, 60)], fill=rgb, outline="black")
    else:
        raise ValueError(f"unknown shape: {shape_name!r}")

    img.save(img_path)


def _entry(cfg: DatasetConfig, img_id: str, prompt: str, kind: str,
           color: str, shape: str) -> dict:
    return {
        "id": img_id,
        "image_path": os.path.join(cfg.image_dir, f"{img_id}.png"),
        "prompt": prompt,
        "type": kind,
        "color": color,
        "shape": shape,
    }


def _entries(cfg: DatasetConfig) -> Iterable[tuple[dict, str, str]]:
    """(metadata entry, rendered color, rendered shape) in reference order."""
    for color in NON_GREY_COLORS:
        for shape in SHAPES:
            yield (_entry(cfg, f"{color}_{shape}", f"a photo of a {color} {shape}",
                          "bound", color, shape), color, shape)
    for color in NON_GREY_COLORS:
        yield (_entry(cfg, f"{color}_object", f"a photo of a {color} object",
                      "color_only", color, "unknown"), color, "cube")
    for shape in SHAPES:
        yield (_entry(cfg, f"grey_{shape}", f"a photo of a grey {shape}",
                      "shape_only", "grey", shape), "grey", shape)


def generate_dataset(cfg: DatasetConfig | None = None, render: bool = True) -> list[dict]:
    """Write the images and metadata.json; return the metadata list."""
    cfg = cfg or DatasetConfig()
    os.makedirs(cfg.image_dir, exist_ok=True)
    metadata: list[dict] = []
    for entry, color, shape in _entries(cfg):
        if render:
            create_image(entry["image_path"], color, shape, cfg.image_size)
        metadata.append(entry)
    with open(cfg.metadata_path, "w") as f:
        json.dump(metadata, f, indent=2)
    return metadata
