"""Image preprocessing for Kimi-VL: resize to the capture's image size
(PIL bicubic) and normalize with the image processor's mean and std (0.5
on every channel), on the host."""

from __future__ import annotations

import numpy as np
from PIL import Image

from tdax_torch.models.kimi_vl.config import MoonViTConfig


def load_image(path: str, cfg: MoonViTConfig) -> np.ndarray:
    """-> [3, S, S] float32 normalized."""
    with Image.open(path) as img:
        img = img.convert("RGB").resize((cfg.image_size, cfg.image_size), Image.BICUBIC)
    arr = np.asarray(img, dtype=np.float32) / 255.0
    return np.transpose((arr - cfg.image_mean) / cfg.image_std, (2, 0, 1))


def load_image_batch(paths: list[str | None], cfg: MoonViTConfig) -> np.ndarray:
    """-> [B, 3, S, S]; missing paths become zeros (text-only samples)."""
    out = np.zeros((len(paths), 3, cfg.image_size, cfg.image_size), dtype=np.float32)
    for i, p in enumerate(paths):
        if p is not None:
            out[i] = load_image(p, cfg)
    return out
