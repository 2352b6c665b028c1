"""Image preprocessing: Qwen-VL's CLIP-style transform (port of
``tdax/models/qwen_vl/preprocess.py``).

Resize to image_size x image_size (PIL bicubic) and normalize with the
OpenAI CLIP mean/std, on the host.
"""

from __future__ import annotations

import numpy as np
from PIL import Image

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], dtype=np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], dtype=np.float32)


def load_image(path: str, image_size: int) -> np.ndarray:
    """-> [3, S, S] float32 normalized."""
    with Image.open(path) as img:
        img = img.convert("RGB").resize((image_size, image_size), Image.BICUBIC)
    arr = np.asarray(img, dtype=np.float32) / 255.0
    arr = (arr - CLIP_MEAN) / CLIP_STD
    return np.transpose(arr, (2, 0, 1))


def load_image_batch(paths: list[str | None], image_size: int) -> np.ndarray:
    """-> [B, 3, S, S]; missing paths become zeros (text-only samples)."""
    out = np.zeros((len(paths), 3, image_size, image_size), dtype=np.float32)
    for i, p in enumerate(paths):
        if p is not None:
            out[i] = load_image(p, image_size)
    return out
