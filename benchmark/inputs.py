"""The traffic generator: a mix file's parameters and ``--seed`` in, the
host arrays or device batches a cell's window feeds the program out.
The same seed gives the same inputs; every seed gives the same sizes,
in another order.

``CaptureInputs``: the research pipeline's dataset (6 colours x 6 shapes,
6 colour-only and 6 shape-only samples), each a ``render_size`` px PIL
drawing resized to the model's image size and CLIP-normalized, with its
prompt in the Qwen-VL query layout (``Picture 1: <img>..</img>\\n`` +
text; the image span is img_start, ``n_queries`` pads, img_end) under a
byte-level vocabulary, every row padded to one length rounded up to
``pad_multiple``.  Batches walk seeded permutations of the samples; the
first ``pool_batches`` of them are gathered in set-up, and batch i is
pool entry i mod pool, so the window holds none of the generator's own
work (the program's extract loop prepares its next batch on a host
thread while the card runs the current one).

``TokenBatches``: a pool of ``pool_batches`` batches of random ids drawn
on the device from the seed, the last row's final ``masked_tail``
positions masked out of the loss; step i takes batch i mod pool.
"""

from __future__ import annotations

import numpy as np
import torch
from PIL import Image, ImageDraw

COLORS = {"red": (255, 60, 60), "green": (60, 255, 60), "blue": (60, 60, 255),
          "yellow": (255, 255, 60), "cyan": (60, 255, 255), "magenta": (255, 60, 255),
          "grey": (128, 128, 128)}
SHAPES = ("cube", "sphere", "pyramid", "cone", "torus", "cylinder")
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], dtype=np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], dtype=np.float32)
IMG_START, IMG_END, IMG_PAD = 151857, 151858, 151859


def samples() -> list[tuple[str, str, str]]:
    """(prompt, rendered colour, rendered shape) for the 48 samples."""
    out = []
    colours = [c for c in COLORS if c != "grey"]
    for colour in colours:
        for shape in SHAPES:
            out.append((f"a photo of a {colour} {shape}", colour, shape))
    for colour in colours:
        out.append((f"a photo of a {colour} object", colour, "cube"))
    for shape in SHAPES:
        out.append((f"a photo of a grey {shape}", "grey", shape))
    return out


def render(colour: str, shape: str, size: int) -> Image.Image:
    """One primitive on a grey canvas (cube: square, sphere: disc, pyramid
    and cone: triangles, torus: thick ring, cylinder: box and top)."""
    img = Image.new("RGB", (size, size), color="grey")
    draw = ImageDraw.Draw(img)
    rgb = COLORS[colour]
    s = size / 200.0

    def pt(x, y):
        return (x * s, y * s)

    if shape == "cube":
        draw.rectangle([pt(50, 50), pt(150, 150)], fill=rgb, outline="black")
    elif shape == "sphere":
        draw.ellipse([pt(50, 50), pt(150, 150)], fill=rgb, outline="black")
    elif shape == "pyramid":
        draw.polygon([pt(100, 50), pt(50, 150), pt(150, 150)], fill=rgb, outline="black")
    elif shape == "cone":
        draw.polygon([pt(100, 50), pt(40, 150), pt(160, 150)], fill=rgb, outline="black")
    elif shape == "torus":
        draw.ellipse([pt(50, 50), pt(150, 150)], fill=None, outline=rgb,
                     width=max(1, round(20 * s)))
    elif shape == "cylinder":
        draw.rectangle([pt(60, 50), pt(140, 150)], fill=rgb, outline="black")
        draw.ellipse([pt(60, 40), pt(140, 60)], fill=rgb, outline="black")
    else:
        raise ValueError(f"unknown shape {shape!r}")
    return img


def preprocess(img: Image.Image, size: int) -> np.ndarray:
    """[3, size, size] f32: bicubic resize, CLIP mean and std."""
    arr = np.asarray(img.convert("RGB").resize((size, size), Image.BICUBIC),
                     dtype=np.float32) / 255.0
    return np.transpose((arr - CLIP_MEAN) / CLIP_STD, (2, 0, 1))


def encode(prompt: str, n_queries: int, vocab: int) -> tuple[list[int], int, int]:
    """(ids, first image position, last text token index) of one query.
    Bytes are ids 1..256; the special ids are taken modulo the vocabulary."""
    def text(t):
        return [1 + b for b in t.encode("utf-8")]

    ids = text("Picture 1: ") + [IMG_START % vocab]
    start = len(ids)
    ids += [IMG_PAD % vocab] * n_queries + [IMG_END % vocab] + text("\n")
    ids += text(prompt)
    return ids, start, len(ids) - 1


class CaptureInputs:
    """The capture mix's host arrays; ``batch(i)`` is the i-th batch."""

    def __init__(self, mix: dict, image_size: int, n_queries: int, vocab: int, seed: int):
        self.batch_size, self.seed = mix["batch_size"], seed
        rows = samples()
        enc = [encode(p, n_queries, vocab) for p, _, _ in rows]
        longest = max(len(ids) for ids, _, _ in enc)
        m = mix["pad_multiple"]
        self.seq = -(-(longest + 1) // m) * m
        n = len(rows)
        self.ids = np.zeros((n, self.seq), np.int64)
        self.mask = np.zeros((n, self.seq), np.int32)
        self.last = np.zeros((n,), np.int64)
        self.img_pos = np.zeros((n, n_queries), np.int64)
        for j, (ids, start, last) in enumerate(enc):
            self.ids[j, :len(ids)] = ids
            self.mask[j, :len(ids)] = 1
            self.last[j] = last
            self.img_pos[j] = np.arange(start, start + n_queries)
        self.images = np.stack([preprocess(render(c, s, mix["render_size"]), image_size)
                                for _, c, s in rows])
        self.n = n
        self.pool = [self._gather(self.rows(i)) for i in range(mix["pool_batches"])]

    def rows(self, i: int) -> np.ndarray:
        """The sample indices of batch i: the stream of seeded
        permutations of the samples, cut into batches."""
        b = self.batch_size
        start, out = i * b, []
        while len(out) < b:
            epoch, at = divmod(start + len(out), self.n)
            perm = np.random.default_rng([self.seed % (1 << 63), epoch]).permutation(self.n)
            out.extend(perm[at:at + b - len(out)].tolist())
        return np.asarray(out)

    def _gather(self, r: np.ndarray) -> tuple:
        return self.ids[r], self.mask[r], self.last[r], self.images[r], self.img_pos[r]

    def batch(self, i: int) -> tuple:
        """(ids, attn_mask, last_token_idx, images, image_positions) of
        batch i."""
        return self.pool[i % len(self.pool)]


class TokenBatches:
    """The training mix's device batches."""

    def __init__(self, mix: dict, vocab: int, seed: int, device):
        b, t, pool = mix["batch_size"], mix["seq_len"], mix["pool_batches"]
        gen = torch.Generator(device=device).manual_seed((seed + 1) % (1 << 63))
        self.ids = torch.randint(1, vocab, (pool, b, t), generator=gen, device=device)
        self.mask = torch.ones((pool, b, t), dtype=torch.int32, device=device)
        self.mask[:, -1, t - mix["masked_tail"]:] = 0
        self.pool = pool

    def batch(self, i: int) -> dict:
        k = i % self.pool
        return {"input_ids": self.ids[k], "attn_mask": self.mask[k]}
