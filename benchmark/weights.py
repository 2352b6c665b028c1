"""Seeded random weights in the port's parameter tree, made on the card.

The tree has the port's names and layouts (``init_params``: [in, out]
weights, each stack of layers one [L, ...] tensor): the program takes it
as its input, and the reference reads the same tensors.  Each matrix is
one ``torch.randn`` call on the device from one ``torch.Generator``,
scaled by 1/sqrt(fan-in) (0.02 for the embeddings and the resampler's
queries), drawn in the served dtype; norms are ones, biases zeros, the
resampler's position tables 2-D sincos.  The generator's state before
each draw is kept, so ``initial`` gives a leaf's initial value again
without holding a copy of the tree.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.work import Model


def seed_of(seed: int) -> int:
    """A generator seed from any whole number (``--seed`` may pass 2**31)."""
    return int(seed) % (1 << 63)


def sincos_2d(grid: int, dim: int) -> np.ndarray:
    """[grid*grid, dim] 2-D sincos table (MAE layout, as Qwen-VL's
    resampler): the first half encodes the column, the second the row,
    each [sin | cos] over dim/4 frequencies."""
    omega = 1.0 / (10000 ** (np.arange(dim // 4, dtype=np.float64) / (dim / 4)))
    coords = np.arange(grid, dtype=np.float64)
    out = []
    for pos in (np.tile(coords, grid), np.repeat(coords, grid)):
        ang = np.outer(pos, omega)
        out += [np.sin(ang), np.cos(ang)]
    return np.concatenate(out, axis=1).astype(np.float32)


def resize_table(pos: np.ndarray, dst_grid: int) -> np.ndarray:
    """A square [g*g, dim] table resized to [dst*dst, dim] by bicubic
    interpolation (align_corners=False), as Qwen-VL's ``get_abs_pos``."""
    src = math.isqrt(pos.shape[0])
    if src == dst_grid:
        return pos
    t = torch.from_numpy(pos).reshape(1, src, src, -1).permute(0, 3, 1, 2)
    t = F.interpolate(t, size=(dst_grid, dst_grid), mode="bicubic", align_corners=False)
    return t.permute(0, 2, 3, 1).reshape(dst_grid * dst_grid, -1).numpy()


class Weights:
    """``build()`` draws the tree; ``initial(path)`` makes one leaf again."""

    def __init__(self, md: Model, seed: int, device, dtype: torch.dtype,
                 with_visual: bool = True):
        self.md, self.device, self.dtype, self.with_visual = md, torch.device(device), dtype, with_visual
        self.gen = torch.Generator(device=self.device).manual_seed(seed_of(seed))
        self.states: dict[str, tuple] = {}   # drawn leaves: generator state, shape, scale
        self.consts: dict[str, tuple] = {}   # constant leaves: shape, value

    def _dense(self, path: str, shape, scale=None) -> torch.Tensor:
        if scale is None:
            scale = 1.0 / math.sqrt(shape[-2] if len(shape) > 1 else shape[0])
        self.states[path] = (self.gen.get_state(), tuple(shape), scale)
        w = torch.randn(shape, generator=self.gen, device=self.device, dtype=self.dtype)
        return w.mul_(scale)

    def initial(self, path: str) -> torch.Tensor:
        """The leaf at ``path`` ("layers/mlp_w1") as ``build`` made it."""
        if path in self.consts:
            shape, value = self.consts[path]
            return self._const(path, shape, value)
        state, shape, scale = self.states[path]
        gen = torch.Generator(device=self.device)
        gen.set_state(state)
        w = torch.randn(shape, generator=gen, device=self.device, dtype=self.dtype)
        return w.mul_(scale)

    def _const(self, path: str, shape, value: float) -> torch.Tensor:
        self.consts[path] = (tuple(shape), value)
        return torch.full(shape, value, device=self.device, dtype=self.dtype)

    def _table(self, array: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(array).to(device=self.device, dtype=self.dtype)

    def build(self) -> dict:
        md = self.md
        h, n = md.hidden, md.layers
        tree = {
            "wte": self._dense("wte", (md.vocab, h), 0.02),
            "layers": {
                "ln_1": self._const("layers/ln_1", (n, h), 1.0),
                "ln_2": self._const("layers/ln_2", (n, h), 1.0),
                "attn_qkv_w": self._dense("layers/attn_qkv_w", (n, h, 3 * h)),
                "attn_qkv_b": self._const("layers/attn_qkv_b", (n, 3 * h), 0.0),
                "attn_proj_w": self._dense("layers/attn_proj_w", (n, h, h)),
                "mlp_w1": self._dense("layers/mlp_w1", (n, h, md.ff_half)),
                "mlp_w2": self._dense("layers/mlp_w2", (n, h, md.ff_half)),
                "mlp_proj_w": self._dense("layers/mlp_proj_w", (n, md.ff_half, h)),
            },
            "ln_f": self._const("ln_f", (h,), 1.0),
            "lm_head": self._dense("lm_head", (h, md.vocab)),
        }
        if self.with_visual:
            tree["visual"] = self._visual()
        return tree

    def _visual(self) -> dict:
        md = self.md
        w, d, n, mlp = md.width, md.out_dim, md.vit_layers, md.mlp_dim
        q_grid = math.isqrt(md.n_queries)

        def consts(prefix: str, shapes: dict) -> dict:
            """Norm weights (``*_w``) ones, biases and norm offsets zeros."""
            return {k: self._const(f"{prefix}/{k}", shape,
                                   1.0 if k.startswith("ln") and k.endswith("_w") else 0.0)
                    for k, shape in shapes.items()}

        blocks = {
            **consts("visual/blocks", {"ln_1_w": (n, w), "ln_1_b": (n, w), "ln_2_w": (n, w),
                                       "ln_2_b": (n, w), "attn_qkv_b": (n, 3 * w),
                                       "attn_proj_b": (n, w), "mlp_fc_b": (n, mlp),
                                       "mlp_proj_b": (n, w)}),
            "attn_qkv_w": self._dense("visual/blocks/attn_qkv_w", (n, w, 3 * w)),
            "attn_proj_w": self._dense("visual/blocks/attn_proj_w", (n, w, w)),
            "mlp_fc_w": self._dense("visual/blocks/mlp_fc_w", (n, w, mlp)),
            "mlp_proj_w": self._dense("visual/blocks/mlp_proj_w", (n, mlp, w)),
        }
        table = sincos_2d(q_grid, d)
        resampler = {
            "query": self._dense("visual/resampler/query", (md.n_queries, d), 0.02),
            "q_pos": self._table(table),
            "kv_pos": self._table(resize_table(table, md.image_size // md.patch)),
            "kv_proj_w": self._dense("visual/resampler/kv_proj_w", (w, d)),
            **consts("visual/resampler", {"ln_q_w": (d,), "ln_q_b": (d,), "ln_kv_w": (d,),
                                          "ln_kv_b": (d,), "attn_q_b": (d,), "attn_k_b": (d,),
                                          "attn_v_b": (d,), "attn_out_b": (d,)}),
        }
        for name in ("attn_q", "attn_k", "attn_v", "attn_out"):
            resampler[f"{name}_w"] = self._dense(f"visual/resampler/{name}_w", (d, d))
        return {
            "patch_w": self._dense("visual/patch_w", (3 * md.patch ** 2, w)),
            "pos_embed": self._dense("visual/pos_embed", (md.n_patches, w), 0.02),
            **consts("visual", {"ln_pre_w": (w,), "ln_pre_b": (w,), "ln_post_w": (d,),
                                "ln_post_b": (d,)}),
            "blocks": blocks,
            "resampler": resampler,
            "proj": self._dense("visual/proj", (d, d)),
        }
