"""MoonViT, Kimi-VL's vision tower, with its patch merge and projector.

No counterpart in tdax.  As ``modeling_kimi_vl.py`` runs it on one
image of a fixed size:

- the patch embedding: 14-px patches, channel-major, times [3 p p,
  width] plus a bias (the convolution as one product, as the QWen
  tower's);
- the learned position table [pos_grid^2, width] (64 x 64), resized
  bicubically (align_corners False) to the image's patch grid and added;
- pre-LayerNorm blocks: attention over the image's patches (non-causal,
  one ``mha`` batch row an image) with 2-D rotary positions on q and k,
  then a tanh-GELU MLP;
- the final LayerNorm, the 2 x 2 merge of neighbouring patches into one
  token of 4 x width (in the order (r, c), (r, c + 1), (r + 1, c), (r +
  1, c + 1)), and the projector: LayerNorm per patch, Linear 4 width ->
  4 width, GELU (erf), Linear to the decoder's width.

The 2-D rotary: a head of hd columns is hd / 2 complex pairs of
neighbouring columns (2j, 2j + 1); pair 2i turns by the patch's column
times f_i and pair 2i + 1 by its row times f_i, f_i = theta^(-4 i / hd),
i < hd / 4.  It runs in f32 and casts back.

The resized table and the rotary tables depend on the grid alone: they
are built once per grid and table and kept beside the table (a weak
reference, so they go with the weights).  The LayerNorms and the bias,
GELU and residual epilogues are ``ops.vit_elementwise``'s (the kernels
on the card, the plain expressions on the CPU).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from tdax_torch.models.kimi_vl.config import MoonViTConfig
from tdax_torch.ops.flash_attention import AttnSpec, mha
from tdax_torch.ops.vit_elementwise import bias_epilogue_, layer_norm
from tdax_torch.utils.log import span

# the position table -> {grid: (resized table, rotary cos, rotary sin)}
_GRID_TABLES = WeakIdKeyDictionary()


def resize_pos(table: torch.Tensor, src: int, grid: int) -> torch.Tensor:
    """[src^2, w] -> [grid^2, w]: bicubic, align_corners False, in f32,
    cast back to the table's type (a copy where the sizes match, so that
    the cache beside the table holds no reference to it)."""
    if src == grid:
        return table.clone()
    t = table.float().reshape(1, src, src, -1).permute(0, 3, 1, 2)
    t = F.interpolate(t, size=(grid, grid), mode="bicubic", align_corners=False)
    return t.permute(0, 2, 3, 1).reshape(grid * grid, -1).to(table.dtype)


def rope_2d(grid: int, head_dim: int, theta: float, device) -> tuple[torch.Tensor, torch.Tensor]:
    """cos, sin [grid^2, head_dim / 2] f32 of the patches in row-major
    order: pair 2i the column's angle, pair 2i + 1 the row's."""
    freqs = 1.0 / theta ** (torch.arange(0, head_dim, 4, dtype=torch.float32,
                                         device=device)[: head_dim // 4] / head_dim)
    pos = torch.arange(grid, dtype=torch.float32, device=device)
    col = pos.repeat(grid)[:, None] * freqs          # [grid^2, hd / 4]
    row = pos.repeat_interleave(grid)[:, None] * freqs
    angles = torch.stack([col, row], dim=-1).reshape(grid * grid, head_dim // 2)
    return torch.cos(angles), torch.sin(angles)


def apply_rope_2d(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, T, nh, hd] as hd / 2 pairs of neighbouring columns, each
    turned by its angle (cos, sin [T, hd / 2]), in f32, cast back."""
    xf = x.float().reshape(*x.shape[:-1], -1, 2)
    a, b = xf[..., 0], xf[..., 1]
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    return torch.stack([a * c - b * s, a * s + b * c], dim=-1).flatten(-2).to(x.dtype)


def grid_tables(params: dict, cfg: MoonViTConfig, device):
    """(position table, cos, sin) at the image's grid, built once per grid
    and table."""
    table = params["pos_table"]
    held = _GRID_TABLES.setdefault(table, {})
    g = cfg.grid_size
    if g not in held:
        held[g] = (resize_pos(table, cfg.pos_grid, g),
                   *rope_2d(g, cfg.head_dim, cfg.rope_theta, device))
    return held[g]


def patch_embed(images: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                cfg: MoonViTConfig) -> torch.Tensor:
    """images [B, 3, S, S] -> [B, n_patches, width]: channel-major patches
    in row-major order, one product, the bias."""
    n = images.shape[0]
    p, g = cfg.patch_size, cfg.grid_size
    x = images.reshape(n, 3, g, p, g, p).permute(0, 2, 4, 1, 3, 5).reshape(n, g * g, 3 * p * p)
    return bias_epilogue_(x @ w, b)


def block(x: torch.Tensor, layer: dict, cfg: MoonViTConfig, cos, sin) -> torch.Tensor:
    n, t, w = x.shape
    h = layer_norm(x, layer["ln_1_w"], layer["ln_1_b"], cfg.layer_norm_eps)
    qkv = bias_epilogue_(h @ layer["qkv_w"], layer["qkv_b"])
    q, k, v = (z.reshape(n, t, cfg.heads, cfg.head_dim) for z in qkv.split(w, dim=-1))
    q, k = apply_rope_2d(q, cos, sin), apply_rope_2d(k, cos, sin)
    attn = mha(q, k, v, AttnSpec(kv_valid=None, causal=False)).reshape(n, t, w)
    x = bias_epilogue_(attn @ layer["proj_w"], layer["proj_b"], residual=x)
    h = layer_norm(x, layer["ln_2_w"], layer["ln_2_b"], cfg.layer_norm_eps)
    h = bias_epilogue_(h @ layer["fc_w"], layer["fc_b"], gelu=True)
    return bias_epilogue_(h @ layer["out_w"], layer["out_b"], residual=x)


def merge(x: torch.Tensor, cfg: MoonViTConfig) -> torch.Tensor:
    """[B, g^2, w] -> [B, (g / m)^2, m^2, w]: each m x m square of patches,
    row by row, as one token."""
    n, _, w = x.shape
    g, m = cfg.grid_size, cfg.merge
    x = x.reshape(n, g // m, m, g // m, m, w).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, (g // m) ** 2, m * m, w)


def project(x: torch.Tensor, params: dict, cfg: MoonViTConfig) -> torch.Tensor:
    """[B, tokens, m^2, w] -> [B, tokens, hidden]: LayerNorm per patch,
    Linear, GELU (erf), Linear."""
    h = layer_norm(x, params["proj_ln_w"], params["proj_ln_b"], cfg.layer_norm_eps)
    h = bias_epilogue_(h.flatten(-2) @ params["proj_1_w"], params["proj_1_b"])
    h = F.gelu(h.float()).to(h.dtype)
    return bias_epilogue_(h @ params["proj_2_w"], params["proj_2_b"])


def visual_encode(images: torch.Tensor, params: dict, cfg: MoonViTConfig) -> torch.Tensor:
    """images [B, 3, S, S] -> image tokens [B, n_queries, hidden], in the
    model's dtype (that of the patch weights).  The ``tdax.visual``
    span."""
    with span("visual"):
        dtype = params["patch_w"].dtype
        pos, cos, sin = grid_tables(params, cfg, images.device)
        x = patch_embed(images.to(dtype), params["patch_w"], params["patch_b"], cfg) + pos
        blocks = params["blocks"]
        for i in range(cfg.layers):
            x = block(x, {k: v[i] for k, v in blocks.items()}, cfg, cos, sin)
        x = layer_norm(x, params["ln_post_w"], params["ln_post_b"], cfg.layer_norm_eps)
        return project(merge(x, cfg), params, cfg)
