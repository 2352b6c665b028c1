"""Qwen-VL visual encoder in PyTorch: ViT-bigG + cross-attention resampler.

Counterpart of ``tdax/models/qwen_vl/vit.py``: 448x448 input, patch-14
embed (reshape + one matmul, as tdax does it — not ``F.conv2d``, whose
cuDNN path runs f32 as TF32), learned absolute positions, pre-LN blocks
with a tanh-GELU MLP, then the 256-query resampler with 2-D sincos
positions on both sides, ``ln_post`` and the output projection.

Numerics follow tdax exactly: layer norm with population variance,
normalized in f32, cast to the model dtype, *then* ``* w + b`` in that
dtype; GELU is ``jax.nn.gelu``'s default tanh approximation.

Under tp a block and the resampler hold their rank's heads and MLP
columns (the head count from the weights' shapes); the row-parallel
products are summed over the tp group (``tp.tp_row_product``) and
their biases, replicated, added once after the sum; the inputs of the
column-parallel products pass through ``tp.tp_input`` (their gradient
summed over tp).  Under FSDP (``fsdp.gathering``) a block, the
resampler and the tower gather their dp-sharded leaves where they read
them.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from tdax_torch.models.qwen_vl import fsdp
from tdax_torch.models.qwen_vl.config import VisualConfig
from tdax_torch.models.qwen_vl.quantize import layer_at, qdot
from tdax_torch.models.qwen_vl.tp import tp_input, tp_row_product
from tdax_torch.ops.flash_attention import AttnSpec, mha
from tdax_torch.utils.log import span


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)  # population variance
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * w + b


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (approximate=True) in f32, cast back."""
    return F.gelu(x.float(), approximate="tanh").to(x.dtype)


def patch_embed(images: torch.Tensor, w: torch.Tensor, cfg: VisualConfig) -> torch.Tensor:
    """images [B, 3, S, S] -> patches [B, n_patches, width] via one matmul.

    w is the conv kernel flattened to [3 * p * p, width] (channel-major)."""
    b = images.shape[0]
    p, g = cfg.patch_size, cfg.grid_size
    x = images.reshape(b, 3, g, p, g, p).permute(0, 2, 4, 1, 3, 5).reshape(b, g * g, 3 * p * p)
    return qdot(x, w).to(images.dtype)


def _mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, hd: int) -> torch.Tensor:
    """Dense multi-head attention on [B, T, D] inputs (already projected),
    D / hd heads.  The head split is a view: the kernel reads the strided
    qkv split."""
    b, tq, d = q.shape
    tk = k.shape[1]
    n_heads = d // hd
    out = mha(q.reshape(b, tq, n_heads, hd), k.reshape(b, tk, n_heads, hd),
              v.reshape(b, tk, n_heads, hd), AttnSpec(kv_valid=None, causal=False))
    return out.reshape(b, tq, d)


def _row(x: torch.Tensor, w, width: int) -> torch.Tensor:
    """A row-parallel product: ``qdot`` with whole weights (x ``width``
    wide), summed over the tp group with this rank's rows of them."""
    return qdot(x, w) if x.shape[-1] == width else tp_row_product(x, w)


def _col(x: torch.Tensor, w, width: int) -> torch.Tensor:
    """A column-parallel product's input: the rank holds a shard of ``w``
    when its output is narrower than ``width``."""
    return tp_input(x, (w["q"] if isinstance(w, dict) else w).shape[-1] < width)


def vit_block(x: torch.Tensor, layer: dict, cfg: VisualConfig) -> torch.Tensor:
    layer = fsdp.leaves(layer, ("visual", "blocks"))
    h = layer_norm(x, layer["ln_1_w"], layer["ln_1_b"], cfg.layer_norm_eps)
    h = _col(h, layer["attn_qkv_w"], 3 * cfg.width)
    qkv = qdot(h, layer["attn_qkv_w"]) + layer["attn_qkv_b"]
    q, k, v = qkv.split(qkv.shape[-1] // 3, dim=-1)
    attn = _mha(q, k, v, cfg.width // cfg.heads)
    attn = _row(attn, layer["attn_proj_w"], cfg.width) + layer["attn_proj_b"]
    x = x + attn
    h = layer_norm(x, layer["ln_2_w"], layer["ln_2_b"], cfg.layer_norm_eps)
    h = qdot(_col(h, layer["mlp_fc_w"], cfg.mlp_dim), layer["mlp_fc_w"]) + layer["mlp_fc_b"]
    h = gelu_tanh(h)
    h = _row(h, layer["mlp_proj_w"], cfg.mlp_dim) + layer["mlp_proj_b"]
    return x + h


def sincos_2d(grid: int, dim: int) -> np.ndarray:
    """2-D sincos positional embedding [grid*grid, dim] (MAE layout, as
    Qwen-VL's Resampler): the first dim/2 block encodes the column (w)
    coordinate and the second the row (h), each [sin | cos] over dim/4
    frequencies."""
    assert dim % 4 == 0
    omega = 1.0 / (10000 ** (np.arange(dim // 4, dtype=np.float64) / (dim / 4)))
    coords = np.arange(grid, dtype=np.float64)
    out = []
    for pos in (np.tile(coords, grid),      # w varies fastest -> first half
                np.repeat(coords, grid)):   # h -> second half
        ang = np.outer(pos, omega)
        out += [np.sin(ang), np.cos(ang)]
    return np.concatenate(out, axis=1).astype(np.float32)


def interp_pos_embed(pos: np.ndarray, dst_grid: int) -> np.ndarray:
    """Qwen-VL's ``get_abs_pos``: bicubic-interpolate a square
    [src_grid**2, dim] table to [dst_grid**2, dim] (align_corners=False).
    Host-side, on the CPU, as in tdax."""
    src_grid = int(np.sqrt(pos.shape[0]))
    assert src_grid * src_grid == pos.shape[0], "pos table must be square"
    if src_grid == dst_grid:
        return np.asarray(pos, dtype=np.float32)
    t = torch.from_numpy(np.asarray(pos, dtype=np.float32))
    t = t.reshape(1, src_grid, src_grid, -1).permute(0, 3, 1, 2)
    t = F.interpolate(t, size=(dst_grid, dst_grid), mode="bicubic", align_corners=False)
    return t.permute(0, 2, 3, 1).reshape(dst_grid * dst_grid, -1).numpy()


def resampler(x: torch.Tensor, params: dict, cfg: VisualConfig) -> torch.Tensor:
    """x [B, n_patches, width] -> [B, n_queries, output_dim]."""
    params = fsdp.leaves(params, ("visual", "resampler"))
    d = cfg.output_dim
    kv = qdot(x, params["kv_proj_w"])
    kv = layer_norm(kv, params["ln_kv_w"], params["ln_kv_b"], cfg.layer_norm_eps)
    q = layer_norm(params["query"], params["ln_q_w"], params["ln_q_b"], cfg.layer_norm_eps)
    b = x.shape[0]
    qb = (q + params["q_pos"])[None].expand(b, cfg.n_queries, d).to(x.dtype)
    kb = kv + params["kv_pos"].to(x.dtype)
    # qb is a broadcast view (stride 0 over the batch): qdot's int8 path
    # collapses it to rows, copying where it must
    qh = qdot(_col(qb, params["attn_q_w"], d), params["attn_q_w"]) + params["attn_q_b"]
    kh = qdot(_col(kb, params["attn_k_w"], d), params["attn_k_w"]) + params["attn_k_b"]
    vh = qdot(_col(kv, params["attn_v_w"], d), params["attn_v_w"]) + params["attn_v_b"]
    out = _mha(qh, kh, vh, d // cfg.resampler_heads)
    return _row(out, params["attn_out_w"], d) + params["attn_out_b"]


def visual_encode(images: torch.Tensor, params: dict, cfg: VisualConfig) -> torch.Tensor:
    """images [B, 3, S, S] -> visual tokens [B, n_queries, output_dim].

    The tower computes in the model's dtype (that of the ln_pre
    weights), not the input images' dtype, as tdax does."""
    with span("visual"):
        params = fsdp.leaves(params, ("visual",))
        dtype = params["ln_pre_w"].dtype
        x = patch_embed(images.to(dtype), params["patch_w"], cfg)
        x = x + params["pos_embed"].to(x.dtype)
        x = layer_norm(x, params["ln_pre_w"], params["ln_pre_b"], cfg.layer_norm_eps)
        blocks = params["blocks"]
        for i in range(cfg.layers):
            x = vit_block(x, layer_at(blocks, i), cfg)
        x = resampler(x, params["resampler"], cfg)
        x = layer_norm(x, params["ln_post_w"], params["ln_post_b"], cfg.layer_norm_eps)
        return qdot(x, params["proj"]).to(dtype)
