"""QWen decoder in PyTorch: RMSNorm, rotary, causal attention, SwiGLU.

Counterpart of ``tdax/models/qwen_vl/decoder.py``: pre-RMSNorm, fused
QKV with bias, rotary on the full head dim (base 10000, rotate-half),
causal attention through ``mha``, output projection without bias, then
pre-RMSNorm SwiGLU MLP (w1 * silu(w2) -> c_proj).

Layer weights stay stacked [n_layers, ...] as in tdax; a Python loop
over the layer index takes the place of ``lax.scan`` (indexing a
stacked weight is a view, no copy).  Weights are [in, out] and every
product goes through ``qdot``: ``x @ w`` for an fp weight (f32
accumulation, one cast to the working dtype), the int8 kernel for a
quantized one.

Under tp (``tdax_torch.parallel.mesh.shard_params``) a layer holds its
rank's heads and MLP columns: the head count comes from the weights'
shapes, and the two row-parallel products (``attn_proj_w``,
``mlp_proj_w``) are summed over the tp group (``tp.tp_row_product``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from tdax_torch.models.qwen_vl.config import QwenVLConfig
from tdax_torch.models.qwen_vl.quantize import is_quantized, layer_at, qdot
from tdax_torch.models.qwen_vl.tp import tp_row_product
from tdax_torch.ops.flash_attention import AttnSpec, mha


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """Normalize in f32, cast to x's dtype, then scale (tdax order)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * weight


def rotary_cos_sin(positions: torch.Tensor, head_dim: int,
                   base: float) -> tuple[torch.Tensor, torch.Tensor]:
    """positions [B, T] -> cos/sin [B, T, head_dim/2], float32."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=positions.device) / head_dim
    inv_freq = 1.0 / (base ** exponent)
    angles = positions.float()[..., None] * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, T, n_heads, head_dim]; rotate-half, in f32, cast back."""
    half = x.shape[-1] // 2
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    r1 = xf1 * cos - xf2 * sin
    r2 = xf2 * cos + xf1 * sin
    return torch.cat([r1, r2], dim=-1).to(x.dtype)


def local_heads(layers: dict, cfg: QwenVLConfig) -> int:
    """The attention heads the layer weights hold: ``cfg.num_heads``, or
    this rank's share under tp."""
    w = layers["attn_qkv_w"]
    return (w["q"] if is_quantized(w) else w).shape[-1] // (3 * cfg.head_dim)


def project_qkv(x: torch.Tensor, layer: dict, cfg: QwenVLConfig,
                cos: torch.Tensor, sin: torch.Tensor):
    """x [B, T, H] -> rotated (q, k, v) each [B, T, nh, hd], nh the heads
    the weights hold.  v stays a strided view of the fused projection;
    the kernel reads it as is."""
    b, t, _ = x.shape
    qkv = qdot(x, layer["attn_qkv_w"]) + layer["attn_qkv_b"]
    q, k, v = qkv.split(qkv.shape[-1] // 3, dim=-1)
    shape = (b, t, q.shape[-1] // cfg.head_dim, cfg.head_dim)
    q = apply_rotary(q.reshape(shape), cos, sin)
    k = apply_rotary(k.reshape(shape), cos, sin)
    return q, k, v.reshape(shape)


def attend(q, k, v, spec: AttnSpec, layer: dict, cfg: QwenVLConfig) -> torch.Tensor:
    """Attention + output projection: [B, Tq, nh, hd] -> [B, Tq, H]."""
    b, tq, nh, hd = q.shape
    out = mha(q, k, v, spec).reshape(b, tq, nh * hd)
    w = layer["attn_proj_w"]
    return qdot(out, w) if nh == cfg.num_heads else tp_row_product(out, w)


def mlp(x: torch.Tensor, layer: dict, cfg: QwenVLConfig) -> torch.Tensor:
    """QWen SwiGLU: c_proj(w1(x) * silu(w2(x)))."""
    a1 = qdot(x, layer["mlp_w1"])
    a2 = qdot(x, layer["mlp_w2"])
    inter = a1 * F.silu(a2.float()).to(x.dtype)
    w = layer["mlp_proj_w"]
    return qdot(inter, w) if inter.shape[-1] == cfg.ff_half else tp_row_product(inter, w)


def block_kv(x: torch.Tensor, layer: dict, cfg: QwenVLConfig,
             cos: torch.Tensor, sin: torch.Tensor, spec: AttnSpec):
    """One block; returns (x, this layer's rotated k, v) for a KV cache."""
    h1 = rms_norm(x, layer["ln_1"], cfg.layer_norm_eps)
    q, k, v = project_qkv(h1, layer, cfg, cos, sin)
    x = x + attend(q, k, v, spec, layer, cfg)
    h2 = rms_norm(x, layer["ln_2"], cfg.layer_norm_eps)
    return x + mlp(h2, layer, cfg), k, v


def block(x: torch.Tensor, layer: dict, cfg: QwenVLConfig,
          cos: torch.Tensor, sin: torch.Tensor, spec: AttnSpec) -> torch.Tensor:
    return block_kv(x, layer, cfg, cos, sin, spec)[0]


def _rotary_and_spec(x: torch.Tensor, cfg: QwenVLConfig, attn_mask: torch.Tensor):
    b, t, _ = x.shape
    positions = torch.arange(t, device=x.device)[None, :].expand(b, t)
    cos, sin = rotary_cos_sin(positions, cfg.head_dim, cfg.rope_base)
    return cos, sin, AttnSpec(kv_valid=attn_mask, causal=True)


def decoder_capture(stacked_layers: dict, x: torch.Tensor, cfg: QwenVLConfig,
                    attn_mask: torch.Tensor,
                    last_token_idx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Run all blocks; return (final hidden [B, T, H], capture
    [n_layers, B, H] of the last-token vector after each block).  The
    gather of row ``last_token_idx`` equals tdax's one-hot contraction."""
    cos, sin, spec = _rotary_and_spec(x, cfg, attn_mask)
    rows = torch.arange(x.shape[0], device=x.device)
    captures = []
    for i in range(cfg.num_layers):
        x = block(x, layer_at(stacked_layers, i), cfg, cos, sin, spec)
        captures.append(x[rows, last_token_idx])
    return x, torch.stack(captures)


def decoder(stacked_layers, x: torch.Tensor, cfg: QwenVLConfig,
            attn_mask: torch.Tensor, remat: bool = False) -> torch.Tensor:
    """Plain depth loop without capture (training / generation path).

    ``remat=True`` wraps each block in ``torch.utils.checkpoint``
    (non-reentrant): the backward keeps only each block's input and
    replays the block, one more flash forward per layer included.  tdax
    instead saves the dots and the flash residuals (``remat_policy``);
    the values are the same, the recompute is not."""
    cos, sin, spec = _rotary_and_spec(x, cfg, attn_mask)
    for i in range(cfg.num_layers):
        layer = layer_at(stacked_layers, i)
        if remat:
            x = torch.utils.checkpoint.checkpoint(block, x, layer, cfg, cos, sin, spec,
                                                  use_reentrant=False)
        else:
            x = block(x, layer, cfg, cos, sin, spec)
    return x
