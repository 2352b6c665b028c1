"""Kimi-VL's decoder (DeepSeek-V3's layout): latent attention, one dense
SwiGLU layer, then expert layers.

No counterpart in tdax.  A block is pre-RMSNorm attention and pre-RMSNorm
FFN, each added to the residual stream.  RMSNorm normalises in f32,
casts to x's type, then scales (the decoder's ``rms_norm``).

Latent attention (MLA), with no q compression (``q_lora_rank`` null):

- q = n W_q: per head [128 without rotary | 64 with];
- n W_kv_a = [c (512) | k_pe (64)]; c = RMSNorm(c) (``kv_norm_eps``);
  c W_kv_b: per head [k_nope (128) | v (128)]; k_pe is every head's;
- the rotary (theta 800000, no scaling) turns q_pe and k_pe as pairs of
  neighbouring columns (2j, 2j + 1) by position x f_j, f_j = theta^(-2 j
  / 64), and lays each out as [first of the pairs | second of the
  pairs], as DeepSeek-V3's modeling code does with its reshape before
  ``rotate_half``; in f32, cast back;
- causal attention over q = [q_nope | q_pe] and k = [k_nope | k_pe] (192
  columns, scale 1 / sqrt(192)) with v of 128 (``mha``: the sm90
  forward's latent-attention kernel), then W_o.

The FFN of the first ``first_k_dense_replace`` layers is a SwiGLU
(down(SiLU(gate) * up), gate and up as one product); the others' is the
expert layer (``ops.moe``) plus the shared experts, one SwiGLU of
``shared_intermediate``.

Spans: each attention block, from its norm through W_o, is ``tdax.mla``;
each expert FFN, its norm and the shared experts with it, ``tdax.moe``;
the routing inside it ``tdax.route`` (``ops.moe``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tdax_torch.models.kimi_vl.config import KimiVLConfig
from tdax_torch.models.qwen_vl.decoder import rms_norm
from tdax_torch.ops import moe
from tdax_torch.ops.flash_attention import AttnSpec, mha
from tdax_torch.utils.log import span


def rope_cos_sin(t: int, dim: int, theta: float, device) -> tuple[torch.Tensor, torch.Tensor]:
    """cos, sin [T, dim / 2] f32 of positions 0..T-1."""
    inv = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim)
    angles = torch.arange(t, dtype=torch.float32, device=device)[:, None] * inv
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, T, n, d]: the pairs (2j, 2j + 1) turned by angle j, out as
    [first of each pair | second of each pair]; in f32, cast back."""
    xf = x.float().reshape(*x.shape[:-1], -1, 2)
    a, b = xf[..., 0], xf[..., 1]
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    return torch.cat([a * c - b * s, b * c + a * s], dim=-1).to(x.dtype)


def mla(x: torch.Tensor, layer: dict, cfg: KimiVLConfig, cos, sin,
        spec: AttnSpec) -> torch.Tensor:
    """The attention half of a block: x [B, T, H] -> its update [B, T, H]."""
    b, t, _ = x.shape
    nh, dn, dr, dv = cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    n = rms_norm(x, layer["attn_norm"], cfg.rms_norm_eps)
    q = (n @ layer["q_w"]).view(b, t, nh, dn + dr)
    ckv = n @ layer["kv_a_w"]
    c, k_pe = ckv.split([cfg.kv_lora_rank, dr], dim=-1)
    kv = (rms_norm(c, layer["kv_a_norm"], cfg.kv_norm_eps) @ layer["kv_b_w"]).view(b, t, nh,
                                                                                    dn + dv)
    q_pe = apply_rope(q[..., dn:], cos, sin)
    k_pe = apply_rope(k_pe.view(b, t, 1, dr), cos, sin)
    q = torch.cat([q[..., :dn], q_pe], dim=-1)
    k = torch.cat([kv[..., :dn], k_pe.expand(b, t, nh, dr)], dim=-1)
    out = mha(q, k, kv[..., dn:], spec)
    return out.reshape(b, t, nh * dv) @ layer["o_w"]


def swiglu(h: torch.Tensor, gate_up: torch.Tensor, down: torch.Tensor) -> torch.Tensor:
    gate, up = (h @ gate_up).chunk(2, dim=-1)
    return (F.silu(gate) * up) @ down


def ffn(x: torch.Tensor, params: dict, cfg: KimiVLConfig, i: int) -> torch.Tensor:
    """The FFN half of block ``i``: its update [B, T, H]."""
    if i < cfg.n_dense:
        dense = {k: v[i] for k, v in params["dense"].items()}
        n = rms_norm(x, params["layers"]["ffn_norm"][i], cfg.rms_norm_eps)
        return swiglu(n, dense["gate_up_w"], dense["down_w"])
    with span("moe"):
        layer = {k: v[i - cfg.n_dense] for k, v in params["moe"].items()}
        n = rms_norm(x, params["layers"]["ffn_norm"][i], cfg.rms_norm_eps)
        rows = n.reshape(-1, n.shape[-1])
        routed = moe.moe(rows, layer, cfg.num_experts_per_tok, cfg.routed_scaling_factor, i)
        shared = swiglu(rows, layer["shared_gate_up"], layer["shared_down"])
        return (routed + shared).view_as(x)


def decoder_capture(params: dict, x: torch.Tensor, cfg: KimiVLConfig, attn_mask: torch.Tensor,
                    last_token_idx: torch.Tensor) -> torch.Tensor:
    """Every block on x [B, T, H]: the capture [n_layers, B, H] of the
    last-token vector after each.  The ``tdax.decoder`` span."""
    b, t, _ = x.shape
    cos, sin = rope_cos_sin(t, cfg.qk_rope_head_dim, cfg.rope_theta, x.device)
    spec = AttnSpec(kv_valid=attn_mask, causal=True)
    rows = torch.arange(b, device=x.device)
    captures = []
    with span("decoder"):
        for i in range(cfg.num_layers):
            with span("mla"):
                x = x + mla(x, {k: v[i] for k, v in params["layers"].items()}, cfg, cos, sin, spec)
            x = x + ffn(x, params, cfg, i)
            captures.append(x[rows, last_token_idx])
    return torch.stack(captures)
