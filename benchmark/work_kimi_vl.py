"""What one capture batch of Kimi-VL asks of the card, from the
configuration file's shapes alone: its model FLOPs and three bounds, the
least time its grouped expert products, its latent-attention forwards
and MoonViT's attention forwards need (``benchmark.roofline``'s peaks).

FLOPs count each product's 2 m k n and attention's visible (query, key)
pairs (causal in the decoder), every position of the padded batch, the
router, no LM head: MoonViT's blocks (qkv, the output projection, the
MLP, attention over each image's patches) and its patch embedding, the
projector, then per decoder layer latent attention (W_q, W_kv_a, W_kv_b,
W_o, q.k over 192 columns and PV over 128) and the FFN (the dense
SwiGLU, or the router, the k routed experts a token and the shared
experts).
"""

from __future__ import annotations

import dataclasses

from benchmark import roofline
from benchmark.work import Work


@dataclasses.dataclass
class KimiWork(Work):
    """A capture batch: ``Work`` plus the three kernels' bounds, seconds."""
    expert_bound_s: float = 0.0
    mla_attn_bound_s: float = 0.0
    vit_attn_bound_s: float = 0.0


def _dense(m: int, k: int, n: int) -> float:
    return 2.0 * m * k * n


def expert_bound_s(cfg: dict, tokens: int, itemsize: int = 2) -> float:
    """The grouped products of every expert layer: 3 products of 2 (k
    tokens) H F flops; bytes the E experts' weights once a layer, and the
    routed rows read and written once by each product (x and the
    gate-and-up output, the SwiGLU's output and the down output)."""
    h, f, e = cfg["hidden_size"], cfg["moe_intermediate_size"], cfg["n_routed_experts"]
    layers = cfg["num_hidden_layers"] - cfg["first_k_dense_replace"]
    rows = cfg["num_experts_per_tok"] * tokens
    flops = layers * 3 * _dense(rows, h, f)
    weights = e * (h * 2 * f + f * h)
    moved = rows * (h + 2 * f) + rows * (f + h)
    nbytes = layers * (weights + moved) * itemsize
    return max(flops / roofline.BF16_PEAK, nbytes / roofline.HBM_BYTES_PER_S)


def mla_attn_bound_s(cfg: dict, batch: int, seq: int) -> float:
    """Every layer's causal latent-attention forward over the batch."""
    hd = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    return cfg["num_hidden_layers"] * roofline.attn_fwd_bound(
        batch, seq, seq, cfg["num_attention_heads"], hd, True, 2, hd_v=cfg["v_head_dim"])


def vit_attn_bound_s(cfg: dict, batch: int) -> float:
    """Every MoonViT block's attention forward over the batch's images:
    each image's patches attend to each other, not causal, at the
    tower's head width (the kernel's padding to a wider tile not
    credited)."""
    v = cfg["vision_config"]
    patches = (v["image_size"] // v["patch_size"]) ** 2
    heads = v["num_attention_heads"]
    return v["num_hidden_layers"] * roofline.attn_fwd_bound(
        batch, patches, patches, heads, v["hidden_size"] // heads, False, 2)


def flops(cfg: dict, batch: int, seq: int) -> float:
    v = cfg["vision_config"]
    w, mlp, p = v["hidden_size"], v["intermediate_size"], v["patch_size"]
    patches = (v["image_size"] // p) ** 2
    n_img = batch * patches
    vit = v["num_hidden_layers"] * (_dense(n_img, w, 3 * w) + _dense(n_img, w, w)
                                    + 2 * _dense(n_img, w, mlp) + 4.0 * batch * patches ** 2 * w)
    vit += _dense(n_img, 3 * p * p, w)
    kh, kw = v["merge_kernel_size"]
    merged, m = n_img // (kh * kw), kh * kw * w
    projector = _dense(merged, m, m) + _dense(merged, m, cfg["hidden_size"])
    h, nh, n = cfg["hidden_size"], cfg["num_attention_heads"], batch * seq
    dn, dr, dv, r = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"],
                     cfg["kv_lora_rank"])
    attn = (_dense(n, h, nh * (dn + dr)) + _dense(n, h, r + dr) + _dense(n, r, nh * (dn + dv))
            + _dense(n, nh * dv, h)
            + 2.0 * batch * nh * roofline.visible_pairs(seq, seq, True) * (dn + dr + dv))
    dense = 3 * _dense(n, h, cfg["intermediate_size"])
    shared = cfg["moe_intermediate_size"] * cfg["n_shared_experts"]
    expert = (_dense(n, h, cfg["n_routed_experts"])
              + 3 * _dense(cfg["num_experts_per_tok"] * n, h, cfg["moe_intermediate_size"])
              + 3 * _dense(n, h, shared))
    d = cfg["first_k_dense_replace"]
    decoder = cfg["num_hidden_layers"] * attn + d * dense + (cfg["num_hidden_layers"] - d) * expert
    return vit + projector + decoder


def capture_batch(cfg: dict, batch: int, seq: int) -> KimiWork:
    """One capture batch: ``batch`` images of ``image_size`` and prompts
    of ``seq`` positions."""
    return KimiWork(flops=flops(cfg, batch, seq),
                    expert_bound_s=expert_bound_s(cfg, batch * seq),
                    mla_attn_bound_s=mla_attn_bound_s(cfg, batch, seq),
                    vit_attn_bound_s=vit_attn_bound_s(cfg, batch))
