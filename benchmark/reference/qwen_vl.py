"""Plain f32 reference of Qwen-VL-Chat's capture forward.

Written from the published architecture, in plain ``torch`` operations
and f32 throughout (TF32 off): the ViT-bigG tower (patch embedding as
one product over channel-major patches, learned positions, pre-LN blocks
with a tanh-GELU MLP), the 256-query cross-attention resampler with 2-D
sincos positions on queries and keys, ``ln_post`` and the projection;
then the QWen decoder (RMSNorm, fused QKV with bias, rotary on the whole
head, causal attention over the valid keys, output projection, SwiGLU
``w1 * silu(w2)``), the image's visual tokens in place of its pad span.
Attention forms the full score matrix and its softmax.

It reads the weights tree as the benchmark made it (bf16 values, or the
configuration's rounding of them through ``numerics``), one layer at a
time, so only a layer's weights exist in f32 at once.  It imports
nothing of the program.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def exact_f32() -> None:
    """Products in true f32: no TF32, no reduced-precision reductions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def layer_norm(x, w, b, eps):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w.float() + b.float()


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w.float()


def attention(q, k, v, key_valid=None, causal=False):
    """q [B, Tq, nh, hd], k and v [B, Tk, nh, hd] -> [B, Tq, nh, hd]."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    allowed = torch.ones(scores.shape[-2:], dtype=torch.bool, device=q.device)
    if causal:
        allowed = allowed.tril()
    allowed = allowed[None, None]
    if key_valid is not None:
        allowed = allowed & (key_valid > 0)[:, None, None, :]
    scores = scores.masked_fill(~allowed, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, -1), v)


def rotary(x, positions, base):
    """Rotate-half rotary embedding on the whole head dim; x [B, T, nh, hd]."""
    hd = x.shape[-1]
    inv = 1.0 / base ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd)
    ang = positions.float()[:, None] * inv
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


class Model:
    """The forward over a weights tree under ``numerics``."""

    def __init__(self, params: dict, md, numerics, eps: float = 1e-6, rope_base: float = 10000.0):
        self.p, self.md, self.num, self.eps, self.base = params, md, numerics, eps, rope_base

    def dense(self, x, key, w, b=None):
        y = self.num.matmul(x, key, w)
        return y if b is None else y + b.float()

    # --- visual tower -------------------------------------------------
    def vit_block(self, x, i):
        blk, md = self.p["visual"]["blocks"], self.md
        at = {k: v[i] for k, v in blk.items()}
        h = layer_norm(x, at["ln_1_w"], at["ln_1_b"], self.eps)
        qkv = self.dense(h, "attn_qkv_w", at["attn_qkv_w"], at["attn_qkv_b"])
        b, t, _ = x.shape
        nh = md.vit_heads
        q, k, v = (z.reshape(b, t, nh, -1) for z in qkv.chunk(3, dim=-1))
        a = attention(q, k, v).reshape(b, t, -1)
        x = x + self.dense(a, "attn_proj_w", at["attn_proj_w"], at["attn_proj_b"])
        h = layer_norm(x, at["ln_2_w"], at["ln_2_b"], self.eps)
        h = F.gelu(self.dense(h, "mlp_fc_w", at["mlp_fc_w"], at["mlp_fc_b"]), approximate="tanh")
        return x + self.dense(h, "mlp_proj_w", at["mlp_proj_w"], at["mlp_proj_b"])

    def resampler(self, x):
        r, md = self.p["visual"]["resampler"], self.md
        kv = layer_norm(self.dense(x, "kv_proj_w", r["kv_proj_w"]), r["ln_kv_w"], r["ln_kv_b"],
                        self.eps)
        q = layer_norm(r["query"].float(), r["ln_q_w"], r["ln_q_b"], self.eps)
        b = x.shape[0]
        qb = (q + r["q_pos"].float())[None].expand(b, -1, -1)
        kb = kv + r["kv_pos"].float()
        nh = md.resampler_heads
        qh = self.dense(qb, "attn_q_w", r["attn_q_w"], r["attn_q_b"])
        kh = self.dense(kb, "attn_k_w", r["attn_k_w"], r["attn_k_b"])
        vh = self.dense(kv, "attn_v_w", r["attn_v_w"], r["attn_v_b"])
        a = attention(*(z.reshape(b, z.shape[1], nh, -1) for z in (qh, kh, vh)))
        return self.dense(a.reshape(b, qb.shape[1], -1), "attn_out_w", r["attn_out_w"],
                          r["attn_out_b"])

    def visual(self, images):
        vp, md = self.p["visual"], self.md
        b, p, g = images.shape[0], md.patch, md.image_size // md.patch
        patches = (images.float().reshape(b, 3, g, p, g, p).permute(0, 2, 4, 1, 3, 5)
                   .reshape(b, g * g, 3 * p * p))
        x = self.dense(patches, "patch_w", vp["patch_w"]) + vp["pos_embed"].float()
        x = layer_norm(x, vp["ln_pre_w"], vp["ln_pre_b"], self.eps)
        for i in range(md.vit_layers):
            x = self.vit_block(x, i)
        x = layer_norm(self.resampler(x), vp["ln_post_w"], vp["ln_post_b"], self.eps)
        return self.dense(x, "proj", vp["proj"])

    # --- decoder ------------------------------------------------------
    def embed(self, ids):
        wte = self.p["wte"]
        return self.num.rows("wte", wte[ids], self.num.table_scale("wte", wte))

    def block(self, x, layer: dict, positions, key_valid):
        md = self.md
        b, t, _ = x.shape
        h = rms_norm(x, layer["ln_1"], self.eps)
        qkv = self.dense(h, "attn_qkv_w", layer["attn_qkv_w"], layer["attn_qkv_b"])
        q, k, v = (z.reshape(b, t, md.heads, -1) for z in qkv.chunk(3, dim=-1))
        q, k = rotary(q, positions, self.base), rotary(k, positions, self.base)
        a = attention(q, k, v, key_valid, causal=True).reshape(b, t, -1)
        x = x + self.dense(a, "attn_proj_w", layer["attn_proj_w"])
        h = rms_norm(x, layer["ln_2"], self.eps)
        inter = self.dense(h, "mlp_w1", layer["mlp_w1"]) * F.silu(self.dense(h, "mlp_w2",
                                                                               layer["mlp_w2"]))
        return x + self.dense(inter, "mlp_proj_w", layer["mlp_proj_w"])

    def layer(self, i: int) -> dict:
        return {k: v[i] for k, v in self.p["layers"].items()}

    @torch.no_grad()
    def capture(self, ids, attn_mask, last_idx, images, image_positions):
        """[n_layers, B, hidden] f32: the last text token's vector after
        every decoder block."""
        x = self.embed(ids)
        vis = self.visual(images)
        rows = torch.arange(x.shape[0], device=x.device)[:, None]
        x = x.index_put((rows.expand_as(image_positions), image_positions), vis)
        positions = torch.arange(x.shape[1], device=x.device)
        out = []
        for i in range(self.md.layers):
            x = self.block(x, self.layer(i), positions, attn_mask)
            out.append(x[rows[:, 0], last_idx])
        return torch.stack(out)
