"""Plain f32 reference of Kimi-VL-A3B-Instruct's capture forward.

Written from the published description (the model's ``config.json``,
arXiv:2504.07491 and its public ``modeling_kimi_vl.py``, whose decoder is
DeepSeek-V3's), in plain ``torch`` operations and f32 throughout (TF32
off, ``exact_f32``):

- MoonViT: 14-px patches times the flattened convolution plus its bias;
  the 64 x 64 position table resized bicubically to the patch grid and
  added; pre-LayerNorm blocks (eps 1e-5) whose attention, over each
  image's patches, turns q and k by 2-D rotary positions written as
  complex numbers (``torch.polar``: pair 2i the column's angle, pair
  2i + 1 the row's, theta 10000), then a tanh-GELU MLP; the final
  LayerNorm; the 2 x 2 merge; the projector (LayerNorm per patch,
  Linear, GELU, Linear).
- The decoder: the image tokens in place of the image span; per block
  RMSNorm, latent attention (q = W_q n; [c | k_pe] = W_kv_a n; [k_nope |
  v] = W_kv_b RMSNorm(c), eps 1e-6; the rotary of theta 800000 on q_pe
  and k_pe after DeepSeek-V3's reshape, ``rotate_half``; causal softmax
  over q.k of 192 columns at 1/sqrt(192) over the valid keys; W_o), then
  RMSNorm and the FFN: layer 0 a SwiGLU, the others the router (sigmoid
  of the f32 product, top 6 of s + the correction bias with ties to the
  lower index, weights s normalised (+1e-20) and scaled by 2.446), each
  routed expert on its own rows in a loop over the experts, and the
  shared experts.  Attention forms the full score matrix and its
  softmax.

Departures from the published description: the capture reads the last
text token's vector after each block and stops there (no final norm,
no LM head); each image is one fixed 448-px square, so MoonViT's packed
variable-resolution attention is one attention per image; the correction
bias is drawn at random (a trained model's is learned).

The routing is the reference's own top k, but at a near tie.  A choice
near a tie flips between bf16 and f32, and on random weights a flipped
token changes the next layers' inputs to every router (through
attention), so the two forwards would part ways layer by layer.  So
picks may be handed in (``capture(..., routes=)``: each expert layer's
picked experts [tokens, k], as the program chose them), and a token
takes them only where they are a near tie by the reference's own f32
scores: where every expert handed in scores (s + the bias) within
``near_tie`` of the reference's k-th largest.  Every other token runs
the reference's own top k, so a pick that is not a near tie parts the
two forwards.  The weights always come from the reference's own scores.
For every layer it records its own choice scores, its own top k and how
many tokens took picks other than its own (``routing``), so that the
picks handed in are held against its scores apart (``route_gap``).

Products go through ``numerics`` (the configuration's, or the control's
lower precision): each product's weight is named by its role among
``numerics.QUANT_KEYS`` (``ROLE``), so the control rounds every large
product and the token table; the router, norms, biases and tables stay
as given.  It reads the weights tree as the benchmark made it, one layer
at a time, so only a layer's weights exist in f32 at once.  It imports
nothing of the program.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.qwen_vl import attention, exact_f32, layer_norm, rms_norm

__all__ = ["Model", "exact_f32", "route_gap", "token_gaps"]

# each product's weight -> the role whose rounding the numerics apply
ROLE = {"q_w": "attn_q_w", "kv_a_w": "attn_k_w", "kv_b_w": "attn_v_w", "o_w": "attn_out_w",
        "gate": "mlp_w1", "up": "mlp_w2", "down": "mlp_proj_w", "patch_w": "patch_w",
        "qkv_w": "attn_qkv_w", "proj_w": "attn_proj_w", "fc_w": "mlp_fc_w",
        "out_w": "mlp_proj_w", "proj_1_w": "proj", "proj_2_w": "proj"}


def rotate_half(x):
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], dim=-1)


class Model:
    """The capture forward over a weights tree under ``numerics``; ``cfg``
    is the configuration file's dict."""

    def __init__(self, params: dict, cfg: dict, numerics, near_tie: float = 0.0):
        self.p, self.c, self.num, self.near_tie = params, cfg, numerics, near_tie
        self.v = cfg["vision_config"]
        # layer -> (choice scores, own picks, tokens that took other picks), CPU
        self.routing: dict[int, tuple] = {}

    def dense(self, x, key, w, b=None):
        y = self.num.matmul(x, ROLE[key], w)
        return y if b is None else y + b.float()

    def swiglu(self, x, gate_up, down):
        g, u = gate_up.chunk(2, dim=-1)
        h = F.silu(self.dense(x, "gate", g)) * self.dense(x, "up", u)
        return self.dense(h, "down", down)

    # --- MoonViT ------------------------------------------------------
    def rope_2d(self, grid, hd, device):
        """[grid^2, hd / 2] complex: pair 2i the column's angle, 2i + 1 the row's."""
        freqs = 1.0 / self.v["rope_theta"] ** (torch.arange(0, hd, 4, device=device)[: hd // 4]
                                               .float() / hd)
        ys, xs = torch.meshgrid(torch.arange(grid, device=device).float(),
                                torch.arange(grid, device=device).float(), indexing="ij")
        x_cis = torch.polar(torch.ones(grid, grid, hd // 4, device=device),
                            xs[..., None] * freqs)
        y_cis = torch.polar(torch.ones(grid, grid, hd // 4, device=device),
                            ys[..., None] * freqs)
        return torch.stack([x_cis, y_cis], dim=-1).reshape(grid * grid, hd // 2)

    @staticmethod
    def turn(x, cis):
        """x [B, T, nh, hd] as complex pairs (2j, 2j + 1), times cis [T, hd / 2]."""
        xc = torch.view_as_complex(x.reshape(*x.shape[:-1], -1, 2).contiguous())
        return torch.view_as_real(xc * cis[None, :, None, :]).flatten(-2)

    def vit_block(self, x, i, cis):
        at = {k: v[i] for k, v in self.p["visual"]["blocks"].items()}
        eps, nh = self.v["layer_norm_eps"], self.v["num_attention_heads"]
        b, t, w = x.shape
        h = layer_norm(x, at["ln_1_w"], at["ln_1_b"], eps)
        qkv = self.dense(h, "qkv_w", at["qkv_w"], at["qkv_b"])
        q, k, v = (z.reshape(b, t, nh, -1) for z in qkv.chunk(3, dim=-1))
        a = attention(self.turn(q, cis), self.turn(k, cis), v).reshape(b, t, w)
        x = x + self.dense(a, "proj_w", at["proj_w"], at["proj_b"])
        h = layer_norm(x, at["ln_2_w"], at["ln_2_b"], eps)
        h = F.gelu(self.dense(h, "fc_w", at["fc_w"], at["fc_b"]), approximate="tanh")
        return x + self.dense(h, "out_w", at["out_w"], at["out_b"])

    def visual(self, images):
        vp, v = self.p["visual"], self.v
        b, p = images.shape[0], v["patch_size"]
        g = images.shape[-1] // p
        patches = (images.float().reshape(b, 3, g, p, g, p).permute(0, 2, 4, 1, 3, 5)
                   .reshape(b, g * g, 3 * p * p))
        x = self.dense(patches, "patch_w", vp["patch_w"], vp["patch_b"])
        src = v["init_pos_emb_height"]
        table = vp["pos_table"].float().reshape(src, src, -1).permute(2, 0, 1)[None]
        pos = F.interpolate(table, size=(g, g), mode="bicubic", align_corners=False)
        x = x + pos[0].permute(1, 2, 0).reshape(g * g, -1)
        cis = self.rope_2d(g, v["hidden_size"] // v["num_attention_heads"], images.device)
        for i in range(v["num_hidden_layers"]):
            x = self.vit_block(x, i, cis)
        x = layer_norm(x, vp["ln_post_w"], vp["ln_post_b"], v["layer_norm_eps"])
        kh, kw = v["merge_kernel_size"]
        w = x.shape[-1]
        x = (x.reshape(b, g // kh, kh, g // kw, kw, w).permute(0, 1, 3, 2, 4, 5)
             .reshape(b, (g // kh) * (g // kw), kh * kw, w))
        eps = self.c["projector"]["layer_norm_eps"]
        x = layer_norm(x, vp["proj_ln_w"], vp["proj_ln_b"], eps).flatten(-2)
        x = F.gelu(self.dense(x, "proj_1_w", vp["proj_1_w"], vp["proj_1_b"]))
        return self.dense(x, "proj_2_w", vp["proj_2_w"], vp["proj_2_b"])

    # --- decoder ------------------------------------------------------
    def rope(self, x, positions):
        """DeepSeek-V3's: x [B, T, nh, d] -> its pairs regrouped, then
        x cos + rotate_half(x) sin."""
        d = x.shape[-1]
        inv = 1.0 / self.c["rope_theta"] ** (torch.arange(0, d, 2, device=x.device).float() / d)
        freqs = positions.float()[:, None] * inv
        emb = torch.cat([freqs, freqs], dim=-1)
        cos, sin = emb.cos()[None, :, None, :], emb.sin()[None, :, None, :]
        b, t, n, _ = x.shape
        x = x.reshape(b, t, n, d // 2, 2).transpose(-1, -2).reshape(b, t, n, d)
        return x * cos + rotate_half(x) * sin

    def attn(self, x, lay, positions, key_valid):
        c = self.c
        b, t, _ = x.shape
        nh, dn, dr = c["num_attention_heads"], c["qk_nope_head_dim"], c["qk_rope_head_dim"]
        h = rms_norm(x, lay["attn_norm"], c["rms_norm_eps"])
        q = self.dense(h, "q_w", lay["q_w"]).reshape(b, t, nh, dn + dr)
        ckv = self.dense(h, "kv_a_w", lay["kv_a_w"])
        latent, k_pe = ckv[..., :c["kv_lora_rank"]], ckv[..., c["kv_lora_rank"]:]
        kv = self.dense(rms_norm(latent, lay["kv_a_norm"], c["kv_a_layernorm_eps"]), "kv_b_w",
                        lay["kv_b_w"]).reshape(b, t, nh, -1)
        k_pe = self.rope(k_pe.reshape(b, t, 1, dr), positions).expand(b, t, nh, dr)
        q = torch.cat([q[..., :dn], self.rope(q[..., dn:], positions)], dim=-1)
        k = torch.cat([kv[..., :dn], k_pe], dim=-1)
        a = attention(q, k, kv[..., dn:], key_valid, causal=True)
        return self.dense(a.reshape(b, t, -1), "o_w", lay["o_w"])

    def scores(self, h, moe):
        """(s, s + the correction bias) [N, E] f32."""
        s = torch.sigmoid(h @ moe["router_w"].float())
        return s, s + moe["router_bias"].float()

    def weigh(self, s, picked):
        w = s.gather(1, picked)
        return w / (w.sum(-1, keepdim=True) + 1e-20) * self.c["routed_scaling_factor"]

    def route(self, h, moe):
        """(picked [N, k], weights [N, k]): the top k of the choice scores,
        ties to the lower expert."""
        s, choice = self.scores(h, moe)
        picked = torch.argsort(-choice, dim=-1, stable=True)[:, :self.c["num_experts_per_tok"]]
        return picked, self.weigh(s, picked)

    def moe(self, h, moe, layer, handed=None):
        """h [N, H]: the routed experts (the reference's own, or those
        ``handed`` in where they are a near tie), each on its own rows,
        weighted, summed over a token's choices, plus the shared
        experts."""
        s, choice = self.scores(h, moe)
        own, _ = self.route(h, moe)
        picked = own
        if handed is not None:
            handed = handed.to(h.device)
            near = token_gaps(choice, handed, own.shape[1]) <= self.near_tie
            picked = torch.where(near[:, None], handed, own)
        taken = int((picked.sort(-1).values != own.sort(-1).values).any(-1).sum())
        self.routing[layer] = (choice.cpu(), own.cpu(), taken)
        weights = self.weigh(s, picked)
        out = torch.zeros(*picked.shape, h.shape[-1], device=h.device)
        for e in range(self.c["n_routed_experts"]):
            tokens, slot = torch.nonzero(picked == e, as_tuple=True)
            if tokens.numel():
                y = self.swiglu(h[tokens], moe["experts_gate_up"][e], moe["experts_down"][e])
                out[tokens, slot] = y * weights[tokens, slot][:, None]
        return out.sum(1) + self.swiglu(h, moe["shared_gate_up"], moe["shared_down"])

    def ffn(self, x, i, lay, routes=None):
        c = self.c
        h = rms_norm(x, lay["ffn_norm"], c["rms_norm_eps"])
        d = c["first_k_dense_replace"]
        if i < d:
            return self.swiglu(h, self.p["dense"]["gate_up_w"][i], self.p["dense"]["down_w"][i])
        moe = {k: v[i - d] for k, v in self.p["moe"].items()}
        handed = None if routes is None else routes[i]
        return self.moe(h.reshape(-1, h.shape[-1]), moe, i, handed).reshape(x.shape)

    @torch.no_grad()
    def capture(self, ids, attn_mask, last_idx, images, image_positions, routes=None):
        """[n_layers, B, hidden] f32: the last text token's vector after
        every decoder block; ``routes`` (layer -> picked [B T, k]) picks
        handed in, taken where they are a near tie."""
        emb = self.p["embed"]
        x = self.num.rows("wte", emb[ids], self.num.table_scale("wte", emb))
        rows = torch.arange(x.shape[0], device=x.device)[:, None]
        x = x.index_put((rows.expand_as(image_positions), image_positions), self.visual(images))
        positions = torch.arange(x.shape[1], device=x.device)
        out = []
        for i in range(self.c["num_hidden_layers"]):
            lay = {k: v[i] for k, v in self.p["layers"].items()}
            x = x + self.attn(x, lay, positions, attn_mask)
            x = x + self.ffn(x, i, lay, routes)
            out.append(x[rows[:, 0], last_idx])
        return torch.stack(out)


def token_gaps(choice: torch.Tensor, picked: torch.Tensor, k: int) -> torch.Tensor:
    """[N]: how far each token's picks [N, k] fall below the top k of its
    choice scores [N, E], the k-th largest score less the least score
    picked (0 where the picks are a top k)."""
    kth = choice.topk(k, dim=-1).values[:, -1]
    least = choice.gather(1, picked.to(choice.device)).amin(-1)
    return (kth - least).clamp_min(0)


def route_gap(choice: torch.Tensor, picked: torch.Tensor, k: int) -> float:
    """The largest of ``token_gaps`` over the tokens."""
    return float(token_gaps(choice, picked, k).max())
