"""Seeded random weights of Kimi-VL in the port's parameter tree, made on
the card.

The tree has the port's names and layouts (``tdax_torch.models.kimi_vl
.model``: [in, out] weights, each stack of layers one [L, ...] tensor):
the program takes it as its input, and the reference reads the same
tensors.  Every matrix is drawn on the device from one
``torch.Generator`` (``normal_``, in place, a layer at a time), scaled
by 1/sqrt(fan-in) (0.02 for the token and position tables), in the
served dtype; norms are ones, biases zeros, and the router's correction
bias N(0, 0.05^2) in f32, so that it moves the choice of experts.  The
same seed gives the same tree.
"""

from __future__ import annotations

import math

import torch

from benchmark.weights import seed_of

ROUTER_BIAS_STD = 0.05


class KimiWeights:
    """``build()`` draws the tree of configuration file ``cfg``."""

    def __init__(self, cfg: dict, seed: int, device, dtype: torch.dtype):
        self.cfg, self.device, self.dtype = cfg, torch.device(device), dtype
        self.gen = torch.Generator(device=self.device).manual_seed(seed_of(seed))

    def _dense(self, shape, scale=None, dtype=None) -> torch.Tensor:
        """One normal draw per leading index of a stack."""
        if scale is None:
            scale = 1.0 / math.sqrt(shape[-2] if len(shape) > 1 else shape[0])
        out = torch.empty(shape, device=self.device, dtype=dtype or self.dtype)
        for part in (out if len(shape) > 2 else [out]):
            part.normal_(generator=self.gen)
        return out.mul_(scale)

    def _const(self, shape, value: float) -> torch.Tensor:
        return torch.full(shape, value, device=self.device, dtype=self.dtype)

    def build(self) -> dict:
        c = self.cfg
        h, n, nh = c["hidden_size"], c["num_hidden_layers"], c["num_attention_heads"]
        d = c["first_k_dense_replace"]
        e, ne = n - d, c["n_routed_experts"]
        f, s = c["moe_intermediate_size"], c["moe_intermediate_size"] * c["n_shared_experts"]
        r, dn, dr, dv = c["kv_lora_rank"], c["qk_nope_head_dim"], c["qk_rope_head_dim"], c[
            "v_head_dim"]
        return {
            "embed": self._dense((c["vocab_size"], h), 0.02),
            "layers": {
                "attn_norm": self._const((n, h), 1.0), "ffn_norm": self._const((n, h), 1.0),
                "q_w": self._dense((n, h, nh * (dn + dr))),
                "kv_a_w": self._dense((n, h, r + dr)), "kv_a_norm": self._const((n, r), 1.0),
                "kv_b_w": self._dense((n, r, nh * (dn + dv))),
                "o_w": self._dense((n, nh * dv, h)),
            },
            "dense": {"gate_up_w": self._dense((d, h, 2 * c["intermediate_size"])),
                      "down_w": self._dense((d, c["intermediate_size"], h))},
            "moe": {
                "router_w": self._dense((e, h, ne)),
                "router_bias": self._dense((e, ne), ROUTER_BIAS_STD, torch.float32),
                "experts_gate_up": self._dense((e, ne, h, 2 * f)),
                "experts_down": self._dense((e, ne, f, h)),
                "shared_gate_up": self._dense((e, h, 2 * s)),
                "shared_down": self._dense((e, s, h)),
            },
            "norm": self._const((h,), 1.0),
            "lm_head": self._dense((h, c["vocab_size"])),
            "visual": self._visual(),
        }

    def _visual(self) -> dict:
        v, h = self.cfg["vision_config"], self.cfg["hidden_size"]
        w, n, mlp = v["hidden_size"], v["num_hidden_layers"], v["intermediate_size"]
        kh, kw = v["merge_kernel_size"]
        m = kh * kw * w
        return {
            "patch_w": self._dense((3 * v["patch_size"] ** 2, w)),
            "patch_b": self._const((w,), 0.0),
            "pos_table": self._dense((v["init_pos_emb_height"] * v["init_pos_emb_width"], w),
                                     0.02),
            "blocks": {
                "ln_1_w": self._const((n, w), 1.0), "ln_1_b": self._const((n, w), 0.0),
                "qkv_w": self._dense((n, w, 3 * w)), "qkv_b": self._const((n, 3 * w), 0.0),
                "proj_w": self._dense((n, w, w)), "proj_b": self._const((n, w), 0.0),
                "ln_2_w": self._const((n, w), 1.0), "ln_2_b": self._const((n, w), 0.0),
                "fc_w": self._dense((n, w, mlp)), "fc_b": self._const((n, mlp), 0.0),
                "out_w": self._dense((n, mlp, w)), "out_b": self._const((n, w), 0.0),
            },
            "ln_post_w": self._const((w,), 1.0), "ln_post_b": self._const((w,), 0.0),
            "proj_ln_w": self._const((w,), 1.0), "proj_ln_b": self._const((w,), 0.0),
            "proj_1_w": self._dense((m, m)), "proj_1_b": self._const((m,), 0.0),
            "proj_2_w": self._dense((m, h)), "proj_2_b": self._const((h,), 0.0),
        }
