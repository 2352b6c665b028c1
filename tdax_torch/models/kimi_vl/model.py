"""Kimi-VL's capture: parameters, the image tokens in the prompt, and the
per-layer last-token vectors.

Parameters are a plain dict tree in the port's layouts ([in, out]
weights, each stack of layers one [L, ...] tensor):

- ``embed`` [V, H], ``norm`` [H], ``lm_head`` [H, V] (untied; held, and
  not used by the capture);
- ``layers`` (all L): ``attn_norm``, ``ffn_norm`` [L, H]; ``q_w`` [L, H,
  nh (128 + 64)], ``kv_a_w`` [L, H, 512 + 64], ``kv_a_norm`` [L, 512],
  ``kv_b_w`` [L, 512, nh (128 + 128)], ``o_w`` [L, nh 128, H];
- ``dense`` (the first ``first_k_dense_replace``): ``gate_up_w`` [., H,
  2 I] ([gate | up]), ``down_w`` [., I, H];
- ``moe`` (the rest): ``router_w`` [., H, E], ``router_bias`` [., E]
  (f32: DeepSeek-V3's ``e_score_correction_bias``), ``experts_gate_up``
  [., E, H, 2 F], ``experts_down`` [., E, F, H], ``shared_gate_up`` [., H,
  2 S], ``shared_down`` [., S, H];
- ``visual``: ``patch_w`` [3 p^2, w], ``patch_b``, ``pos_table``
  [pos_grid^2, w], ``blocks`` (``ln_1_w``/``_b``, ``qkv_w`` [., w, 3 w],
  ``qkv_b``, ``proj_w``, ``proj_b``, ``ln_2_w``/``_b``, ``fc_w`` [., w,
  mlp], ``fc_b``, ``out_w``, ``out_b``), ``ln_post_w``/``_b``,
  ``proj_ln_w``/``_b`` [w], ``proj_1_w`` [4 w, 4 w], ``proj_1_b``,
  ``proj_2_w`` [4 w, H], ``proj_2_b``.

``init_params`` draws them on the device from one ``torch.Generator``:
fan-in normals for the products, 0.02 for the token table and the
position table, unit norms, zero biases, and a correction bias of
N(0, 0.05^2) so that it moves the choice of experts.
"""

from __future__ import annotations

import math

import torch

from tdax_torch.models.kimi_vl.config import KimiVLConfig, MoonViTConfig
from tdax_torch.models.kimi_vl.decoder import decoder_capture
from tdax_torch.models.kimi_vl.moonvit import visual_encode
from tdax_torch.models.qwen_vl.model import torch_dtype
from tdax_torch.ops import moe
from tdax_torch.utils.log import log_event, span

ROUTER_BIAS_STD = 0.05


class _Init:
    """Leaves on ``device`` in ``dtype``, normals from one generator."""

    def __init__(self, gen: torch.Generator, device, dtype: torch.dtype):
        self.gen, self.device, self.dtype = gen, device, dtype

    def dense(self, shape, scale=None, dtype=None) -> torch.Tensor:
        if scale is None:
            scale = 1.0 / math.sqrt(shape[-2] if len(shape) > 1 else shape[0])
        w = torch.randn(shape, generator=self.gen, device=self.device, dtype=dtype or self.dtype)
        return w.mul_(scale)

    def const(self, shape, value: float) -> torch.Tensor:
        return torch.full(shape, value, device=self.device, dtype=self.dtype)


def init_visual_params(init: _Init, cfg: MoonViTConfig, hidden: int) -> dict:
    w, n, mlp = cfg.width, cfg.layers, cfg.mlp_dim
    m = cfg.merge ** 2 * w
    return {
        "patch_w": init.dense((3 * cfg.patch_size ** 2, w)),
        "patch_b": init.const((w,), 0.0),
        "pos_table": init.dense((cfg.pos_grid ** 2, w), 0.02),
        "blocks": {
            "ln_1_w": init.const((n, w), 1.0), "ln_1_b": init.const((n, w), 0.0),
            "qkv_w": init.dense((n, w, 3 * w)), "qkv_b": init.const((n, 3 * w), 0.0),
            "proj_w": init.dense((n, w, w)), "proj_b": init.const((n, w), 0.0),
            "ln_2_w": init.const((n, w), 1.0), "ln_2_b": init.const((n, w), 0.0),
            "fc_w": init.dense((n, w, mlp)), "fc_b": init.const((n, mlp), 0.0),
            "out_w": init.dense((n, mlp, w)), "out_b": init.const((n, w), 0.0),
        },
        "ln_post_w": init.const((w,), 1.0), "ln_post_b": init.const((w,), 0.0),
        "proj_ln_w": init.const((w,), 1.0), "proj_ln_b": init.const((w,), 0.0),
        "proj_1_w": init.dense((m, m)), "proj_1_b": init.const((m,), 0.0),
        "proj_2_w": init.dense((m, hidden)), "proj_2_b": init.const((hidden,), 0.0),
    }


def init_params(cfg: KimiVLConfig, device, seed: int = 0) -> dict:
    """Random parameters drawn on ``device`` in ``cfg.dtype`` from a
    ``torch.Generator`` on that device seeded with ``seed``."""
    device = torch.device(device)
    init = _Init(torch.Generator(device=device).manual_seed(seed), device, torch_dtype(cfg.dtype))
    h, n, nh = cfg.hidden_size, cfg.num_layers, cfg.num_heads
    d, e, f, s = cfg.n_dense, cfg.n_moe, cfg.moe_intermediate_size, cfg.shared_intermediate
    r, dr = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    return {
        "embed": init.dense((cfg.vocab_size, h), 0.02),
        "layers": {
            "attn_norm": init.const((n, h), 1.0), "ffn_norm": init.const((n, h), 1.0),
            "q_w": init.dense((n, h, nh * cfg.qk_head_dim)),
            "kv_a_w": init.dense((n, h, r + dr)), "kv_a_norm": init.const((n, r), 1.0),
            "kv_b_w": init.dense((n, r, nh * (cfg.qk_nope_head_dim + cfg.v_head_dim))),
            "o_w": init.dense((n, nh * cfg.v_head_dim, h)),
        },
        "dense": {"gate_up_w": init.dense((d, h, 2 * cfg.intermediate_size)),
                  "down_w": init.dense((d, cfg.intermediate_size, h))},
        "moe": {
            "router_w": init.dense((e, h, cfg.n_routed_experts)),
            "router_bias": init.dense((e, cfg.n_routed_experts), ROUTER_BIAS_STD, torch.float32),
            "experts_gate_up": init.dense((e, cfg.n_routed_experts, h, 2 * f)),
            "experts_down": init.dense((e, cfg.n_routed_experts, f, h)),
            "shared_gate_up": init.dense((e, h, 2 * s)),
            "shared_down": init.dense((e, s, h)),
        },
        "norm": init.const((h,), 1.0),
        "lm_head": init.dense((h, cfg.vocab_size)),
        "visual": init_visual_params(init, cfg.visual, h),
    }


def embed_inputs(params: dict, cfg: KimiVLConfig, input_ids: torch.Tensor,
                 images: torch.Tensor | None,
                 image_positions: torch.Tensor | None) -> torch.Tensor:
    """Token embeddings with the projected image tokens in place of the
    image span: image_positions [B, n_queries] are each sample's span, -1
    for a sample without an image (its embeddings stay)."""
    x = params["embed"][input_ids]
    if images is None:
        return x
    vis = visual_encode(images, params["visual"], cfg.visual).to(x.dtype)
    ok = image_positions >= 0
    rows = torch.arange(x.shape[0], device=x.device)[:, None].expand_as(image_positions)
    pos = image_positions.clamp(min=0)
    return x.index_put((rows, pos), torch.where(ok[..., None], vis, x[rows, pos]))


def extract_layer_activations(params: dict, cfg: KimiVLConfig,
                              input_ids: torch.Tensor,
                              attn_mask: torch.Tensor,
                              last_token_idx: torch.Tensor,
                              images: torch.Tensor | None = None,
                              image_positions: torch.Tensor | None = None) -> torch.Tensor:
    """[n_layers, batch, hidden] last-token activation capture (the
    signature of Qwen-VL's)."""
    with span("capture"):
        x = embed_inputs(params, cfg, input_ids, images, image_positions)
        return decoder_capture(params, x, cfg, attn_mask, last_token_idx)


def log_expert_load() -> None:
    """The expert layers' load over the batches a profiler recorded
    (``ops.moe.LOAD``), once, as a ``moe_load`` event: per layer the
    busiest and the idlest expert's routed rows over the mean."""
    load = moe.balance(moe.LOAD.take())
    if load:
        log_event("moe_load", layers={str(i): {k: round(v, 4) for k, v in b.items()}
                                      for i, b in load.items()})
