"""Full Qwen-VL model in PyTorch: init, forward, batched per-layer capture.

Counterpart of ``tdax/models/qwen_vl/model.py``.  Parameters are a plain
dict tree with tdax's names, layouts ([in, out] weights, layer weights
stacked [n_layers, ...]) and init distribution (fan-in normal matmuls,
0.02 embeddings, unit norms, zero biases, sincos resampler positions).
The random numbers come from an explicit ``torch.Generator`` on the
target device, so the full 9.66B-parameter model is drawn directly on
the card; they differ from ``jax.random``'s, so the tests hand both
packages the same numpy tree through ``convert.params_from_numpy``.
"""

from __future__ import annotations

import math

import torch

from tdax_torch.models.qwen_vl import fsdp
from tdax_torch.models.qwen_vl.config import QwenVLConfig, VisualConfig
from tdax_torch.models.qwen_vl.decoder import decoder, decoder_capture, rms_norm
from tdax_torch.models.qwen_vl.quantize import _QUANT_KEYS, embed_lookup, qdot, quantize_weight
from tdax_torch.models.qwen_vl.tp import seq_weight, tp_gather, tp_input
from tdax_torch.models.qwen_vl.vit import interp_pos_embed, sincos_2d, visual_encode
from tdax_torch.ops.flash_attention import without_seq_axis
from tdax_torch.utils.log import span

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else DTYPES[str(name)]


class _Init:
    """Leaf factory: every leaf on ``device`` in ``dtype``, normals from
    one generator.  With ``quantize`` each weight named in
    ``_QUANT_KEYS`` is quantized to int8 as soon as it is drawn."""

    def __init__(self, gen: torch.Generator, device, dtype: torch.dtype, quantize: bool = False):
        self.gen, self.device, self.dtype, self.quantize = gen, device, dtype, quantize

    def dense(self, name: str, shape, scale=None):
        # fan-in init: for stacked [L, in, out] weights the input dim is
        # shape[-2], not the layer axis
        if scale is None:
            scale = 1.0 / math.sqrt(shape[-2] if len(shape) > 1 else shape[0])
        w = torch.randn(shape, generator=self.gen, device=self.device, dtype=self.dtype)
        w.mul_(scale)
        return quantize_weight(w) if self.quantize and name in _QUANT_KEYS else w

    def ones(self, shape) -> torch.Tensor:
        return torch.ones(shape, device=self.device, dtype=self.dtype)

    def zeros(self, shape) -> torch.Tensor:
        return torch.zeros(shape, device=self.device, dtype=self.dtype)

    def table(self, array) -> torch.Tensor:
        return torch.as_tensor(array).to(device=self.device, dtype=self.dtype)


def init_visual_params(init: _Init, cfg: VisualConfig) -> dict:
    w, d, n = cfg.width, cfg.output_dim, cfg.layers
    q_grid = math.isqrt(cfg.n_queries)
    blocks = {
        "ln_1_w": init.ones((n, w)), "ln_1_b": init.zeros((n, w)),
        "ln_2_w": init.ones((n, w)), "ln_2_b": init.zeros((n, w)),
        "attn_qkv_w": init.dense("attn_qkv_w", (n, w, 3 * w)),
        "attn_qkv_b": init.zeros((n, 3 * w)),
        "attn_proj_w": init.dense("attn_proj_w", (n, w, w)),
        "attn_proj_b": init.zeros((n, w)),
        "mlp_fc_w": init.dense("mlp_fc_w", (n, w, cfg.mlp_dim)),
        "mlp_fc_b": init.zeros((n, cfg.mlp_dim)),
        "mlp_proj_w": init.dense("mlp_proj_w", (n, cfg.mlp_dim, w)),
        "mlp_proj_b": init.zeros((n, w)),
    }
    resampler = {
        "query": init.dense("query", (cfg.n_queries, d), scale=0.02),
        "q_pos": init.table(sincos_2d(q_grid, d)),
        # keys reuse the query-grid table upsampled to the patch grid
        "kv_pos": init.table(interp_pos_embed(sincos_2d(q_grid, d), cfg.grid_size)),
        "kv_proj_w": init.dense("kv_proj_w", (w, d)),
        "ln_q_w": init.ones((d,)), "ln_q_b": init.zeros((d,)),
        "ln_kv_w": init.ones((d,)), "ln_kv_b": init.zeros((d,)),
        "attn_q_w": init.dense("attn_q_w", (d, d)), "attn_q_b": init.zeros((d,)),
        "attn_k_w": init.dense("attn_k_w", (d, d)), "attn_k_b": init.zeros((d,)),
        "attn_v_w": init.dense("attn_v_w", (d, d)), "attn_v_b": init.zeros((d,)),
        "attn_out_w": init.dense("attn_out_w", (d, d)), "attn_out_b": init.zeros((d,)),
    }
    return {
        "patch_w": init.dense("patch_w", (3 * cfg.patch_size ** 2, w)),
        "pos_embed": init.dense("pos_embed", (cfg.n_patches, w), scale=0.02),
        "ln_pre_w": init.ones((w,)), "ln_pre_b": init.zeros((w,)),
        "ln_post_w": init.ones((d,)), "ln_post_b": init.zeros((d,)),
        "blocks": blocks,
        "resampler": resampler,
        "proj": init.dense("proj", (d, d)),
    }


def init_params(cfg: QwenVLConfig, device, seed: int = 0, quantize: bool = False,
                with_visual: bool = True) -> dict:
    """Random parameters, drawn on ``device`` in ``cfg.dtype`` from a
    ``torch.Generator`` on that device seeded with ``seed``; with
    ``quantize`` the large matmul weights come out int8, drawn one at a
    time (``quantize.init_params_quantized``).  ``with_visual=False``
    leaves out the visual tree (text-only training, as tdax's flag); the
    visual tree is drawn last, so the other leaves do not change."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    init = _Init(gen, device, torch_dtype(cfg.dtype), quantize)
    h, l = cfg.hidden_size, cfg.num_layers
    layers = {
        "ln_1": init.ones((l, h)),
        "ln_2": init.ones((l, h)),
        "attn_qkv_w": init.dense("attn_qkv_w", (l, h, 3 * h)),
        "attn_qkv_b": init.zeros((l, 3 * h)),
        "attn_proj_w": init.dense("attn_proj_w", (l, h, h)),
        "mlp_w1": init.dense("mlp_w1", (l, h, cfg.ff_half)),
        "mlp_w2": init.dense("mlp_w2", (l, h, cfg.ff_half)),
        "mlp_proj_w": init.dense("mlp_proj_w", (l, cfg.ff_half, h)),
    }
    params = {
        "wte": init.dense("wte", (cfg.vocab_size, h), scale=0.02),
        "layers": layers,
        "ln_f": init.ones((h,)),
        "lm_head": init.dense("lm_head", (h, cfg.vocab_size)),
    }
    if with_visual:
        params["visual"] = init_visual_params(init, cfg.visual)
    return params


def embed_inputs(params: dict, cfg: QwenVLConfig, input_ids: torch.Tensor,
                 images: torch.Tensor | None,
                 image_positions: torch.Tensor | None) -> torch.Tensor:
    """Token embeddings with visual tokens scattered into image spans.

    image_positions [B, n_queries]: sequence indices of the image-pad
    span per sample; -1 disables fusion for that sample (text-only).
    As in tdax, the pad span is zeroed and the visual tokens added.
    Under context parallelism the whole sequence is embedded on every
    rank, the visual tower outside the ring (``without_seq_axis``)."""
    x = embed_lookup(fsdp.leaf(params["wte"], ("wte",)), input_ids, torch_dtype(cfg.dtype))
    if images is not None:
        with without_seq_axis():  # the visual tower runs whole on every rank, off the ring
            vis = visual_encode(images, params["visual"], cfg.visual)  # [B, nq, H]
        b = x.shape[0]
        ok = image_positions >= 0
        safe_pos = image_positions.clamp(min=0)
        vis = torch.where(ok[..., None], vis, 0.0).to(x.dtype)
        batch_idx = torch.arange(b, device=x.device)[:, None].expand_as(safe_pos)
        keep = torch.ones(x.shape[:2], dtype=torch.bool, device=x.device)
        keep[batch_idx, safe_pos] = ~ok
        added = torch.zeros_like(x).index_put_((batch_idx, safe_pos), vis, accumulate=True)
        x = x * keep[..., None] + added
    return x


def extract_layer_activations(params: dict, cfg: QwenVLConfig,
                              input_ids: torch.Tensor,
                              attn_mask: torch.Tensor,
                              last_token_idx: torch.Tensor,
                              images: torch.Tensor | None = None,
                              image_positions: torch.Tensor | None = None) -> torch.Tensor:
    """[n_layers, batch, hidden] last-token activation capture."""
    with span("capture"):
        x = embed_inputs(params, cfg, input_ids, images, image_positions)
        _, capture = decoder_capture(params["layers"], x, cfg, attn_mask, last_token_idx)
    return capture


def lm_logits(x: torch.Tensor, params: dict, cfg: QwenVLConfig, seq=None) -> torch.Tensor:
    """[..., H] final hidden states -> [..., vocab] f32 logits; under tp
    each rank's vocab shard, gathered over the tp group.  Under ``seq``
    x is the rank's rows, the sequence gathered before the product.
    Under FSDP ``lm_head`` is gathered over dp here."""
    w = fsdp.leaf(params["lm_head"], ("lm_head",))
    sharded = (w["q"] if isinstance(w, dict) else w).shape[-1] < cfg.vocab_size
    logits = qdot(tp_input(x, sharded, seq), w).to(torch.float32)
    return tp_gather(logits, sharded)


def forward(params: dict, cfg: QwenVLConfig, input_ids: torch.Tensor,
            attn_mask: torch.Tensor | None = None,
            images: torch.Tensor | None = None,
            image_positions: torch.Tensor | None = None,
            remat: bool = False, seq_sharding=None) -> torch.Tensor:
    """Logits [B, T, vocab] in f32 (the whole vocabulary on every rank
    under tp).  ``remat`` rematerializes decoder blocks in the backward
    pass; ``seq_sharding`` (``(mesh, axis)``) turns on sequence
    parallelism between the blocks, ``ln_f`` running on the rank's rows
    (see ``decoder``).  Under ``flash_sharding(..., seq_axis=)``
    (context parallelism) the logits are this rank's chunk, [B, T / cp,
    vocab] at the chunk's positions (``ring_attention.local_chunk``)."""
    if attn_mask is None:
        attn_mask = torch.ones_like(input_ids)
    x = embed_inputs(params, cfg, input_ids, images, image_positions)
    x = decoder(params["layers"], x, cfg, attn_mask, remat=remat, seq_sharding=seq_sharding)
    ln_f = fsdp.leaf(params["ln_f"], ("ln_f",))
    x = rms_norm(x, seq_weight(ln_f, seq_sharding), cfg.layer_norm_eps)
    return lm_logits(x, params, cfg, seq_sharding)
