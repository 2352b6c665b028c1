"""KV-cached generation (port of ``tdax/models/qwen_vl/generate.py``).

A prefill pass builds per-layer K/V caches from the (multimodal)
prompt, then one token per decode step: greedy, or sampled with
temperature / top-k / top-p.  The prefill runs the decoder's
``block_kv`` and a decode step its ``project_qkv`` / ``attend`` /
``mlp``, so forward, capture, prefill and decode share one
implementation, with fp or int8 (``qdot``) parameter trees.

Cache layout: k/v [n_layers, B, T_max, n_heads, head_dim] in the model
dtype, or with ``kv_int8`` ``{"q": int8 [L, B, T_max, nh, hd], "s": f32
[L, B, T_max, nh]}`` (per-(token, head) abs-max scales).  Under dp x tp
each rank runs its own rows with its tp heads: its caches are [L, B/dp,
T_max, nh/tp, hd] (the scales sharded with their heads), its logits the
whole vocabulary (gathered over tp), so greedy tokens agree across a tp
group; a sampled token is drawn on the group's first rank and
broadcast.  Ragged
right-padded prompts keep per-sample timelines: step i writes each
sample's row at ``lengths + i``, so rotary positions have no pad gaps.

Departures from tdax, by design:
  * the caches are allocated at T_max once and updated in place (tdax's
    functional scan returns new ones); ``_decode_step`` returns the
    same tensors it was given;
  * decode attention is ``AttnSpec(kv_valid=key_pos <= cur_pos)`` on
    the flash kernel (tdax sends the equal additive mask to its einsum
    path); key 0 is always valid, so no row is fully masked;
  * random draws come from an explicit ``torch.Generator``, so sampled
    tokens match tdax's in distribution, not draw for draw; greedy
    tokens match exactly.
"""

from __future__ import annotations

import torch

from tdax_torch.models.qwen_vl.config import QwenVLConfig
from tdax_torch.models.qwen_vl.decoder import (_rotary_and_spec, attend, block_kv, local_heads,
                                               mlp, project_qkv, rms_norm, rotary_cos_sin)
from tdax_torch.models.qwen_vl.model import embed_inputs, lm_logits, torch_dtype
from tdax_torch.models.qwen_vl.quantize import embed_lookup, layer_at
from tdax_torch.models.qwen_vl.tp import tp_broadcast
from tdax_torch.ops.flash_attention import AttnSpec


def filter_logits(logits: torch.Tensor, temperature: float = 1.0, top_k: int = 0,
                  top_p: float = 1.0) -> torch.Tensor:
    """logits [B, V] / temperature in f32, with the tokens outside the
    top-k and outside the top-p nucleus set to -inf.

    The nucleus is the smallest prefix of the descending-probability
    order whose mass reaches top_p; its first token is always kept.
    Ties at a cutoff are all kept."""
    logits = (logits / temperature).to(torch.float32)
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, -torch.inf, logits)
    if top_p < 1.0:
        desc = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(desc, dim=-1)
        keep = (torch.cumsum(probs, dim=-1) - probs) < top_p  # mass before this token
        keep[:, 0] = True
        cutoff = torch.where(keep, desc, torch.inf).amin(dim=-1, keepdim=True)
        logits = torch.where(logits < cutoff, -torch.inf, logits)
    return logits


def sample_logits(logits: torch.Tensor, generator: torch.Generator | None = None,
                  temperature: float = 1.0, top_k: int = 0, top_p: float = 1.0) -> torch.Tensor:
    """Next-token ids [B] (int64) from logits [B, V]: argmax at
    temperature 0 (filters ignored), else one draw from the softmax of
    ``filter_logits``."""
    if temperature == 0.0:
        return logits.argmax(dim=-1)
    probs = torch.softmax(filter_logits(logits, temperature, top_k, top_p), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def _kv_quant(x: torch.Tensor) -> dict:
    """Per-(token, head) abs-max int8 quantization of a K or V tensor
    [..., nh, hd] -> {"q": int8 same shape, "s": f32 [..., nh]}."""
    xf = x.to(torch.float32)
    s = (xf.abs().amax(dim=-1) / 127.0).clamp_min(1e-12)
    q = torch.round(xf / s[..., None]).clamp_(-127, 127).to(torch.int8)
    return {"q": q, "s": s}


def _kv_dequant(c, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of ``_kv_quant``; fp caches pass through unchanged."""
    if isinstance(c, dict):
        return (c["q"].to(torch.float32) * c["s"][..., None]).to(dtype)
    return c


def _empty_cache(shape, dtype: torch.dtype, device, kv_int8: bool):
    """A cache at its full length; rows past the prompt hold what tdax's
    zero padding holds (for int8: q 0, s 1e-12)."""
    if kv_int8:
        return {"q": torch.zeros(shape, dtype=torch.int8, device=device),
                "s": torch.full(shape[:-1], 1e-12, dtype=torch.float32, device=device)}
    return torch.zeros(shape, dtype=dtype, device=device)


def _cache_layer(cache, i: int):
    if isinstance(cache, dict):
        return {"q": cache["q"][i], "s": cache["s"][i]}
    return cache[i]


def prefill(params: dict, cfg: QwenVLConfig, input_ids: torch.Tensor, attn_mask: torch.Tensor,
            images: torch.Tensor | None = None, image_positions: torch.Tensor | None = None,
            t_max: int | None = None, kv_int8: bool = False):
    """Prompt pass: (hidden [B, T, H], k cache, v cache) with caches
    [L, B, T_max, nh, hd] (or int8 nodes).  Attention inside the prefill
    uses the exact live k/v; only what is stored is quantized.  Each
    layer's k/v is written into the caches as it is made, so the peak
    holds one copy of the caches."""
    x = embed_inputs(params, cfg, input_ids, images, image_positions)
    b, t, _ = x.shape
    t_max = t_max or t
    cos, sin, spec = _rotary_and_spec(x, cfg, attn_mask)
    shape = (cfg.num_layers, b, t_max, local_heads(params["layers"], cfg), cfg.head_dim)
    ks = _empty_cache(shape, x.dtype, x.device, kv_int8)
    vs = _empty_cache(shape, x.dtype, x.device, kv_int8)
    for i in range(cfg.num_layers):
        x, k, v = block_kv(x, layer_at(params["layers"], i), cfg, cos, sin, spec)
        for cache, new in ((ks, k), (vs, v)):
            if kv_int8:
                new = _kv_quant(new)
                cache["q"][i, :, :t] = new["q"]
                cache["s"][i, :, :t] = new["s"]
            else:
                cache[i, :, :t] = new
    return x, ks, vs


def _decode_step(params: dict, cfg: QwenVLConfig, tok: torch.Tensor, cur_pos: torch.Tensor,
                 ks, vs):
    """One-token step: tok [B], cur_pos [B] per-sample positions
    (lengths + step).  Writes each sample's new K/V row at its own
    position, in place, and returns (logits [B, vocab] f32, ks, vs)."""
    x = embed_lookup(params["wte"], tok[:, None], torch_dtype(cfg.dtype))  # [B, 1, H]
    cos, sin = rotary_cos_sin(cur_pos[:, None], cfg.head_dim, cfg.rope_base)
    kv_int8 = isinstance(ks, dict)
    t_max = (ks["q"] if kv_int8 else ks).shape[2]
    key_pos = torch.arange(t_max, device=x.device)[None, :]
    spec = AttnSpec(kv_valid=key_pos <= cur_pos[:, None], causal=False)
    rows = torch.arange(tok.shape[0], device=x.device)
    h = x
    for i in range(cfg.num_layers):
        layer = layer_at(params["layers"], i)
        q, k, v = project_qkv(rms_norm(h, layer["ln_1"], cfg.layer_norm_eps), layer, cfg, cos, sin)
        for cache, new in ((ks, k), (vs, v)):
            if kv_int8:
                new = _kv_quant(new[:, 0])
                cache["q"][i, rows, cur_pos] = new["q"]
                cache["s"][i, rows, cur_pos] = new["s"]
            else:
                cache[i, rows, cur_pos] = new[:, 0]
        h = h + attend(q, _kv_dequant(_cache_layer(ks, i), h.dtype),
                       _kv_dequant(_cache_layer(vs, i), h.dtype), spec, layer, cfg)
        h = h + mlp(rms_norm(h, layer["ln_2"], cfg.layer_norm_eps), layer, cfg)
    final = rms_norm(h, params["ln_f"], cfg.layer_norm_eps)
    return lm_logits(final[:, 0, :], params, cfg), ks, vs


def generate(params: dict, cfg: QwenVLConfig, input_ids: torch.Tensor, attn_mask: torch.Tensor,
             max_new_tokens: int = 32, images: torch.Tensor | None = None,
             image_positions: torch.Tensor | None = None, temperature: float = 0.0,
             top_k: int = 0, top_p: float = 1.0, eos_token_id: int | None = None,
             pad_token_id: int = 0, generator: torch.Generator | None = None,
             kv_int8: bool = False) -> torch.Tensor:
    """Greedy (temperature 0) or sampled generation.

    input_ids / attn_mask [B, T] right-padded prompts -> generated ids
    [B, max_new_tokens] (int64).  With ``eos_token_id`` every token after
    a sample's first EOS is ``pad_token_id``; all ``max_new_tokens - 1``
    decode steps run regardless, as tdax's static scan does.
    ``kv_int8`` stores the caches in int8 with per-(token, head) scales.
    Draws come from ``generator`` (on the logits' device)."""
    with torch.inference_mode():
        b, t = input_ids.shape
        lengths = attn_mask.sum(dim=1).to(torch.long)
        hidden, ks, vs = prefill(params, cfg, input_ids, attn_mask, images, image_positions,
                                 t_max=t + max_new_tokens, kv_int8=kv_int8)
        # logits at each prompt's last real token
        last_h = hidden[torch.arange(b, device=hidden.device), lengths - 1]
        logits = lm_logits(rms_norm(last_h, params["ln_f"], cfg.layer_norm_eps), params, cfg)

        def pick(lg):
            tok = sample_logits(lg, generator, temperature, top_k, top_p)
            return tok if temperature == 0.0 else tp_broadcast(tok)

        tok = pick(logits)
        done = tok == eos_token_id if eos_token_id is not None else None
        out = [tok]
        for i in range(max_new_tokens - 1):
            logits, ks, vs = _decode_step(params, cfg, tok, lengths + i, ks, vs)
            tok = pick(logits)
            if done is not None:
                tok = torch.where(done, pad_token_id, tok)
                done = done | (tok == eos_token_id)
            out.append(tok)
        return torch.stack(out, dim=1)
