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
shapes, the two row-parallel products (``attn_proj_w``, ``mlp_proj_w``)
are summed over the tp group (``tp.tp_row_product``) and the inputs of
the column-parallel ones pass through ``tp.tp_input`` (their gradient
summed over tp).  ``seq_sharding`` (a ``(mesh, axis)`` pair, tdax's
Megatron sequence parallelism) keeps each rank's T / tp rows of the
residual stream between the products: the norms and the residual adds
run on them, the sequence is gathered before the column-parallel
products and reduce-scattered after the row-parallel ones, and
attention runs on the whole sequence with its rotary positions.
Under FSDP (``fsdp.gathering``) a block gathers its layer's dp-sharded
weights at its start.  Under context parallelism (``flash_sharding``'s
``seq_axis``) ``decoder`` keeps each rank's contiguous chunk of the
sequence from the first block to the last, attention running as the ring
(``tdax_torch.ops.ring_attention``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from tdax_torch.models.qwen_vl import fsdp
from tdax_torch.models.qwen_vl.config import QwenVLConfig
from tdax_torch.models.qwen_vl.quantize import is_quantized, layer_at, qdot
from tdax_torch.models.qwen_vl.tp import seq_scatter, seq_weight, tp_input, tp_row_product
from tdax_torch.ops.flash_attention import AttnSpec, current_flash_sharding, mha
from tdax_torch.ops.ring_attention import local_chunk
from tdax_torch.utils.log import span


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


def _width(w) -> int:
    return (w["q"] if is_quantized(w) else w).shape[-1]


def local_heads(layers: dict, cfg: QwenVLConfig) -> int:
    """The attention heads the layer weights hold: ``cfg.num_heads``, or
    this rank's share under tp."""
    return _width(layers["attn_qkv_w"]) // (3 * cfg.head_dim)


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


def attend(q, k, v, spec: AttnSpec, layer: dict, cfg: QwenVLConfig,
           seq=None) -> torch.Tensor:
    """Attention + output projection: [B, Tq, nh, hd] -> [B, Tq, H]
    (under ``seq`` the rank's rows of Tq)."""
    b, tq, nh, hd = q.shape
    out = mha(q, k, v, spec).reshape(b, tq, nh * hd)
    w = layer["attn_proj_w"]
    return qdot(out, w) if nh == cfg.num_heads else tp_row_product(out, w, seq)


def mlp(x: torch.Tensor, layer: dict, cfg: QwenVLConfig, seq=None) -> torch.Tensor:
    """QWen SwiGLU: c_proj(w1(x) * silu(w2(x)))."""
    x = tp_input(x, _width(layer["mlp_w1"]) < cfg.ff_half, seq)
    a1 = qdot(x, layer["mlp_w1"])
    a2 = qdot(x, layer["mlp_w2"])
    inter = a1 * F.silu(a2.float()).to(x.dtype)
    w = layer["mlp_proj_w"]
    return qdot(inter, w) if inter.shape[-1] == cfg.ff_half else tp_row_product(inter, w, seq)


def block_kv(x: torch.Tensor, layer: dict, cfg: QwenVLConfig,
             cos: torch.Tensor, sin: torch.Tensor, spec: AttnSpec, seq=None):
    """One block; returns (x, this layer's rotated k, v) for a KV cache.
    Under FSDP the layer's dp-sharded weights are gathered here, inside
    what remat replays (``fsdp.leaves``)."""
    layer = fsdp.leaves(layer, ("layers",))
    h1 = rms_norm(x, seq_weight(layer["ln_1"], seq), cfg.layer_norm_eps)
    h1 = tp_input(h1, local_heads(layer, cfg) < cfg.num_heads, seq)
    q, k, v = project_qkv(h1, layer, cfg, cos, sin)
    x = x + attend(q, k, v, spec, layer, cfg, seq)
    h2 = rms_norm(x, seq_weight(layer["ln_2"], seq), cfg.layer_norm_eps)
    return x + mlp(h2, layer, cfg, seq), k, v


def block(x: torch.Tensor, layer: dict, cfg: QwenVLConfig,
          cos: torch.Tensor, sin: torch.Tensor, spec: AttnSpec, seq=None) -> torch.Tensor:
    return block_kv(x, layer, cfg, cos, sin, spec, seq)[0]


def _rotary_and_spec(x: torch.Tensor, cfg: QwenVLConfig, attn_mask: torch.Tensor,
                     chunk: tuple[int, int] | None = None):
    """Rotary cos / sin and the causal spec of x's whole sequence, or with
    ``chunk`` (offset, length: context parallelism) of this rank's chunk
    of it: the chunk's global positions and its rows of the mask.  The
    whole sequence under an active seq axis is refused: there ``mha``
    takes its q, k and v for a chunk."""
    b, t, _ = x.shape
    if chunk is None:
        ctx = current_flash_sharding()
        if ctx is not None and ctx[3] is not None:
            raise NotImplementedError("under flash_sharding(seq_axis=) only the training "
                                      "forward (model.forward) is ported; the capture and "
                                      "generation run without a seq axis")
        chunk = (0, t)
    start, n = chunk
    positions = torch.arange(start, start + n, device=x.device)[None, :].expand(b, n)
    cos, sin = rotary_cos_sin(positions, cfg.head_dim, cfg.rope_base)
    kv_valid = attn_mask if n == t else attn_mask.narrow(1, start, n)
    return cos, sin, AttnSpec(kv_valid=kv_valid, causal=True)


def decoder_capture(stacked_layers: dict, x: torch.Tensor, cfg: QwenVLConfig,
                    attn_mask: torch.Tensor,
                    last_token_idx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Run all blocks; return (final hidden [B, T, H], capture
    [n_layers, B, H] of the last-token vector after each block).  The
    gather of row ``last_token_idx`` equals tdax's one-hot contraction."""
    cos, sin, spec = _rotary_and_spec(x, cfg, attn_mask)
    rows = torch.arange(x.shape[0], device=x.device)
    captures = []
    with span("decoder"):
        for i in range(cfg.num_layers):
            x = block(x, layer_at(stacked_layers, i), cfg, cos, sin, spec)
            captures.append(x[rows, last_token_idx])
    return x, torch.stack(captures)


def decoder(stacked_layers, x: torch.Tensor, cfg: QwenVLConfig,
            attn_mask: torch.Tensor, remat: bool = False, seq_sharding=None) -> torch.Tensor:
    """Plain depth loop without capture (training / generation path).

    ``remat=True`` wraps each block in ``torch.utils.checkpoint``
    (non-reentrant): the backward keeps only each block's input and
    replays the block, one more flash forward per layer included (and,
    under tp, the block's collectives, in the forward's order on every
    rank).  tdax instead saves the dots and the flash residuals
    (``remat_policy``); the values are the same, the recompute is not.

    ``seq_sharding`` (``(mesh, axis)``, x whole on every rank) returns
    this rank's rows of the final hidden state: the sequence is split
    over ``axis`` before the first block.

    Under ``flash_sharding(..., seq_axis=)`` (context parallelism; x
    whole on every rank) it returns this rank's contiguous chunk of the
    final hidden state: the chunk is taken before the first block, its
    rotary angles come from its global positions, and each block's
    attention is the ring over the seq axis on the chunk's rows of
    ``attn_mask``.  Norms and the MLP run on the chunk; no block gathers
    the sequence."""
    chunk = local_chunk(x.shape[1])
    if chunk is not None and seq_sharding is not None:
        raise ValueError("context parallelism (flash_sharding seq_axis) and sequence "
                         "parallelism (seq_sharding) both shard the sequence")
    cos, sin, spec = _rotary_and_spec(x, cfg, attn_mask, chunk)
    if seq_sharding is not None:
        x = seq_scatter(x, seq_sharding)
    if chunk is not None:
        x = x.narrow(1, *chunk)
    return blocks(stacked_layers, x, cfg, cos, sin, spec, remat, seq_sharding)


def depth(stacked_layers) -> int:
    """The number of blocks a stacked tree holds (its leaves' leading
    dimension), or a training view's list of per-layer trees."""
    if isinstance(stacked_layers, list):
        return len(stacked_layers)
    w = next(iter(stacked_layers.values()))
    return (w["q"] if is_quantized(w) else w).shape[0]


def blocks(stacked_layers, x: torch.Tensor, cfg: QwenVLConfig, cos: torch.Tensor,
           sin: torch.Tensor, spec: AttnSpec, remat: bool = False, seq=None) -> torch.Tensor:
    """Every block of ``stacked_layers`` in order, whatever its depth
    (``depth``: a pipeline stage holds its [L / pp, ...] slice), on one
    rotary cos / sin and attention spec, as tdax's ``_stage_apply``.
    ``remat`` and ``seq`` as ``decoder``'s.  The loop is the
    ``tdax.decoder`` span; remat's replays run under the backward's."""
    with span("decoder"):
        for i in range(depth(stacked_layers)):
            layer = layer_at(stacked_layers, i)
            if remat:
                x = torch.utils.checkpoint.checkpoint(block, x, layer, cfg, cos, sin, spec,
                                                      seq, use_reentrant=False)
            else:
                x = block(x, layer, cfg, cos, sin, spec, seq)
    return x
