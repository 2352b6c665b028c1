"""Weight-only int8 quantization (port of ``tdax/models/qwen_vl/quantize.py``).

Per-output-channel int8 weights: ``s = max|w| / 127`` over the input
dimension (at least 1e-12) and ``q = round(w / s)`` clipped to ±127,
round half to even, in f32, as tdax computes them, so ``q`` equals
tdax's exactly.  A quantized weight is the plain dict node
``{"q": int8 [..., in, out], "s": f32 [..., out]}``; ``qdot`` dispatches
on that structure, so fp and int8 parameter trees run through the same
forward code.  The full config's bf16 weights (19.3 GB) become ~9.7 GB.

Every int8 product goes through ``tdax_torch.ops.quant_matmul.qmm``: the
plain version on CPU tensors, the hand-written kernel on the card.

W8A8 (``set_w8a8(True)`` or ``TDAX_W8A8=1``, tdax's opt-in serving mode)
quantizes the activations too, per token (abs-max scale over the last
axis), and runs each int8 product as int8 x int8 -> int32
(``quant_matmul.int8_mm``).  Its arithmetic is tdax's step for step, so
on the CPU ``qdot`` equals tdax's bitwise.  The port is eager: the
switch is read at every ``qdot`` and takes effect at the next call,
where tdax's takes effect when the model step is traced.  It acts on
``{"q", "s"}`` nodes only; fp weights and ``embed_lookup`` are as
without it.
"""

from __future__ import annotations

import os

import torch

from tdax_torch.ops.quant_matmul import int8_mm, qmm

# weight names worth quantizing (the big matmuls); norms, biases and
# positions stay fp
_QUANT_KEYS = {
    "attn_qkv_w", "attn_proj_w", "mlp_w1", "mlp_w2", "mlp_proj_w",
    "mlp_fc_w", "lm_head", "wte", "patch_w", "kv_proj_w",
    "attn_q_w", "attn_k_w", "attn_v_w", "attn_out_w", "proj",
}


def _quantize_2d(w: torch.Tensor):
    wf = w.to(torch.float32)
    s = (wf.abs().amax(dim=-2) / 127.0).clamp_min(1e-12)
    q = torch.round(wf / s[None, :]).clamp_(-127, 127).to(torch.int8)
    return q, s


def quantize_weight(w: torch.Tensor) -> dict:
    """[..., in, out] float -> {"q": int8 [..., in, out], "s": f32 [..., out]}.

    A stacked weight is quantized one [in, out] slice at a time (the
    scales are per slice anyway), so the f32 transient is one layer's."""
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    s = torch.empty(w.shape[:-2] + w.shape[-1:], dtype=torch.float32, device=w.device)
    flat_w = w.reshape(-1, *w.shape[-2:])
    flat_q, flat_s = q.view(-1, *w.shape[-2:]), s.view(-1, w.shape[-1])
    for i in range(flat_w.shape[0]):
        flat_q[i], flat_s[i] = _quantize_2d(flat_w[i])
    return {"q": q, "s": s}


def is_quantized(node) -> bool:
    return isinstance(node, dict) and set(node) == {"q", "s"}


_W8A8 = [False]


def set_w8a8(enabled: bool) -> None:
    """Turn W8A8 serving on or off for this process (see the module's
    docstring); ``TDAX_W8A8=1`` turns it on as well."""
    _W8A8[0] = bool(enabled)


def w8a8_enabled() -> bool:
    return _W8A8[0] or os.environ.get("TDAX_W8A8") == "1"


def quantize_activations(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token int8 activations, as tdax: s_x = max|x| / 127 over the
    last axis (at least 1e-12), xq = round(x / s_x) (half to even) clipped
    to +-127, in f32.  Returns (xq int8 [..., K], s_x f32 [..., 1]).  The
    divisor 127 is a tensor on x's device: torch's CUDA division by a
    host scalar multiplies by its reciprocal, which can differ by an ulp."""
    s_x = x.abs().amax(-1, keepdim=True).float()
    s_x = (s_x / torch.full((), 127.0, device=x.device)).clamp_min_(1e-12)
    # x / s_x promotes a bf16 x to f32 exactly, as tdax's x.astype(f32)
    return (x / s_x).round_().clamp_(-127, 127).to(torch.int8), s_x


def qdot(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` for an fp weight (f32 accumulation, one cast), or the
    int8 product for a {"q", "s"} node: weight-only through ``qmm``, or
    under W8A8 int8 activations times the int8 weight, then
    (acc * s_x) * s in f32 and one cast."""
    if is_quantized(w):
        if w8a8_enabled():
            xq, s_x = quantize_activations(x)
            acc = int8_mm(xq.reshape(-1, xq.shape[-1]), w["q"])
            out = torch.mul(acc, s_x.reshape(-1, 1)).mul_(w["s"])
            return out.to(x.dtype).reshape(*x.shape[:-1], out.shape[-1])
        return qmm(x, w["q"], w["s"])
    return x @ w


class _Embed(torch.autograd.Function):
    """``wte[ids]`` whose gradient is summed in a fixed order: the
    backward scatter-adds under ``torch.use_deterministic_algorithms``,
    so repeated ids give the same bits on every run (the card's default
    index backward adds with atomics), as a bitwise training resume
    needs."""

    @staticmethod
    def forward(ctx, wte, ids):
        ctx.save_for_backward(ids)
        ctx.table_shape = wte.shape
        return wte[ids]

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        out = grad.new_zeros(ctx.table_shape)
        was = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True)
        try:
            out.index_put_((ids,), grad, accumulate=True)
        finally:
            torch.use_deterministic_algorithms(was)
        return out, None


def embed_lookup(wte, ids: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Token-embedding gather for fp or int8 tables; an int8 row is
    scaled in the model dtype, as tdax does.  A table that needs its
    gradient goes through ``_Embed``."""
    if is_quantized(wte):
        return wte["q"][ids].to(dtype) * wte["s"].to(dtype)
    if torch.is_grad_enabled() and wte.requires_grad:
        return _Embed.apply(wte, ids)
    return wte[ids]


def layer_at(stacked, i: int) -> dict:
    """Layer i's weights out of a stacked [n_layers, ...] tree (views);
    a quantized node gives its q [in, out] and s [out] of that layer.
    A list of per-layer trees (the training view of a stacked tree,
    ``tdax_torch.parallel.train``) gives its i-th entry."""
    if isinstance(stacked, list):
        return stacked[i]
    return {name: {"q": w["q"][i], "s": w["s"][i]} if is_quantized(w) else w[i]
            for name, w in stacked.items()}


def quantize_params(params: dict) -> dict:
    """Quantize every large matmul weight of a qwen_vl parameter tree;
    nodes already quantized stay as they are."""
    out = {}
    for name, leaf in params.items():
        if isinstance(leaf, dict):
            out[name] = quantize_params(leaf)
        elif name in _QUANT_KEYS:
            out[name] = quantize_weight(leaf)
        else:
            out[name] = leaf
    return out


def quantized_bytes(params: dict) -> int:
    """Bytes held by every tensor of a (possibly quantized) tree."""
    total = 0
    for leaf in params.values():
        total += quantized_bytes(leaf) if isinstance(leaf, dict) else (
            leaf.numel() * leaf.element_size())
    return total


def init_params_quantized(cfg, device, seed: int = 0, with_visual: bool = True) -> dict:
    """Random parameters drawn straight into int8, leaf by leaf: the bf16
    tree never exists whole (19.3 GB for the full config), only one
    weight's draw at a time.  The draws are ``init_params``'s, in its
    order, from the same generator, so the result equals
    ``quantize_params(init_params(cfg, device, seed, with_visual=with_visual))``;
    ``with_visual=False`` leaves out the visual tree, as tdax's flag."""
    from tdax_torch.models.qwen_vl.model import init_params

    return init_params(cfg, device, seed, quantize=True, with_visual=with_visual)
