"""Ring attention: context-parallel self-attention over a mesh axis (port
of ``tdax/ops/ring_attention.py``).

Context parallelism shards the sequence axis of q, k and v over a mesh
axis ("cp"), so a rank's attention memory scales as T / cp.  Each rank
holds one contiguous chunk of q, k, v and of the key-validity bias; the
(k, v, bias) chunks rotate around the ring by ``mesh.ppermute`` and each
step's attention of the local q chunk against the visiting chunk is
merged through the softmax log-normalizers: with m = max(lse_a, lse_b),

    lse = m + log(e^{lse_a - m} + e^{lse_b - m})
    o   = (o_a e^{lse_a - m} + o_b e^{lse_b - m}) / (e^{lse_a - m} + e^{lse_b - m}),

the online-softmax combine the kernel uses across its key tiles, lifted
to ring steps.  Every step's attention is the flash kernels' (o, lse)
(``flash_attention.FlashAttentionLse``: the forward kernel with lse, and
in the backward the dq and dk/dv kernels with delta' = rowsum(dO * O) -
dlse); on CPU tensors their plain versions.

The causal ring uses tdax's zigzag layout: the sequence as 2cp halves,
rank i holding halves (i, 2cp-1-i), so every step costs every rank the
same two dense half-blocks (its self step three; ``_zigzag_step_blocks``):
  * the visiting pair is the rank's own: causal attention of the
    concatenated halves (their global order is increasing, so the
    kernel's local lower triangle is the global mask);
  * it comes from a rank j < i: both local q halves attend the visiting
    early half only (its late half is in every local row's future);
  * from j > i: only the local late half attends, to both visiting
    halves.
The relayout is one permute op on entry (the early and late halves of q,
k, v and the bias: two permutations, ``_zigzag_tables``) and one on exit
(the output's halves back to contiguous order).  A dense ring, a causal
ring whose local chunk is odd, and ``TDAX_NO_ZIGZAG=1`` keep contiguous
chunks; there a causal rank skips its future chunks.

What the port writes by hand where tdax has ``lax.scan`` under
``shard_map``:
  * the steps are a Python loop (the step's case is known on the host:
    each rank knows which rank's chunk visits), and the ring makes cp - 1
    rotations, not tdax's cp: the last rotation's result is never read;
  * a step's (k, v, bias) rotate through one permute op (tagged sends, in
    one order on every rank), forward, backward and in remat's replay, so
    gloo can neither deadlock on two orders nor swap k and v;
  * the rotations are one autograd node (``_Rotations``): a rank whose
    causal schedule never reads a visiting chunk (the contiguous ring's
    future chunks) still sends its share of every rotation's gradient, so
    every rank runs the backward's cp - 1 inverse permutes.

Convention: the kernel gives lse = 0 (not -inf) for a row with no visible
key; its backward's p = exp(s - lse) relies on it.  The merge would
weight such a row wrongly, so ``_chunk_attn`` rewrites its lse to NEG_INF
from the bias itself, outside ``FlashAttentionLse``: row r of a causal
chunk sees a valid key iff any of bias[:r+1] is finite (a cumulative
any), a dense chunk's rows all see the same keys (a plain any).

Every function here that takes a mesh is collective over its cp group,
forward and backward: every rank of it calls it in the same order.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from tdax_torch.ops.flash_attention import NEG_INF, flash_attention_lse
from tdax_torch.parallel import mesh as pm


def _chunk_attn(q, k, v, bias, causal: bool):
    """One ring step's attention: (o [B, Tq, nh, hd] in q.dtype, lse
    [B, nh, Tq] f32 with NEG_INF on rows that see no valid key)."""
    o, lse = flash_attention_lse(q, k, v, bias, causal)
    kvalid = bias > NEG_INF / 2                            # [B, Tk]
    if causal:
        row_valid = torch.cumsum(kvalid.to(torch.int32), dim=1) > 0
    else:
        row_valid = kvalid.any(dim=1, keepdim=True)        # [B, 1]
    return o, torch.where(row_valid[:, None, :], lse, NEG_INF)


def _merge(o_acc, lse_acc, o_s, lse_s):
    """Online-softmax combine of two partial results, in f32: o [B, T,
    nh, hd], lse [B, nh, T].  One weight is always exactly 1, so the
    denominator is at least 1."""
    m = torch.maximum(lse_acc, lse_s)
    w_acc = torch.exp(lse_acc - m)
    w_s = torch.exp(lse_s - m)
    lse_new = m + torch.log(w_acc + w_s)
    wa = w_acc.transpose(1, 2)[..., None]                  # [B, T, nh, 1]
    ws = w_s.transpose(1, 2)[..., None]
    return (o_acc * wa + o_s.float() * ws) / (wa + ws), lse_new


# --- zigzag layout ------------------------------------------------------------

def _zigzag_tables(cp: int):
    """Routing tables of the zigzag half-chunk layout (tdax's).

    Contiguous rank i holds halves (2i, 2i+1); zigzag rank j holds (j,
    2cp-1-j).  Half h's zigzag home is min(h, 2cp-1-h), and a rank's two
    halves have opposite parity, so the relayout is two permutations:
    ``p_lo`` routes every contiguous early half (2i) and ``p_hi`` every
    late half (2i+1).  ``a_is_lo[j]`` says whether the half reaching j
    through p_lo is j's zigzag early slot (value j) or its late one."""
    d_lo = [2 * i if 2 * i < cp else 2 * cp - 1 - 2 * i for i in range(cp)]
    d_hi = [2 * i + 1 if 2 * i + 1 < cp else 2 * cp - 2 - 2 * i for i in range(cp)]
    assert sorted(d_lo) == list(range(cp)) and sorted(d_hi) == list(range(cp))
    p_lo = [(i, d_lo[i]) for i in range(cp)]
    p_hi = [(i, d_hi[i]) for i in range(cp)]
    inv_lo = [(d_lo[i], i) for i in range(cp)]
    inv_hi = [(d_hi[i], i) for i in range(cp)]
    a_is_lo = np.zeros(cp, dtype=bool)
    for i in range(cp):
        a_is_lo[d_lo[i]] = 2 * i == d_lo[i]
    return p_lo, p_hi, inv_lo, inv_hi, a_is_lo


def _zigzag_step_blocks(cp: int, device: int, src: int) -> int:
    """Dense half-blocks rank ``device`` computes when the visiting pair
    comes from ``src`` (a causal half-block counts 1, as the kernel's
    tile skipping makes it)."""
    if src == device:
        return 3        # lo-lo causal + hi-lo dense + hi-hi causal
    return 2            # past: 2 q halves x 1 k half; future: 1 x 2


def _to_zigzag(xs: list, mesh, axis: str) -> list:
    """Each [B, T_local, ...] tensor of ``xs`` from contiguous chunks to
    this rank's zigzag halves (one permute op for all)."""
    p_lo, p_hi, _, _, a_is_lo = _zigzag_tables(mesh.shape[axis])
    hl = xs[0].shape[1] // 2
    halves = [x.narrow(1, 0, hl) for x in xs] + [x.narrow(1, hl, hl) for x in xs]
    recv = pm.ppermute(halves, mesh, axis, [p_lo] * len(xs) + [p_hi] * len(xs))
    early_first = bool(a_is_lo[mesh.local_rank(axis)])
    return [torch.cat([a, b] if early_first else [b, a], dim=1)
            for a, b in zip(recv[:len(xs)], recv[len(xs):])]


def _from_zigzag(x, mesh, axis: str):
    """``_to_zigzag``'s inverse for one tensor."""
    _, _, inv_lo, inv_hi, _ = _zigzag_tables(mesh.shape[axis])
    hl = x.shape[1] // 2
    lo, hi = x.narrow(1, 0, hl), x.narrow(1, hl, hl)    # halves my, 2cp-1-my
    even, odd = (lo, hi) if mesh.local_rank(axis) % 2 == 0 else (hi, lo)
    recv_lo, recv_hi = pm.ppermute([even, odd], mesh, axis, [inv_lo, inv_hi])
    return torch.cat([recv_lo, recv_hi], dim=1)


def _rotate(k, v, bias, mesh, axis: str) -> list:
    """[k, v, bias] of every ring step, flat: step s holds the chunk of rank
    my - s, after s rotations to the next rank (cp - 1 in all), each one
    permute op for the three."""
    cp = mesh.shape[axis]
    perm = [(i, (i + 1) % cp) for i in range(cp)]
    out = [k, v, bias]
    for _ in range(cp - 1):
        out += pm._exchange(out[-3:], mesh, axis, [perm] * 3)
    return out


class _Rotations(torch.autograd.Function):
    """``_rotate`` as one autograd node: its backward sends the summed
    gradient back around the ring (cp - 1 inverse rotations), a zero one
    where this rank read no step's chunk."""

    @staticmethod
    def forward(ctx, mesh, axis, k, v, bias):
        ctx.mesh, ctx.axis = mesh, axis
        ctx.set_materialize_grads(False)
        out = _rotate(k, v, bias, mesh, axis)
        out[:3] = [t.view_as(t) for t in out[:3]]  # the step-0 outputs view the inputs
        ctx.mark_non_differentiable(*out[2::3])
        ctx.like = (k.shape, k.dtype, k.device)  # not k itself: remat frees it
        return tuple(out)

    @staticmethod
    def backward(ctx, *gs):
        cp = ctx.mesh.shape[ctx.axis]
        inv = [((i + 1) % cp, i) for i in range(cp)]
        shape, dtype, device = ctx.like
        acc = [torch.zeros(shape, dtype=dtype, device=device) if g is None else g
               for g in gs[-3:-1]]
        for s in range(cp - 2, -1, -1):
            acc = pm._exchange(acc, ctx.mesh, ctx.axis, [inv, inv])
            acc = [a if g is None else a + g for a, g in zip(acc, gs[3 * s:3 * s + 2])]
        return None, None, acc[0], acc[1], None


def _rotations(k, v, bias, mesh, axis: str) -> list:
    """[(k, v, bias) of each ring step] (``_rotate``; under autograd one
    node, ``_Rotations``)."""
    if torch.is_grad_enabled() and (k.requires_grad or v.requires_grad):
        out = _Rotations.apply(mesh, axis, k, v, bias)
    else:
        out = _rotate(k, v, bias, mesh, axis)
    return [tuple(out[i:i + 3]) for i in range(0, len(out), 3)]


def _ring_zigzag(q, k, v, bias, mesh, axis: str):
    """The causal ring in the zigzag layout (see the module's docstring)."""
    b, tl, nh, hd = q.shape
    hl = tl // 2
    cp, my = mesh.shape[axis], mesh.local_rank(axis)
    qz, kz, vz, bz = _to_zigzag([q, k, v, bias], mesh, axis)
    o_acc = torch.zeros((b, tl, nh, hd), dtype=torch.float32, device=q.device)
    lse_acc = torch.full((b, nh, tl), NEG_INF, dtype=torch.float32, device=q.device)
    for s, (kc, vc, bc) in enumerate(_rotations(kz, vz, bz, mesh, axis)):
        src = (my - s) % cp
        if src == my:
            o_s, lse_s = _chunk_attn(qz, kc, vc, bc, True)
        elif src < my:
            o_s, lse_s = _chunk_attn(qz, kc[:, :hl], vc[:, :hl], bc[:, :hl], False)
        else:
            o_hi, lse_hi = _chunk_attn(qz[:, hl:], kc, vc, bc, False)
            o_s = torch.cat([o_hi.new_zeros((b, hl, nh, hd)), o_hi], dim=1)
            lse_s = torch.cat([lse_hi.new_full((b, nh, hl), NEG_INF), lse_hi], dim=2)
        o_acc, lse_acc = _merge(o_acc, lse_acc, o_s, lse_s)
    return _from_zigzag(o_acc.to(q.dtype), mesh, axis)


def _ring_contiguous(q, k, v, bias, causal: bool, mesh, axis: str):
    """The ring over contiguous chunks; a causal rank skips the chunks in
    its future (tdax merges a zero result there: the same values on every
    row that sees a key)."""
    b, tl, nh, hd = q.shape
    cp, my = mesh.shape[axis], mesh.local_rank(axis)
    o_acc = torch.zeros((b, tl, nh, hd), dtype=torch.float32, device=q.device)
    lse_acc = torch.full((b, nh, tl), NEG_INF, dtype=torch.float32, device=q.device)
    for s, (kc, vc, bc) in enumerate(_rotations(k, v, bias, mesh, axis)):
        chunk = (my - s) % cp
        if causal and chunk > my:
            continue
        o_s, lse_s = _chunk_attn(q, kc, vc, bc, causal and chunk == my)
        o_acc, lse_acc = _merge(o_acc, lse_acc, o_s, lse_s)
    return o_acc.to(q.dtype)


def ring_attention(q, k, v, kv_valid, causal: bool, mesh, batch_axis: str | None,
                   head_axis: str | None, seq_axis: str):
    """Context-parallel self-attention on this rank's chunk: q, k, v [B, T
    / cp, nh, hd] (its rows of ``batch_axis`` and heads of ``head_axis``
    too, as the model holds them), ``kv_valid`` the chunk's [B, T / cp]
    key validity or None -> the chunk's [B, T / cp, nh, hd] output.
    Dispatched by ``mha`` under ``flash_sharding(mesh, ..., seq_axis=)``.
    Collective over ``seq_axis``'s group."""
    b, tl = q.shape[0], q.shape[1]
    if kv_valid is not None:
        bias = torch.where(kv_valid > 0, 0.0, NEG_INF).to(torch.float32)
    else:
        bias = torch.zeros((b, tl), dtype=torch.float32, device=q.device)
    if tuple(bias.shape) != (b, tl):
        raise ValueError(f"ring_attention: kv_valid must be the chunk's [B, T_local] = "
                         f"{(b, tl)}, got {tuple(bias.shape)}")
    # the zigzag layout needs an even chunk; TDAX_NO_ZIGZAG=1 (read at each
    # call) is tdax's A/B switch
    if causal and tl % 2 == 0 and os.environ.get("TDAX_NO_ZIGZAG") != "1":
        return _ring_zigzag(q, k, v, bias, mesh, seq_axis)
    return _ring_contiguous(q, k, v, bias, causal, mesh, seq_axis)


def local_chunk(t: int):
    """(offset, length) of this rank's chunk of a T-long sequence under
    an active ``flash_sharding(..., seq_axis=)``, else None.  Raises
    ValueError when the axis does not divide T: a rank holds only its
    chunk, so there is no replicated path to fall back on."""
    from tdax_torch.ops.flash_attention import current_flash_sharding
    ctx = current_flash_sharding()
    if ctx is None or ctx[3] is None:
        return None
    mesh, axis = ctx[0], ctx[3]
    cp = mesh.shape[axis]
    if t % cp:
        raise ValueError(f"context parallelism: {t} positions do not divide over the {cp} "
                         f"ranks of mesh axis {axis!r}")
    return mesh.local_rank(axis) * (t // cp), t // cp
