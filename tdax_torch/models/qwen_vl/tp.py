"""The model's tensor-parallel collectives and their backward.

Under tp each rank holds a slice of every sharded site's weights
(``tdax_torch.parallel.mesh.shard_params``): the column-parallel
products give it its own heads (or MLP columns, or vocabulary columns),
and the row-parallel ones a partial sum.  A site knows it is sharded by
its local width, smaller than the config's; a site whose heads tp does
not divide holds whole weights and needs no collective.  The tp group
is the head axis of the active ``flash_sharding`` context, which the
caller enters as tdax's callers do; a sharded site without one raises.
Without sharded weights nothing here runs a collective, and the
single-device path is as it was.

Training runs through ``torch.autograd.Function``s, Megatron's
conjugate pairs:
- a row-parallel product sums its f32 partials over tp; the backward
  hands the gradient to each rank's partial as it is;
- a column-parallel product's replicated input passes through
  ``tp_input``: the identity forward, the input's gradient summed over
  tp in the backward, so the norms and the embedding before it see
  every rank's heads;
- the vocab-parallel logits' gather slices the gradient to the rank's
  own columns.

Sequence parallelism (``seq``, a ``(mesh, axis)`` pair: tdax's
``seq_sharding``) keeps T / tp rows of the residual stream on each rank
between the products: ``seq_scatter`` takes the rank's rows (backward:
gather), ``tp_input`` gathers the sequence before a column-parallel
product (backward: reduce-scatter) and ``tp_row_product`` reduce-scatters
its partials (backward: gather).  A norm weight on the local rows passes
through ``seq_weight``, whose backward sums its gradient over tp.  Under
gloo a reduce-scatter is an all_reduce of the whole tensor and the
rank's slice of it (``mesh.reduce_scatter``).

Every function here is collective over the tp group, forward and
backward: every rank of it calls it in the same order.
"""

from __future__ import annotations

import torch

from tdax_torch.models.qwen_vl.quantize import is_quantized
from tdax_torch.ops.flash_attention import current_flash_sharding
from tdax_torch.parallel import mesh as pm


def _tp(where: str):
    """The tp group's (mesh, axis); raises where there is none."""
    ctx = current_flash_sharding()
    if ctx is None or ctx[2] is None:
        raise RuntimeError(f"{where}: the weights are tp-sharded; run the model inside "
                           "flash_sharding(mesh, batch_axis='dp', head_axis='tp')")
    return ctx[0], ctx[2]


def _needs_grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def _summed(g: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """g summed over ``axis`` in f32 (a new tensor), cast back to g's dtype."""
    acc = g.to(torch.float32, memory_format=torch.contiguous_format, copy=True)
    return pm.all_reduce(acc, mesh, axis).to(g.dtype)


def _rows(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """This rank's T / p rows of x's sequence (dim 1) over ``axis``."""
    per = x.shape[1] // mesh.shape[axis]
    return x.narrow(1, mesh.local_rank(axis) * per, per)


class _SumOver(torch.autograd.Function):
    """Sum over the group in the forward (in place), the gradient as it
    is in the backward: each rank's partial gets the whole sum's."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mark_dirty(x)
        return pm.all_reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyTo(torch.autograd.Function):
    """The identity forward; the gradient summed over the group."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.mesh, ctx.axis), None, None


class _GatherLast(torch.autograd.Function):
    """Every rank's shard along the last dim; the backward keeps the
    rank's own columns of the gradient."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis, ctx.width = mesh, axis, x.shape[-1]
        return pm.all_gather(x, mesh, axis, dim=-1)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(-1, ctx.mesh.local_rank(ctx.axis) * ctx.width, ctx.width), None, None


class _GatherSeq(torch.autograd.Function):
    """The whole sequence from every rank's rows; backward: the
    gradient reduce-scattered (summed over the group, the rank's rows)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return pm.all_gather(x, mesh, axis, dim=1)

    @staticmethod
    def backward(ctx, g):
        acc = g.to(torch.float32, memory_format=torch.contiguous_format, copy=True)
        return pm.reduce_scatter(acc, ctx.mesh, ctx.axis, dim=1).to(g.dtype), None, None


class _ScatterSeq(torch.autograd.Function):
    """The rank's rows of a replicated sequence; backward: the rows'
    gradients gathered."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _rows(x, mesh, axis).contiguous()

    @staticmethod
    def backward(ctx, g):
        return pm.all_gather(g.contiguous(), ctx.mesh, ctx.axis, dim=1), None, None


class _ReduceScatterSeq(torch.autograd.Function):
    """Partials summed over the group, the rank's rows kept; backward:
    the rows' gradients gathered."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return pm.reduce_scatter(x, mesh, axis, dim=1)

    @staticmethod
    def backward(ctx, g):
        return pm.all_gather(g.contiguous(), ctx.mesh, ctx.axis, dim=1), None, None


def sum_over(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """x summed over ``axis``'s group (x, a fresh tensor, overwritten);
    under autograd the gradient reaches each rank's x as it is (the
    train step's dp sum of its loss numerator)."""
    if _needs_grad(x):
        return _SumOver.apply(x, mesh, axis)
    return pm.all_reduce(x, mesh, axis)


def tp_row_product(x: torch.Tensor, w, seq=None) -> torch.Tensor:
    """``x @ w`` at a row-parallel site under tp (``attn_proj_w``,
    ``mlp_proj_w``, the resampler's ``attn_out_w``; with whole weights
    the site calls ``qdot``).  The rank's partial product over its input
    rows is kept in f32 (bf16 inputs multiply exactly, the sum is f32),
    summed over the tp group in f32 and cast once to x's dtype, as
    tdax's GSPMD sums its f32 partials before the cast.  Under ``seq``
    the sum is reduce-scattered to the rank's rows of the sequence."""
    if is_quantized(w):
        raise NotImplementedError("tp_row_product: int8 weights under tp are not ported")
    partial = torch.matmul(x.float(), w.float())
    if seq is not None:
        return _ReduceScatterSeq.apply(partial, *seq).to(x.dtype)
    return sum_over(partial, *_tp("tp_row_product")).to(x.dtype)


def tp_input(x: torch.Tensor, sharded: bool, seq=None) -> torch.Tensor:
    """The input of a column-parallel product (whose weights this rank
    holds a shard of when ``sharded``).  Under ``seq`` the sequence
    gathered from every rank's rows; else, when autograd needs it at a
    sharded site, x with its gradient summed over the tp group; else x.
    Sequence parallelism needs every site split (a whole site's
    gradient would be summed tp times)."""
    if seq is not None:
        if not sharded and seq[0].shape[seq[1]] > 1:
            raise NotImplementedError("sequence parallelism needs tp to divide the heads, "
                                      "the MLP width and the vocabulary")
        return _GatherSeq.apply(x, *seq)
    if sharded and _needs_grad(x):
        return _CopyTo.apply(x, *_tp("tp_input"))
    return x


def seq_scatter(x: torch.Tensor, seq) -> torch.Tensor:
    """The rank's T / tp rows of a sequence every rank holds whole."""
    mesh, axis = seq
    if x.shape[1] % mesh.shape[axis]:
        raise ValueError(f"sequence parallelism: {x.shape[1]} positions do not divide over "
                         f"the {mesh.shape[axis]} ranks of mesh axis {axis!r}")
    return _ScatterSeq.apply(x, mesh, axis)


def seq_weight(w: torch.Tensor, seq) -> torch.Tensor:
    """A replicated weight applied to the rank's rows under ``seq``: its
    gradient, each rank's rows' share, summed over the group."""
    if seq is None or not _needs_grad(w):
        return w
    return _CopyTo.apply(w, *seq)


def tp_gather(x: torch.Tensor, sharded: bool) -> torch.Tensor:
    """The vocab-parallel logits' shards of the tp group along the last
    dimension, so every rank holds the whole ``[..., vocab]``."""
    if not sharded:
        return x
    mesh, axis = _tp("tp_gather")
    if _needs_grad(x):
        return _GatherLast.apply(x, mesh, axis)
    return pm.all_gather(x, mesh, axis, dim=-1)


def tp_broadcast(tok: torch.Tensor) -> torch.Tensor:
    """The tp group's first rank's ``tok`` on every rank of the group
    (a sampled token: each rank's draw would differ); unchanged with no
    tp axis."""
    ctx = current_flash_sharding()
    if ctx is None or ctx[2] is None or ctx[0].shape[ctx[2]] == 1:
        return tok
    return pm.broadcast(tok.contiguous(), ctx[0], ctx[2])
