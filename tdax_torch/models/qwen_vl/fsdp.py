"""FSDP (ZeRO-3) in the model: each dp-sharded weight gathered where it is read.

Under ``fsdp_sharding_rules`` each rank holds its contiguous 1/dp of
every large leaf, along the dimension its spec names ``"dp"``
(``tdax_torch.parallel.mesh.shard_params``).  Inside
``gathering(param_shardings)``, which the train step enters as it
enters ``flash_sharding`` for tp, each site of the model passes the
weights it reads through ``leaf`` or ``leaves``.  A leaf whose rule
names dp goes through a conjugate pair:
- forward: the rank's share all_gathered over dp along that dimension;
- backward: the gradient reduce-scattered over dp, summed in f32 and
  cast once (bf16 partials would add error, as at the tp sums); on a
  hybrid mesh the f32 share is then all_reduced over ``"dcn"``, the one
  collective of a weight that crosses slices, and under context
  parallelism (a ``make_mesh(dp, tp, cp)`` mesh) over ``"cp"``, since
  each cp rank's gradient covers its own chunk of the sequence.  The
  share is then the same on every cp rank, as the shard is.

A block gathers its layer's weights at its start, inside the function
that remat wraps (``decoder.block_kv``, ``vit.vit_block``), so the
replay gathers again and one layer's gathered weights live at a time;
the embedding gathers ``wte``, ``lm_logits`` gathers ``lm_head`` (which
the backward keeps), the ViT and the resampler their own leaves.  The
gathered tensor has the rank's tp-local shape, so the tp sites see what
they see without FSDP.  Which leaves are sharded, and along which
dimension, comes from the rules, not from the local shapes (a site's
local width already signals tp).  Without the context nothing gathers
and the one-device path is as it was.

Every gather here is collective over the dp group, forward and
backward: every rank of it reads the same weights in the same order.
"""

from __future__ import annotations

import contextlib

import torch

from tdax_torch.parallel import mesh as pm

_STACKED = ("layers", "blocks")
_CTX: list = []


def mesh_of(shardings: dict):
    """The mesh of a ``named_shardings`` tree (every leaf's)."""
    node = shardings
    while isinstance(node, dict):
        node = next(iter(node.values()))
    return node.mesh


def specs_of(shardings: dict) -> dict:
    """The partition-spec tree of a ``named_shardings`` tree."""
    return {key: specs_of(node) if isinstance(node, dict) else node.spec
            for key, node in shardings.items()}


@contextlib.contextmanager
def gathering(param_shardings: dict):
    """Within it the model gathers each leaf whose spec in
    ``param_shardings`` (``mesh.named_shardings`` of FSDP rules) names
    dp, where a block reads it."""
    _CTX.append((mesh_of(param_shardings), specs_of(param_shardings)))
    try:
        yield
    finally:
        _CTX.pop()


class _GatherDp(torch.autograd.Function):
    """The leaf whole over dp along ``dim``; backward: the gradient's sum
    over dp (and dcn, and cp) in f32, this rank's share, cast once."""

    @staticmethod
    def forward(ctx, w, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return pm.all_gather(w, mesh, "dp", dim=dim)

    @staticmethod
    def backward(ctx, g):
        acc = g.to(torch.float32, memory_format=torch.contiguous_format, copy=True)
        share = pm.reduce_scatter(acc, ctx.mesh, "dp", dim=ctx.dim)
        del acc
        for axis in ("dcn", "cp"):
            if axis in ctx.mesh.shape:
                pm.all_reduce(share, ctx.mesh, axis)
        return share.to(g.dtype), None, None


def leaf(w, path: tuple):
    """``w``, the leaf at ``path`` (a tuple of keys of the params tree; a
    stacked leaf's per-layer slice under ``layers`` / ``blocks``), as the
    model reads it: gathered over dp when the active context's rule for
    it names dp, else as it is."""
    if not _CTX or isinstance(w, dict):
        return w
    mesh, specs = _CTX[-1]
    dim = pm.dp_dim(pm.spec_at(specs, path))
    if dim is None:
        return w
    if any(key in _STACKED for key in path):
        dim -= 1  # the layer axis is indexed away
    if torch.is_grad_enabled() and w.requires_grad:
        return _GatherDp.apply(w, mesh, dim)
    return pm.all_gather(w, mesh, "dp", dim=dim)


def leaves(node: dict, path: tuple) -> dict:
    """The tensor leaves directly under ``node`` (at ``path``) through
    ``leaf``; sub-trees pass as they are.  Without the context, ``node``."""
    if not _CTX:
        return node
    return {key: value if isinstance(value, dict) else leaf(value, path + (key,))
            for key, value in node.items()}
