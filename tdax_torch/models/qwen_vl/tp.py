"""The model's tensor-parallel collectives.

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
"""

from __future__ import annotations

import torch

from tdax_torch.models.qwen_vl.quantize import is_quantized
from tdax_torch.ops.flash_attention import current_flash_sharding
from tdax_torch.parallel.mesh import all_gather, all_reduce, broadcast


def _tp(where: str, x: torch.Tensor):
    """The tp group's (mesh, axis); raises where there is none, or where
    autograd would need the collective's backward (not ported)."""
    if x.requires_grad:
        raise NotImplementedError(f"{where}: tensor-parallel training (the collectives' "
                                  "backward) is not ported")
    ctx = current_flash_sharding()
    if ctx is None or ctx[2] is None:
        raise RuntimeError(f"{where}: the weights are tp-sharded; run the model inside "
                           "flash_sharding(mesh, batch_axis='dp', head_axis='tp')")
    return ctx[0], ctx[2]


def tp_row_product(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` at a row-parallel site under tp (``attn_proj_w``,
    ``mlp_proj_w``, the resampler's ``attn_out_w``; with whole weights
    the site calls ``qdot``).  The rank's partial product over its input
    rows is kept in f32 (bf16 inputs multiply exactly, the sum is f32),
    summed over the tp group in f32 and cast once to x's dtype, as
    tdax's GSPMD sums its f32 partials before the cast."""
    if is_quantized(w):
        raise NotImplementedError("tp_row_product: int8 weights under tp are not ported")
    partial = torch.matmul(x.float(), w.float())
    mesh, axis = _tp("tp_row_product", partial)
    return all_reduce(partial, mesh, axis).to(x.dtype)


def tp_gather(x: torch.Tensor, sharded: bool) -> torch.Tensor:
    """The vocab-parallel logits' shards of the tp group along the last
    dimension, so every rank holds the whole ``[..., vocab]``."""
    if not sharded:
        return x
    mesh, axis = _tp("tp_gather", x)
    return all_gather(x, mesh, axis, dim=-1)


def tp_broadcast(tok: torch.Tensor) -> torch.Tensor:
    """The tp group's first rank's ``tok`` on every rank of the group
    (a sampled token: each rank's draw would differ); unchanged with no
    tp axis."""
    ctx = current_flash_sharding()
    if ctx is None or ctx[2] is None or ctx[0].shape[ctx[2]] == 1:
        return tok
    return broadcast(tok.contiguous(), ctx[0], ctx[2])
