"""Training step: causal-LM fine-tuning of Qwen-VL on one card (port of
``tdax/parallel/train.py``).

Masked next-token cross-entropy, a global-norm clip and AdamW with the
values of tdax's ``optax.chain(clip_by_global_norm(1.0), adamw(lr, b1=0.9,
b2=0.95, weight_decay=0.01))``, per-block rematerialization, gradient
accumulation with an f32 accumulator, and ``train_loop`` with atomic
checkpoints and bitwise resume.  Every attention gradient goes through
the flash backward kernels (``tdax_torch.ops.flash_attention``).

PyTorch idiom in place of JAX's pure functions: the step updates the
params dict in place (the same tensors, so the tree keeps tdax's stacked
layout) and returns it, with ``torch.optim.AdamW`` doing the update.
What makes the values optax's:
- the clip is optax's, by hand: g / |g| * max when |g| >= max (|g| the
  global norm, summed in f32), not ``clip_grad_norm_`` (which adds 1e-6);
- the learning rate comes from the schedule at the update count before
  it is incremented, so a warmup's first step has lr 0;
- a leaf the loss does not touch (the visual tree in a text-only step)
  gets a zero gradient, so AdamW decays and moves it as optax does;
- the moments keep the params' dtype (bf16 params: bf16 moments).

Trainable leaves are per-layer views of each stacked [L, ...] weight:
autograd's backward of a stacked weight's ``w[i]`` would allocate a
zero tensor of the whole stack for every layer (O(L^2) bytes a step);
a per-layer leaf gets a gradient of its own size.

Under a dp x tp mesh (``mesh.make_mesh``) each rank holds its dp rows of
the batch and its tp shard of the params (``mesh.shard_params``); the
step takes the mesh from the active ``flash_sharding`` context (or from
``sp_mesh``) and runs inside ``flash_sharding(mesh, "dp", "tp")``, where
tdax's GSPMD reads it from the arrays' shardings.  The loss is tdax's
token-weighted global mean (the CE numerator and the token count summed
over dp before the division), the gradients are summed over dp, the
clip's global norm sums the squares of the tp-sharded leaves over tp and
counts every replicated or whole leaf once, and AdamW updates each
rank's shard.  The tp collectives' backward is ``models/qwen_vl/tp.py``'s.

``param_shardings`` (``mesh.named_shardings`` of ``fsdp_sharding_rules``)
turns on FSDP / ZeRO-3: the params are this rank's ``shard_params``
tree under those rules, so its training view, AdamW's moments and the
accumulator are shard-sized; the model gathers each dp-sharded weight
where a block reads it and reduce-scatters its gradient over dp in f32
(``models/qwen_vl/fsdp.py``), so such a leaf skips the dp gradient sum,
and the clip sums its squares over dp (over tp too for a dp x tp
shard), after the other leaves'.  On a hybrid mesh (``make_hybrid_mesh``)
the batch is split over ``("dcn", "dp")``: the loss and the replicated
leaves' gradients are summed over both, a dp-sharded gradient over dp
then over dcn.

``cp_mesh`` (a ``make_mesh(dp, tp, cp)`` mesh) turns on context
parallelism, tdax's dry-run stage 10: inside ``flash_sharding(mesh,
"dp", "tp", seq_axis="cp")`` each rank embeds its dp rows of the whole
sequence, keeps its contiguous T / cp chunk from the first block to the
loss (rotary from the chunk's global positions, attention the ring over
cp, heads over tp inside it), and takes its CE targets from the whole
``input_ids`` and ``attn_mask`` at positions + 1.  Every gradient is then
a partial sum on each cp rank: the loss parts and every gradient (the tp
shards' too) are summed over ("dp", "cp") in f32 before the clip.

Both together (FSDP under context parallelism, ``param_shardings`` over
the ``cp_mesh``): each leaf whose rule names dp is sharded over dp alone,
the same share on every cp rank; the model gathers it over dp where a
block reads it, and its f32 gradient is reduce-scattered over dp, then
the share all_reduced over cp (``models/qwen_vl/fsdp.py``), where tdax's
``constrain`` has GSPMD reduce-scatter the gradient into the dp-sharded
layout.  The whole leaves are summed over ("dp", "cp") as above; the
clip sums the dp shares' squares over dp alone (the ranks of one tp and
cp index), since every cp rank holds the same shares.
"""

from __future__ import annotations

import contextlib
import math
import os
import time

import numpy as np
import torch

from tdax_torch.models.qwen_vl import fsdp
from tdax_torch.models.qwen_vl.config import QwenVLConfig
from tdax_torch.models.qwen_vl.model import forward
from tdax_torch.models.qwen_vl.quantize import is_quantized
from tdax_torch.models.qwen_vl.tp import sum_over
from tdax_torch.ops.flash_attention import current_flash_sharding, flash_sharding
from tdax_torch.ops.ring_attention import local_chunk
from tdax_torch.parallel import mesh as pm
from tdax_torch.runtime import get_device
from tdax_torch.utils.log import span

# dict nodes whose leaves are stacked over the layer axis
_STACKED = ("layers", "blocks")
# tdax's default_optimizer: clip_by_global_norm(1.0), adamw(b1=0.9, b2=0.95,
# eps=1e-8, weight_decay=0.01)
CLIP_NORM, B1, B2, EPS, WEIGHT_DECAY = 1.0, 0.9, 0.95, 1e-8, 0.01


def masked_ce_parts(logits: torch.Tensor, input_ids: torch.Tensor, attn_mask: torch.Tensor,
                    offset: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum of masked next-token CE, number of real target tokens), the
    unreduced form that makes gradient accumulation exact.  Written as
    ``logsumexp(logits) - logits[target]``, as tdax does.  ``offset``:
    the global position of the logits' first row (a rank's chunk under
    context parallelism), whose targets are the whole ``input_ids`` and
    ``attn_mask`` at positions + 1; the sequence's last position has
    none."""
    n = min(logits.shape[1], input_ids.shape[1] - 1 - offset)
    targets = input_ids[:, offset + 1:offset + 1 + n].long()
    logits = logits[:, :n].float()
    mask = (attn_mask[:, offset + 1:offset + 1 + n] > 0).float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, targets[..., None])[..., 0]
    return ((lse - picked) * mask).sum(), mask.sum()


def masked_ce(logits, input_ids, attn_mask) -> torch.Tensor:
    """Masked next-token cross entropy (mean over real target tokens)."""
    ce_sum, n = masked_ce_parts(logits, input_ids, attn_mask)
    return ce_sum / n.clamp_min(1.0)


def _global_parts(ce_sum: torch.Tensor, n: torch.Tensor, mesh, axis):
    """(CE numerator, token count) summed over the batch ranks of ``axis``
    (dp, or ("dcn", "dp")); the numerator's gradient reaches each rank's
    own as it is."""
    return sum_over(ce_sum, mesh, axis), pm.all_reduce(n.clone(), mesh, axis)


def _context_mesh():
    ctx = current_flash_sharding()
    return None if ctx is None else ctx[0]


def _sum_axis(batch_axis, seq_axis):
    """The axes a loss part and a gradient are summed over: the batch
    axis, with the seq axis beside it under context parallelism
    (("dp", "cp"), whose group ``make_mesh(cp=)`` builds)."""
    if seq_axis is None:
        return batch_axis
    return seq_axis if batch_axis is None else (batch_axis, seq_axis)


def _offset(input_ids: torch.Tensor) -> int:
    """The global position of this rank's first logits row: its chunk's
    under context parallelism, else 0."""
    chunk = local_chunk(input_ids.shape[1])
    return 0 if chunk is None else chunk[0]


def lm_loss(params: dict, cfg: QwenVLConfig, input_ids, attn_mask, images=None,
            image_positions=None, remat: bool = False, seq_sharding=None) -> torch.Tensor:
    """Masked next-token cross entropy (mean over real target tokens).
    Inside ``flash_sharding`` over a mesh, the mean over every rank of its
    batch axis (dp, or ("dcn", "dp")), each rank passing its rows, and
    with a seq axis (context parallelism) over its chunks too;
    ``seq_sharding`` (``(mesh, "tp")``) turns on sequence parallelism
    (``forward``)."""
    logits = forward(params, cfg, input_ids, attn_mask, images, image_positions, remat=remat,
                     seq_sharding=seq_sharding)
    ce_sum, n = masked_ce_parts(logits, input_ids, attn_mask, _offset(input_ids))
    ctx = current_flash_sharding()
    axis = None if ctx is None else _sum_axis(ctx[1], ctx[3])
    if axis is not None:
        ce_sum, n = _global_parts(ce_sum, n, ctx[0], axis)
    return ce_sum / n.clamp_min(1.0)


def warmup_cosine_lr(peak_lr: float, warmup_steps: int, total_steps: int,
                     end_frac: float = 0.1):
    """``optax.warmup_cosine_decay_schedule(0, peak_lr, warmup_steps,
    total_steps, peak_lr * end_frac)``, evaluated in float32 as optax
    does: count -> learning rate."""
    if total_steps - warmup_steps <= 0:
        raise ValueError(f"warmup_cosine_lr: total_steps {total_steps} must exceed "
                         f"warmup_steps {warmup_steps}")
    f32 = np.float32
    alpha = 0.0 if peak_lr == 0.0 else peak_lr * end_frac / peak_lr
    decay = total_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warmup_steps:  # linear from 0 to peak_lr
            frac = f32(1) - f32(max(count, 0)) / f32(warmup_steps)
            return float(f32(0.0 - peak_lr) * frac + f32(peak_lr))
        c = f32(min(count - warmup_steps, decay))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * c / f32(decay)))
        return float(f32(peak_lr) * (f32(1 - alpha) * cosine + f32(alpha)))

    return schedule


def _training_view(params: dict):
    """(a tree like ``params`` whose stacked nodes are lists of per-layer
    dicts, the list of its leaves, their (path, layer) names).  Each leaf
    is a detached alias or a per-layer view of a params tensor with
    ``requires_grad``: an in-place update of the leaf is an update of
    the params tree; the caller's tensors keep their flags."""
    leaves, names = [], []

    def leaf(t, path, i):
        t.requires_grad_(True)
        leaves.append(t)
        names.append((path, i))
        return t

    def walk(tree, prefix):
        out = {}
        for name, node in tree.items():
            path = f"{prefix}{name}"
            if is_quantized(node) or (isinstance(node, torch.Tensor)
                                      and not node.is_floating_point()):
                raise ValueError(f"training takes floating-point parameters; {path} is not")
            if isinstance(node, dict) and name in _STACKED:
                n = len(next(iter(node.values())))
                out[name] = [{w: leaf(node[w].detach()[i], f"{path}/{w}", i) for w in node}
                             for i in range(n)]
            elif isinstance(node, dict):
                out[name] = walk(node, path + "/")
            else:
                out[name] = leaf(node.detach(), path, None)
        return out

    return walk(params, ""), leaves, names


def _zeros_like(tree: dict) -> dict:
    return {k: _zeros_like(v) if isinstance(v, dict) else torch.zeros_like(v)
            for k, v in tree.items()}


def _at(tree: dict, path: str):
    for part in path.split("/"):
        tree = tree[part]
    return tree


class OptState:
    """AdamW state for one params tree: the moments ``mu`` and ``nu``
    (trees in the params' layout and dtype, as optax keeps them), the
    update ``count``, and the ``torch.optim.AdamW`` whose per-leaf state
    is views of them.  ``tree`` is the params' training view (what the
    forward reads), ``leaves`` its trainable tensors and ``names`` each
    leaf's (path, layer index or None)."""

    def __init__(self, optimizer: "AdamW", params: dict):
        self.optimizer = optimizer
        self.params = params
        self.tree, self.leaves, self.names = _training_view(params)
        self.mu, self.nu = _zeros_like(params), _zeros_like(params)
        self.count = 0
        self.torch_opt = torch.optim.AdamW(self.leaves, lr=0.0, betas=(B1, B2), eps=EPS,
                                           weight_decay=WEIGHT_DECAY, foreach=False)
        for leaf, (path, i) in zip(self.leaves, self.names):
            mu, nu = _at(self.mu, path), _at(self.nu, path)
            self.torch_opt.state[leaf] = {
                "step": torch.tensor(0.0),
                "exp_avg": mu if i is None else mu[i],
                "exp_avg_sq": nu if i is None else nu[i]}

    @torch.no_grad()
    def update(self, grads: list, tp=None, dp=None, pp=None) -> torch.Tensor:
        """Clip ``grads`` (one per leaf, modified in place) by their global
        norm, then one AdamW step on the params; returns that norm (f32,
        before the clip).  ``tp`` and ``dp``: (mesh, one flag a leaf, True
        where this rank holds a tp, resp. dp, shard of it) or None.  The tp
        shards' squares are summed over tp, the dp shards' over dp (a dp x
        tp shard's over both; on a cp mesh the ranks of one cp index, as
        every cp rank holds the same shares), after the whole leaves',
        which count once.  ``pp``: a mesh whose "pp" ranks hold disjoint
        leaves (a pipeline stage's tree, ``pipeline.shard_params_pp``) or
        None; the total is then summed over pp, last."""
        device = self.leaves[0].device
        zero = torch.zeros((), dtype=torch.float32, device=device)
        total, by_tp, by_dp, by_both = (zero.clone() for _ in range(4))
        tp_flags = [False] * len(grads) if tp is None else tp[1]
        dp_flags = [False] * len(grads) if dp is None else dp[1]
        with span("clip"):
            for g, t, d in zip(grads, tp_flags, dp_flags):
                acc = (by_both if d else by_tp) if t else (by_dp if d else total)
                acc.add_(torch.linalg.vector_norm(g, dtype=torch.float32).square())
            if tp is not None:
                total += pm.all_reduce(by_tp, tp[0], "tp")
            if dp is not None:
                by_dp += pm.all_reduce(by_both, dp[0], "tp")
                total += pm.all_reduce(by_dp, dp[0], "dp")
            if pp is not None:
                total = pm.all_reduce(total, pp, "pp")
            norm = total.sqrt()
            clip = norm >= CLIP_NORM  # optax: keep where |g| < max
            denom = torch.where(clip, norm, 1.0)
            mult = torch.where(clip, CLIP_NORM, 1.0)
            for leaf, g in zip(self.leaves, grads):
                leaf.grad = g.div_(denom).mul_(mult)
        self.torch_opt.param_groups[0]["lr"] = self.optimizer.learning_rate(self.count)
        self.torch_opt.step()
        for leaf in self.leaves:
            leaf.grad = None
        self.count += 1
        return norm

    def stack(self, per_leaf: list) -> dict:
        """One tensor per leaf (e.g. gradients) -> a tree in the params'
        stacked layout."""
        rows: dict = {}
        for t, (path, i) in zip(per_leaf, self.names):
            rows.setdefault(path, []).append(t if i is None else t[None])
        tree: dict = {}
        for path, ts in rows.items():
            node = tree
            *parents, name = path.split("/")
            for part in parents:
                node = node.setdefault(part, {})
            node[name] = torch.cat(ts) if len(ts) > 1 else ts[0]
        return tree

    def to_flat(self, gather=None) -> dict:
        """Flat checkpoint keys: ``mu/<path>``, ``nu/<path>``, ``count``;
        ``gather`` maps each moment tree first (under tp:
        ``mesh.unshard_params``)."""
        from tdax_torch.utils.checkpoint import _flatten

        gather = gather or (lambda tree: tree)
        flat = _flatten(gather(self.mu), "mu/", {})
        _flatten(gather(self.nu), "nu/", flat)
        flat["count"] = np.asarray(self.count, dtype=np.int64)
        return flat

    @torch.no_grad()
    def load_flat(self, flat: dict) -> None:
        """Inverse of ``to_flat``: copies the moments in, sets the count."""
        missing, extra = set(self.to_flat()) - set(flat), set(flat) - set(self.to_flat())
        if missing or extra:
            raise ValueError(f"optimizer state does not match the params: missing "
                             f"{sorted(missing)[:5]}, unknown {sorted(extra)[:5]}")
        for key, t in flat.items():
            if key == "count":
                continue
            which, path = key.split("/", 1)
            dst = _at(self.mu if which == "mu" else self.nu, path)
            if dst.shape != t.shape or dst.dtype != t.dtype:
                raise ValueError(f"optimizer state {key}: {tuple(t.shape)} {t.dtype} does not "
                                 f"match the params' {tuple(dst.shape)} {dst.dtype}")
            dst.copy_(t)
        self.count = int(flat["count"])
        for state in self.torch_opt.state.values():
            state["step"].fill_(float(self.count))


class AdamW:
    """Global-norm clip + AdamW (tdax's ``default_optimizer``).  ``lr`` is
    a float or a schedule (count -> lr, e.g. ``warmup_cosine_lr``)."""

    def __init__(self, lr=1e-4):
        self.lr = lr

    def learning_rate(self, count: int) -> float:
        return float(self.lr(count)) if callable(self.lr) else float(self.lr)

    def init(self, params: dict) -> OptState:
        return OptState(self, params)


def default_optimizer(lr=1e-4) -> AdamW:
    """Global-norm clip at 1.0 + AdamW(b1 0.9, b2 0.95, eps 1e-8, weight
    decay 0.01 on every leaf).  ``lr`` may be a float or a schedule."""
    return AdamW(lr)


def _step_mesh(sp_mesh, cp_mesh, param_shardings=None):
    """The step's mesh: ``sp_mesh`` or ``cp_mesh``, else
    ``param_shardings``' mesh, else the active ``flash_sharding``
    context's, else None (one device); the ones given must be one mesh."""
    if sp_mesh is not None and cp_mesh is not None:
        raise ValueError("sp_mesh and cp_mesh are mutually exclusive: both shard the "
                         "sequence axis (over tp and cp respectively)")
    if cp_mesh is not None and "cp" not in cp_mesh.shape:
        raise ValueError(f"cp_mesh: the mesh's axes {tuple(cp_mesh.shape)} have no 'cp' "
                         "(make_mesh(dp, tp, cp) with cp > 1)")
    given = [(name, m) for name, m in (
        ("sp_mesh", sp_mesh), ("cp_mesh", cp_mesh),
        ("param_shardings", None if param_shardings is None else fsdp.mesh_of(param_shardings)),
        ("the active flash_sharding context", _context_mesh())) if m is not None]
    for name, m in given[1:]:
        if m is not given[0][1]:
            raise ValueError(f"{given[0][0]} and {name} name two meshes")
    return given[0][1] if given else None


def make_train_step(cfg: QwenVLConfig, optimizer: AdamW, with_images: bool = False,
                    remat: bool = False, sp_mesh=None, cp_mesh=None, param_shardings=None,
                    accum_steps: int = 1, device=None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    loss), ``opt_state = optimizer.init(params)``.  The params are updated
    in place; the loss stays on the device.

    ``batch``: dict with input_ids / attn_mask (+ images /
    image_positions when with_images), on the step's device: the card
    unless ``device="cpu"`` (no card and no ``device`` raises).
    ``remat=True`` rematerializes each decoder block in the backward.
    ``accum_steps > 1``: every batch leaf carries a leading
    [accum_steps, ...] microbatch axis; the loss numerator and
    denominator and f32 gradient sums accumulate over the microbatches,
    then ONE update applies the full-batch gradient, cast once to the
    params' dtype.  ``train_step.loss_and_grads`` is the step without its
    update (``opt_state.update(grads, **train_step.shards(opt_state))``
    completes it).

    Called inside ``flash_sharding(mesh, "dp", "tp")`` (the mesh read at
    each call), with ``sp_mesh`` (the mesh the params are sharded over)
    or with ``param_shardings`` (``named_shardings`` over the mesh), the
    step runs over that mesh: the params are this rank's ``shard_params``
    tree (under ``param_shardings``' rules when given) and the batch this
    rank's rows of the mesh's ``batch_axis`` (``mesh.split_batch``; see
    the module's docstring).  ``sp_mesh`` also turns on sequence
    parallelism: the residual stream between blocks sharded over tp on
    the sequence axis.  ``param_shardings`` turns on FSDP and composes
    with ``remat``, ``accum_steps``, ``sp_mesh`` and ``cp_mesh``.  ``cp_mesh`` (a
    ``make_mesh(dp, tp, cp)`` mesh with cp > 1) turns on context
    parallelism instead: the step runs inside ``flash_sharding(mesh,
    "dp", "tp", seq_axis="cp")``, each rank passing its dp rows of the
    whole sequence; the model keeps the rank's T / cp chunk from the
    first block to the loss, attention is the ring over cp (heads over
    tp inside it), and the loss parts and every gradient are summed over
    ("dp", "cp").  It composes with ``remat``, ``accum_steps`` and
    ``param_shardings`` over the same mesh (FSDP under context
    parallelism: a dp-sharded leaf's gradient reduce-scattered over dp,
    then its share summed over cp); with ``sp_mesh`` it raises
    ValueError, as tdax's, and so does a mesh with no "cp" axis or a
    ``param_shardings`` over another mesh."""
    device = get_device(device)
    _step_mesh(sp_mesh, cp_mesh, param_shardings)
    seq = None if sp_mesh is None else (sp_mesh, "tp")
    seq_axis = None if cp_mesh is None else "cp"
    specs = None if param_shardings is None else fsdp.specs_of(param_shardings)

    def loss_parts(tree, b):
        logits = forward(tree, cfg, b["input_ids"], b["attn_mask"],
                         b.get("images") if with_images else None,
                         b.get("image_positions") if with_images else None, remat=remat,
                         seq_sharding=seq)
        return masked_ce_parts(logits, b["input_ids"], b["attn_mask"], _offset(b["input_ids"]))

    def grads_of(out, leaves):
        with span("backward"):
            grads = torch.autograd.grad(out, leaves, allow_unused=True)
        return [torch.zeros_like(p) if g is None else g for g, p in zip(grads, leaves)]

    def gathered(names) -> list:
        """Per leaf: whether the model gathers it over dp (its FSDP rule
        names dp), so that its gradient comes reduce-scattered, summed."""
        if specs is None:
            return [False] * len(names)
        return [pm.dp_dim(pm.spec_at(specs, tuple(path.split("/")))) is not None
                for path, _ in names]

    def dp_sum(grads, mesh, axis, skip):
        """Each gradient not in ``skip`` summed over ``axis`` (the batch
        axis, and cp) in f32, in place."""
        for g, done in zip(grads, skip):
            if not done:
                g.copy_(pm.all_reduce(g.float() if g.dtype != torch.float32 else g, mesh,
                                      axis))

    def run(params, opt_state: OptState, batch: dict, mesh):
        leaves = opt_state.leaves
        axis = None if mesh is None else _sum_axis(mesh.batch_axis, seq_axis)
        if accum_steps == 1:
            ce_sum, n = loss_parts(opt_state.tree, batch)
            if mesh is not None:
                ce_sum, n = _global_parts(ce_sum, n, mesh, axis)
            loss = ce_sum / n.clamp_min(1.0)
            grads = grads_of(loss, leaves)
            if mesh is not None:
                dp_sum(grads, mesh, axis, gathered(opt_state.names))
        else:
            for name, leaf in batch.items():
                if leaf.shape[0] != accum_steps:
                    raise ValueError(f"batch leaf {name!r} has leading dim {leaf.shape[0]}, "
                                     f"expected accum_steps={accum_steps}")
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=device) for p in leaves]
            ce_tot = torch.zeros((), dtype=torch.float32, device=device)
            n_tot = torch.zeros((), dtype=torch.float32, device=device)
            for m in range(accum_steps):
                ce_sum, n = loss_parts(opt_state.tree, {k: v[m] for k, v in batch.items()})
                for a, g in zip(acc, grads_of(ce_sum, leaves)):
                    a += g.float()
                ce_tot += ce_sum.detach()
                n_tot += n
            if mesh is not None:
                ce_tot, n_tot = (pm.all_reduce(t, mesh, axis) for t in (ce_tot, n_tot))
                dp_sum(acc, mesh, axis, gathered(opt_state.names))
            n_tot = n_tot.clamp_min(1.0)
            loss = ce_tot / n_tot
            grads = [(a / n_tot).to(p.dtype) for a, p in zip(acc, leaves)]
            del acc
        return loss.detach(), grads

    def loss_and_grads(params, opt_state: OptState, batch: dict):
        """(loss, one gradient per ``opt_state.leaves``): the step before
        its update."""
        if opt_state.params is not params:
            raise ValueError("opt_state was made by optimizer.init() of another params tree")
        if opt_state.leaves[0].device.type != device.type:
            raise ValueError(f"train step: params on {opt_state.leaves[0].device}, step on "
                             f"{device}")
        mesh = _step_mesh(sp_mesh, cp_mesh, param_shardings)
        if mesh is None:
            return run(params, opt_state, batch, None)
        gathers = (contextlib.nullcontext() if param_shardings is None
                   else fsdp.gathering(param_shardings))
        with flash_sharding(mesh, mesh.batch_axis, "tp", seq_axis), gathers:
            return run(params, opt_state, batch, mesh)

    def shards(opt_state: OptState) -> dict:
        """``OptState.update``'s ``tp`` and ``dp``: (mesh, which leaves are
        tp shards) and (mesh, which are dp shards), each None where there
        are none (one device; no FSDP, or dp = 1)."""
        mesh = _step_mesh(sp_mesh, cp_mesh, param_shardings)
        if mesh is None:
            return {}
        paths = [tuple(path.split("/")) for path, _ in opt_state.names]
        out = {"tp": (mesh, [pm.tp_split(path, mesh, cfg) for path in paths])}
        if specs is not None:
            flags = [pm.dp_split(path, mesh, specs) for path in paths]
            if any(flags):
                out["dp"] = (mesh, flags)
        return out

    def step(params, opt_state: OptState, batch: dict):
        with span("train_step"):
            loss, grads = loss_and_grads(params, opt_state, batch)
            opt_state.update(grads, **shards(opt_state))
        return params, opt_state, loss

    step.loss_and_grads = loss_and_grads
    step.shards = shards
    return step


def _save_state(path: str, params: dict, opt_state: OptState, step: int, mesh, cfg,
                rules) -> None:
    """The train state to ``path + ".npz"``; under a mesh the shards
    gathered whole under ``rules`` (every rank) and written by rank 0
    alone, the others waiting at a barrier for the file."""
    from tdax_torch.utils.checkpoint import save_train_state
    if mesh is None:
        save_train_state(path, params, opt_state, step)
        return

    def gather(tree):
        return pm.unshard_params(tree, mesh, cfg, rules)

    whole, flat = gather(params), opt_state.to_flat(gather)
    if pm.is_writer():
        save_train_state(path, whole, flat, step)
    pm.barrier()


def train_loop(params: dict, cfg: QwenVLConfig, batches, n_steps: int,
               optimizer: AdamW | None = None, checkpoint_path: str | None = None,
               checkpoint_every: int = 100, resume: bool = True, with_images: bool = False,
               remat: bool = False, sp_mesh=None, cp_mesh=None, param_shardings=None,
               accum_steps: int = 1, log_every: int = 50, verbose: bool = False, device=None):
    """Minimal fit loop with crash resume (tdax's ``train_loop``).

    ``batches`` is a callable ``step -> batch dict``, so a resumed run
    replays the same data.  Every ``checkpoint_every`` steps the train
    state is written atomically to ``checkpoint_path + ".npz"``; with
    ``resume=True`` an existing checkpoint restarts the loop from its
    step (its params replace ``params``).  Losses stay on the device
    until the loop ends; every ``log_every`` steps a ``train_window``
    event goes to the JSONL log.  Returns (params, opt_state, losses) for
    the steps this call ran.  Runs on the card unless ``device="cpu"``.

    Over a mesh (``sp_mesh``, ``cp_mesh``, ``param_shardings``' or the
    active ``flash_sharding`` context's, as ``make_train_step``) ``params`` is
    this rank's shard and ``batches`` gives this rank's rows (under
    ``cp_mesh`` its dp rows of the whole sequence); the checkpoint holds
    the whole tree (``mesh.unshard_params``, under ``param_shardings``'
    rules when given, also with ``cp_mesh``), written by rank 0 with a
    barrier after it, and a resume shards it again (``mesh.shard_params``)
    and continues bitwise.  Rank 0 alone prints and logs."""
    from tdax_torch.utils.checkpoint import load_train_state
    from tdax_torch.utils.log import log_event

    device = get_device(device)
    mesh = _step_mesh(sp_mesh, cp_mesh, param_shardings)
    rules = None if param_shardings is None else fsdp.specs_of(param_shardings)
    opt = optimizer if optimizer is not None else default_optimizer()
    start = 0
    if checkpoint_path and resume and os.path.exists(checkpoint_path + ".npz"):
        shard = None if mesh is None else (lambda tree: pm.shard_params(tree, mesh, rules,
                                                                        cfg=cfg))
        params, opt_state, start = load_train_state(checkpoint_path, opt, device, shard=shard)
        if verbose and pm.is_writer():
            print(f"[tdax_torch.train] resumed from step {start}", flush=True)
    else:
        opt_state = opt.init(params)
    step_fn = make_train_step(cfg, opt, with_images=with_images, remat=remat, sp_mesh=sp_mesh,
                              cp_mesh=cp_mesh, param_shardings=param_shardings,
                              accum_steps=accum_steps, device=device)
    device_losses = []
    t_window, tokens_window = time.time(), 0
    for i in range(start, n_steps):
        batch = batches(i)
        params, opt_state, loss = step_fn(params, opt_state, batch)
        device_losses.append(loss)
        tokens_window += batch["input_ids"].numel()
        if verbose and pm.is_writer():
            print(f"[tdax_torch.train] step {i + 1}/{n_steps} loss {float(loss):.4f}",
                  flush=True)
        if log_every and (i + 1) % log_every == 0 and pm.is_writer():
            dt = time.time() - t_window
            # dispatched tokens (padding included), one sync per window
            log_event("train_window", step=i + 1, loss=float(loss), wall_s=round(dt, 4),
                      dispatched_tokens_per_s=round(tokens_window / max(dt, 1e-9), 1))
            t_window, tokens_window = time.time(), 0
        if checkpoint_path and (i + 1) % checkpoint_every == 0:
            _save_state(checkpoint_path, params, opt_state, i + 1, mesh, cfg, rules)
    return params, opt_state, [float(x) for x in device_losses]
