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
"""

from __future__ import annotations

import math
import os
import time

import numpy as np
import torch

from tdax_torch.models.qwen_vl.config import QwenVLConfig
from tdax_torch.models.qwen_vl.model import forward
from tdax_torch.models.qwen_vl.quantize import is_quantized
from tdax_torch.runtime import get_device

# dict nodes whose leaves are stacked over the layer axis
_STACKED = ("layers", "blocks")
# tdax's default_optimizer: clip_by_global_norm(1.0), adamw(b1=0.9, b2=0.95,
# eps=1e-8, weight_decay=0.01)
CLIP_NORM, B1, B2, EPS, WEIGHT_DECAY = 1.0, 0.9, 0.95, 1e-8, 0.01


def masked_ce_parts(logits: torch.Tensor, input_ids: torch.Tensor,
                    attn_mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum of masked next-token CE, number of real target tokens), the
    unreduced form that makes gradient accumulation exact.  Written as
    ``logsumexp(logits) - logits[target]``, as tdax does."""
    targets = input_ids[:, 1:].long()
    logits = logits[:, :-1].float()
    mask = (attn_mask[:, 1:] > 0).float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, targets[..., None])[..., 0]
    return ((lse - picked) * mask).sum(), mask.sum()


def masked_ce(logits, input_ids, attn_mask) -> torch.Tensor:
    """Masked next-token cross entropy (mean over real target tokens)."""
    ce_sum, n = masked_ce_parts(logits, input_ids, attn_mask)
    return ce_sum / n.clamp_min(1.0)


def lm_loss(params: dict, cfg: QwenVLConfig, input_ids, attn_mask, images=None,
            image_positions=None, remat: bool = False) -> torch.Tensor:
    """Masked next-token cross entropy (mean over real target tokens)."""
    logits = forward(params, cfg, input_ids, attn_mask, images, image_positions, remat=remat)
    return masked_ce(logits, input_ids, attn_mask)


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
    def update(self, grads: list) -> None:
        """Clip ``grads`` (one per leaf, modified in place) by their global
        norm, then one AdamW step on the params."""
        device = self.leaves[0].device
        total = torch.zeros((), dtype=torch.float32, device=device)
        for g in grads:
            total += torch.linalg.vector_norm(g, dtype=torch.float32).square()
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

    def to_flat(self) -> dict:
        """Flat checkpoint keys: ``mu/<path>``, ``nu/<path>``, ``count``."""
        from tdax_torch.utils.checkpoint import _flatten

        flat = _flatten(self.mu, "mu/", {})
        _flatten(self.nu, "nu/", flat)
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


def make_train_step(cfg: QwenVLConfig, optimizer: AdamW, with_images: bool = False,
                    remat: bool = False, accum_steps: int = 1, device=None):
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
    update (``opt_state.update(grads)`` completes it)."""
    device = get_device(device)

    def loss_parts(tree, b):
        logits = forward(tree, cfg, b["input_ids"], b["attn_mask"],
                         b.get("images") if with_images else None,
                         b.get("image_positions") if with_images else None, remat=remat)
        return masked_ce_parts(logits, b["input_ids"], b["attn_mask"])

    def grads_of(out, leaves):
        grads = torch.autograd.grad(out, leaves, allow_unused=True)
        return [torch.zeros_like(p) if g is None else g for g, p in zip(grads, leaves)]

    def loss_and_grads(params, opt_state: OptState, batch: dict):
        """(loss, one gradient per ``opt_state.leaves``): the step before
        its update."""
        if opt_state.params is not params:
            raise ValueError("opt_state was made by optimizer.init() of another params tree")
        leaves = opt_state.leaves
        if leaves[0].device.type != device.type:
            raise ValueError(f"train step: params on {leaves[0].device}, step on {device}")
        if accum_steps == 1:
            ce_sum, n = loss_parts(opt_state.tree, batch)
            loss = ce_sum / n.clamp_min(1.0)
            grads = grads_of(loss, leaves)
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
            n_tot = n_tot.clamp_min(1.0)
            loss = ce_tot / n_tot
            grads = [(a / n_tot).to(p.dtype) for a, p in zip(acc, leaves)]
            del acc
        return loss.detach(), grads

    def step(params, opt_state: OptState, batch: dict):
        loss, grads = loss_and_grads(params, opt_state, batch)
        opt_state.update(grads)
        return params, opt_state, loss

    step.loss_and_grads = loss_and_grads
    return step


def train_loop(params: dict, cfg: QwenVLConfig, batches, n_steps: int,
               optimizer: AdamW | None = None, checkpoint_path: str | None = None,
               checkpoint_every: int = 100, resume: bool = True, with_images: bool = False,
               remat: bool = False, accum_steps: int = 1, log_every: int = 50,
               verbose: bool = False, device=None):
    """Minimal fit loop with crash resume (tdax's ``train_loop``).

    ``batches`` is a callable ``step -> batch dict``, so a resumed run
    replays the same data.  Every ``checkpoint_every`` steps the train
    state is written atomically to ``checkpoint_path + ".npz"``; with
    ``resume=True`` an existing checkpoint restarts the loop from its
    step (its params replace ``params``).  Losses stay on the device
    until the loop ends; every ``log_every`` steps a ``train_window``
    event goes to the JSONL log.  Returns (params, opt_state, losses) for
    the steps this call ran.  Runs on the card unless ``device="cpu"``."""
    from tdax_torch.utils.checkpoint import load_train_state, save_train_state
    from tdax_torch.utils.log import log_event

    device = get_device(device)
    opt = optimizer if optimizer is not None else default_optimizer()
    start = 0
    if checkpoint_path and resume and os.path.exists(checkpoint_path + ".npz"):
        params, opt_state, start = load_train_state(checkpoint_path, opt, device)
        if verbose:
            print(f"[tdax_torch.train] resumed from step {start}", flush=True)
    else:
        opt_state = opt.init(params)
    step_fn = make_train_step(cfg, opt, with_images=with_images, remat=remat,
                              accum_steps=accum_steps, device=device)
    device_losses = []
    t_window, tokens_window = time.time(), 0
    for i in range(start, n_steps):
        batch = batches(i)
        params, opt_state, loss = step_fn(params, opt_state, batch)
        device_losses.append(loss)
        tokens_window += batch["input_ids"].numel()
        if verbose:
            print(f"[tdax_torch.train] step {i + 1}/{n_steps} loss {float(loss):.4f}",
                  flush=True)
        if log_every and (i + 1) % log_every == 0:
            dt = time.time() - t_window
            # dispatched tokens (padding included), one sync per window
            log_event("train_window", step=i + 1, loss=float(loss), wall_s=round(dt, 4),
                      dispatched_tokens_per_s=round(tokens_window / max(dt, 1e-9), 1))
            t_window, tokens_window = time.time(), 0
        if checkpoint_path and (i + 1) % checkpoint_every == 0:
            save_train_state(checkpoint_path, params, opt_state, i + 1)
    return params, opt_state, [float(x) for x in device_losses]
