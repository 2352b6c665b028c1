"""Pipeline parallelism for the decoder over a ``pp`` mesh axis (port of
``tdax/parallel/pipeline.py``).

The decoder's stacked [L, ...] layer weights are split over ``pp``
(each stage holds L / pp consecutive blocks) and microbatches stream
through the stages, one [mb, T, H] activation sent forward and one
gradient sent back a microbatch and stage boundary.  Two schedules, as
tdax's:

* **1F1B** (``make_train_step_pp``'s default, ``pipeline_1f1b_grads``):
  the non-interleaved one-forward-one-backward schedule
  (PipeDream-Flush).  Each stage warms up with min(S - 1 - s, M)
  forwards, then alternates, so it saves at most min(S - s, M)
  microbatch inputs.  The backward of a microbatch recomputes the
  stage from its saved input with grad enabled (``remat`` also
  checkpoints each block inside that recompute) and runs autograd on
  the gradient the next stage sent, on the last stage on that
  microbatch's CE sum.  ``_schedule_1f1b`` is tdax's greedy simulation,
  its tables bit for bit.
* **GPipe** (``pipeline_forward``, ``schedule="gpipe"``): step k has
  stage s on microbatch k - s, M + S - 1 steps.  The forward needs no
  autograd; the GPipe training step runs the 1F1B engine on a
  fill-drain table (every forward, then every backward).

tdax writes the pipeline as one ``shard_map`` program, where GSPMD
replicates the embedding and the head, psums the gradients over pp and
dp and runs both ppermutes in every slot.  The port runs one process a
rank with local tensors and explicit collectives, and departs from
that by design where the values do not change:

* placement: ``shard_params_pp`` keeps ``wte`` (and ``visual``) on the
  first stage, which alone reads them, and ``ln_f`` and ``lm_head`` on
  the last, which alone reads them; tdax replicates them on every stage
  (at the full widths the head and the embedding are 1.24B parameters,
  four copies of which do not fit one card beside the layers).
  ``unshard_params_pp`` gathers tdax's whole tree;
* a slot posts only the sends its schedule has a payload for
  (``mesh.send_recv``: the tables tell every rank what its neighbours
  send), activations and gradients tagged apart; tdax sends zeros
  where there is none.  The number of transfers depends on the tables
  alone, never on what a rank computed;
* bubble slots compute nothing, and the last stage's forward slot only
  saves its input (its output goes to no stage; the backward slot runs
  the stage with grad), where tdax computes and discards;
* ``pipeline_1f1b_grads`` returns the head's gradient on the last stage
  and dx on the first (None elsewhere), where tdax psums them over pp.

Every function here that takes a mesh is collective over it: every rank
calls it, in the same order, with its dp rows of the batch.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed as dist

from tdax_torch.models.qwen_vl.config import QwenVLConfig
from tdax_torch.models.qwen_vl.decoder import blocks, depth, rms_norm, rotary_cos_sin
from tdax_torch.models.qwen_vl.model import embed_inputs, lm_logits, torch_dtype
from tdax_torch.ops.flash_attention import AttnSpec
from tdax_torch.parallel import mesh as pm
from tdax_torch.parallel import train as tr

# the leaves the first stage holds beside its layers; every other leaf but
# the layers (ln_f, lm_head) lives on the last stage
_FIRST = ("wte", "visual")
_LAST = ("ln_f", "lm_head")
# tdax's order of the tree's top-level leaves
_ORDER = ("wte", "layers", "ln_f", "lm_head", "visual")
# the tags of a slot's transfers: activations forward, gradients back
_H, _G = 0, 1


def make_pp_mesh(pp: int, dp: int | None = None) -> pm.Mesh:
    """(dp, pp) mesh over the process group's ranks, pp innermost so a
    stage's neighbours are consecutive ranks: rank d * pp + s is stage s
    of dp replica d.  The batch is split over dp."""
    if not pm.joined():
        raise RuntimeError("make_pp_mesh: no process group; call init_distributed first")
    n = dist.get_world_size()
    if dp is None:
        dp = n // pp
    if dp * pp != n:
        raise ValueError(f"dp*pp = {dp}*{pp} != {n} devices")
    return pm.Mesh(pm._device_mesh((dp, pp), ("dp", "pp")))


def _stage(mesh) -> tuple[int, int]:
    """(pp, this rank's stage)."""
    return mesh.shape["pp"], mesh.local_rank("pp")


def _home(key: str, pp: int) -> int:
    """The stage that holds the top-level leaf ``key`` (not ``layers``)."""
    return 0 if key in _FIRST else pp - 1


def _check_layers(num_layers: int, pp: int) -> None:
    if num_layers % pp:
        raise ValueError(f"num_layers={num_layers} not divisible by pp={pp}")


def _micro(b_loc: int, n_micro: int) -> int:
    """The rows of a microbatch of this rank's ``b_loc`` rows."""
    if b_loc % n_micro:
        raise ValueError(f"per-dp batch {b_loc} not divisible by n_micro={n_micro}")
    return b_loc // n_micro


def _map(node, fn):
    return {k: _map(v, fn) for k, v in node.items()} if isinstance(node, dict) else fn(node)


def shard_params_pp(params: dict, mesh) -> dict:
    """This rank's stage of ``params``: every stacked layer leaf's
    [L / pp, ...] slice for its stage (copied, so the whole tree can be
    freed), ``wte`` (and ``visual``) on the first stage, ``ln_f`` and
    ``lm_head`` on the last (the same tensors).  ValueError where pp does
    not divide the layers."""
    pp, s = _stage(mesh)
    n = depth(params["layers"])
    _check_layers(n, pp)
    lo, hi = s * n // pp, (s + 1) * n // pp
    return {key: _map(node, lambda t: t[lo:hi].clone(memory_format=torch.contiguous_format))
            if key == "layers" else node
            for key, node in params.items() if key == "layers" or _home(key, pp) == s}


def _flat(tree: dict, prefix: tuple = ()) -> list:
    out = []
    for key, node in tree.items():
        out += _flat(node, prefix + (key,)) if isinstance(node, dict) else [(prefix + (key,), node)]
    return out


def unshard_params_pp(tree: dict, mesh) -> dict:
    """``shard_params_pp``'s inverse on every rank (collective over pp):
    the layers gathered over pp, every other leaf broadcast from the stage
    that holds it, in tdax's order of the tree.  Any tree in a stage's
    layout (AdamW's moments too)."""
    pp, s = _stage(mesh)
    whole = {"layers": _map(tree["layers"], lambda t: pm.all_gather(t, mesh, "pp"))}
    device = _flat(tree["layers"])[0][1].device
    for stage in dict.fromkeys((0, pp - 1)):
        held = {k: v for k, v in tree.items() if k != "layers" and _home(k, pp) == stage}
        if pp == 1:
            whole.update(held)
            continue
        leaves = _flat(held) if s == stage else []
        meta = pm.broadcast_object([(path, t.shape, t.dtype) for path, t in leaves],
                                   mesh, "pp", stage)
        for i, (path, shape, dtype) in enumerate(meta):
            t = leaves[i][1] if s == stage else torch.empty(shape, dtype=dtype, device=device)
            node = whole
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = pm.broadcast(t, mesh, "pp", stage)
    return {k: whole[k] for k in (*_ORDER, *whole) if k in whole}


def _rotary(cfg: QwenVLConfig, mb: int, t: int, device):
    positions = torch.arange(t, device=device)[None, :].expand(mb, t)
    return rotary_cos_sin(positions, cfg.head_dim, cfg.rope_base)


def _head_logits(h: torch.Tensor, head: dict, cfg: QwenVLConfig) -> torch.Tensor:
    """``ln_f`` and the LM head, as ``model.forward`` ends: f32 logits."""
    return lm_logits(rms_norm(h, head["ln_f"], cfg.layer_norm_eps), head, cfg)


@torch.no_grad()
def pipeline_forward(params: dict, cfg: QwenVLConfig, input_ids: torch.Tensor,
                     attn_mask: torch.Tensor | None, mesh, n_micro: int,
                     images: torch.Tensor | None = None,
                     image_positions: torch.Tensor | None = None,
                     remat: bool = False) -> torch.Tensor:
    """Logits [B_local, T, vocab] f32 through the GPipe schedule: the
    pipeline-parallel counterpart of ``model.forward`` (the same
    per-layer arithmetic).  ``params`` is this rank's stage
    (``shard_params_pp``), ``input_ids`` / ``attn_mask`` (and
    ``images`` / ``image_positions``) its dp rows.  The first stage
    embeds (with images when given), each stage runs its blocks on the
    (step, microbatch) pairs in range and nothing in bubble slots, the
    last applies ``ln_f`` and ``lm_head``; its logits are broadcast over
    pp, so every rank returns them, as tdax's psum does.  No autograd
    (the GPipe training step is ``make_train_step_pp(schedule="gpipe")``);
    ``remat`` is taken for tdax's signature and saves nothing here."""
    pp, s = _stage(mesh)
    _check_layers(cfg.num_layers, pp)
    b, t = input_ids.shape
    mb = _micro(b, n_micro)
    if attn_mask is None:
        attn_mask = torch.ones_like(input_ids)
    masks = attn_mask.reshape(n_micro, mb, t)
    cos, sin = _rotary(cfg, mb, t, input_ids.device)
    xs = (embed_inputs(params, cfg, input_ids, images, image_positions).reshape(n_micro, mb, t, -1)
          if s == 0 else None)
    like = torch.empty((mb, t, cfg.hidden_size), dtype=torch_dtype(cfg.dtype),
                       device=input_ids.device)
    recv, outs = {}, []
    for k in range(n_micro + pp - 1):
        m = k - s
        sends, recvs = [], []
        if 0 <= m < n_micro:
            h = blocks(params["layers"], xs[m] if s == 0 else recv.pop(m), cfg, cos, sin,
                       AttnSpec(kv_valid=masks[m], causal=True))
            if s == pp - 1:
                outs.append(_head_logits(h, params, cfg))
            else:
                sends.append((s + 1, h, _H))
        if s > 0 and 0 <= m + 1 < n_micro:
            recvs.append((s - 1, like, _H))
        if sends or recvs:
            got = pm.send_recv(sends, mesh, "pp", recvs)
            if recvs:
                recv[m + 1] = got[0]
    if s == pp - 1:
        logits = torch.cat(outs)
    else:
        logits = torch.empty((b, t, cfg.vocab_size), dtype=torch.float32,
                             device=input_ids.device)
    return pm.broadcast(logits, mesh, "pp", pp - 1) if pp > 1 else logits


# --- the schedules ----------------------------------------------------------------


def _tables(f: list, b: list, S: int, M: int, n_slots: int, b_in: int) -> dict:
    """tdax's tables of a schedule whose forward of microbatch m on stage
    s runs at slot f[s][m] and its backward at b[s][m] (see
    ``_schedule_1f1b``)."""
    def occupancy(intervals):
        peak = 0
        for u in range(n_slots):
            peak = max(peak, sum(1 for lo, hi in intervals if lo <= u <= hi))
        return peak

    oh = max((occupancy([(f[s][m], f[s + 1][m] - 1) for m in range(M)])
              for s in range(S - 1)), default=1)
    og = max((occupancy([(b[s][m], b[s - 1][m] - 1) for m in range(M)])
              for s in range(1, S)), default=1)

    def tables(times, send_to):
        do = np.zeros((n_slots, S), dtype=bool)
        mb = np.zeros((n_slots, S), dtype=np.int32)
        for s in range(S):
            for m in range(M):
                do[times[s][m], s] = True
                mb[times[s][m], s] = m
        sdo = np.zeros((n_slots, S), dtype=bool)
        smb = np.zeros((n_slots, S), dtype=np.int32)
        for s in range(S):
            dst = s + send_to
            if not (0 <= dst < S):
                continue
            for m in range(M):
                slot = times[dst][m] - 1
                assert slot >= times[s][m], "payload sent before computed"
                assert not sdo[slot, s], "two sends in one slot"
                sdo[slot, s] = True
                smb[slot, s] = m
        return do, mb, sdo, smb

    fw_do, fw_mb, sh_do, sh_mb = tables(f, +1)
    bw_do, bw_mb, sg_do, sg_mb = tables(b, -1)
    return dict(n_slots=n_slots, b_in=b_in, oh=oh, og=og,
                fw_do=fw_do, fw_mb=fw_mb, bw_do=bw_do, bw_mb=bw_mb,
                sh_do=sh_do, sh_mb=sh_mb, sg_do=sg_do, sg_mb=sg_mb)


@functools.lru_cache(maxsize=None)
def _schedule_1f1b(S: int, M: int) -> dict:
    """Static 1F1B schedule tables for S stages x M microbatches, tdax's.

    Greedy simulation of the non-interleaved 1F1B policy: a stage runs a
    backward whenever one is ready and its in-flight count has reached
    its cap min(S - s, M), else a forward.  One op per stage per slot;
    2(M + S - 1) slots when M >= S.  Numpy tables indexed [slot, stage]:
      fw_do/fw_mb   a forward of microbatch fw_mb this slot
      bw_do/bw_mb   a backward of microbatch bw_mb this slot
      sh_do/sh_mb   send h_out of microbatch sh_mb to stage + 1 at the
                    END of this slot (consumed next slot)
      sg_do/sg_mb   send g_out of microbatch sg_mb to stage - 1
    and n_slots, b_in = min(S, M) saved inputs, oh / og the peak unsent
    h_out / g_out (tdax's ring sizes; the port keeps them in dicts).
    Cached: callers share the tables and must not write them."""
    f = [[None] * M for _ in range(S)]
    b = [[None] * M for _ in range(S)]
    fwd_done, bwd_done = [0] * S, [0] * S
    t = 0
    while any(d < M for d in bwd_done):
        assert t < 4 * (M + S), "1F1B simulation failed to converge"
        for s in range(S):
            mf, mb_ = fwd_done[s], bwd_done[s]
            can_f = mf < M and (s == 0 or (f[s - 1][mf] is not None
                                           and f[s - 1][mf] < t))
            if s == S - 1:
                can_b = mb_ < M and f[s][mb_] is not None and f[s][mb_] < t
            else:
                can_b = (mb_ < M and b[s + 1][mb_] is not None
                         and b[s + 1][mb_] < t)
            limit = min(S - s, M)
            inflight = mf - mb_
            if can_b and (inflight >= limit or mf == M):
                b[s][mb_] = t
                bwd_done[s] += 1
            elif can_f and inflight < limit:
                f[s][mf] = t
                fwd_done[s] += 1
            elif can_b:
                b[s][mb_] = t
                bwd_done[s] += 1
        t += 1

    # schedule invariants: the in-flight cap IS the memory claim
    for s in range(S):
        live = 0
        events = ([(f[s][m], 1) for m in range(M)]
                  + [(b[s][m], -1) for m in range(M)])
        peak = 0
        for _, d in sorted(events):
            live += d
            peak = max(peak, live)
        assert peak <= min(S - s, M), (s, peak)
    return _tables(f, b, S, M, t, min(S, M))


@functools.lru_cache(maxsize=None)
def _schedule_gpipe(S: int, M: int) -> dict:
    """GPipe's fill-drain schedule in ``_schedule_1f1b``'s tables: stage s
    runs the forward of microbatch m at slot s + m, then, once the last
    stage's forwards are done, the backwards in microbatch order, the
    last stage first; every stage saves its M inputs."""
    f = [[s + m for m in range(M)] for s in range(S)]
    b = [[M + S - 1 + (S - 1 - s) + m for m in range(M)] for s in range(S)]
    return _tables(f, b, S, M, 2 * (M + S - 1), M)


# --- the engine -------------------------------------------------------------------


def _run(sched: dict, layers: list, head: dict | None, x, input_ids, attn_mask,
         cfg: QwenVLConfig, mesh, n_micro: int, remat: bool):
    """``sched``'s slots on this rank's stage.  ``layers``: the stage's
    per-layer trees of leaves that require grad; ``head``: ``ln_f`` and
    ``lm_head`` likewise on the last stage; ``x`` [B_local, T, H] the
    embedded rows, read on the first stage.  A forward slot runs the
    stage without grad and keeps its input (the last stage only keeps
    the input); a backward slot recomputes the stage from that input
    with grad and takes the gradients of its input and leaves for the
    gradient the next stage sent, on the last stage for the microbatch's
    CE sum; then the slot's scheduled transfers.  Returns (this rank's CE
    sum, 0 off the last stage; the layers' gradients, each stacked [L /
    pp, ...] f32 and summed over the microbatches; the head's likewise or
    None; dx [B_local, T, H] f32 on the first stage, else None)."""
    pp, s = _stage(mesh)
    last = s == pp - 1
    b, t = input_ids.shape
    mb = b // n_micro
    device = input_ids.device
    cos, sin = _rotary(cfg, mb, t, device)
    ids = input_ids.reshape(n_micro, mb, t)
    masks = attn_mask.reshape(n_micro, mb, t)
    specs = [AttnSpec(kv_valid=masks[m], causal=True) for m in range(n_micro)]
    xs = x.detach().reshape(n_micro, mb, t, -1) if s == 0 else None
    like = torch.empty((mb, t, cfg.hidden_size), dtype=torch_dtype(cfg.dtype), device=device)
    names = list(layers[0])
    dlayers = {w: torch.zeros((len(layers), *layers[0][w].shape), dtype=torch.float32,
                              device=device) for w in names}
    dhead = None if head is None else {k: torch.zeros(w.shape, dtype=torch.float32, device=device)
                                       for k, w in head.items()}
    leaves = [layer[w] for layer in layers for w in names] + list((head or {}).values())
    grads_to = [dlayers[w][i] for i in range(len(layers)) for w in names]
    grads_to += list((dhead or {}).values())
    ce = torch.zeros((), dtype=torch.float32, device=device)
    saved, h_out, g_out, h_in, g_in, dx = {}, {}, {}, {}, {}, [None] * n_micro
    for slot in range(sched["n_slots"]):
        if sched["fw_do"][slot, s]:
            m = int(sched["fw_mb"][slot, s])
            saved[m] = xs[m] if s == 0 else h_in.pop(m)
            if not last:
                with torch.no_grad():
                    h_out[m] = blocks(layers, saved[m], cfg, cos, sin, specs[m])
        if sched["bw_do"][slot, s]:
            m = int(sched["bw_mb"][slot, s])
            h = saved.pop(m).detach().requires_grad_()
            with torch.enable_grad():
                out = blocks(layers, h, cfg, cos, sin, specs[m], remat)
                if last:
                    out, _ = tr.masked_ce_parts(_head_logits(out, head, cfg), ids[m], masks[m])
                    ce += out.detach()
                dh, *dw = torch.autograd.grad(out, [h, *leaves], None if last else g_in.pop(m),
                                              allow_unused=True)
            for acc, g in zip(grads_to, dw):
                if g is not None:
                    acc += g
            if s == 0:
                dx[m] = dh.float()
            else:
                g_out[m] = dh
        # the slot's transfers, from the tables alone: what this stage sends
        # and what its neighbours send it
        sends, recvs, into = [], [], []
        if sched["sh_do"][slot, s]:
            sends.append((s + 1, h_out.pop(int(sched["sh_mb"][slot, s])), _H))
        if sched["sg_do"][slot, s]:
            sends.append((s - 1, g_out.pop(int(sched["sg_mb"][slot, s])), _G))
        if s > 0 and sched["sh_do"][slot, s - 1]:
            recvs.append((s - 1, like, _H))
            into.append((h_in, int(sched["sh_mb"][slot, s - 1])))
        if not last and sched["sg_do"][slot, s + 1]:
            recvs.append((s + 1, like, _G))
            into.append((g_in, int(sched["sg_mb"][slot, s + 1])))
        if sends or recvs:
            for (box, m), got in zip(into, pm.send_recv(sends, mesh, "pp", recvs)):
                box[m] = got
    return ce, dlayers, dhead, (torch.cat(dx) if s == 0 else None)


def _grads(sched: dict, layers: list, head, x, input_ids, attn_mask, cfg, mesh, n_micro,
           remat):
    """``_run``, then its CE sum over pp and dp and the gradients over dp
    (f32), in place."""
    ce, dlayers, dhead, dx = _run(sched, layers, head, x, input_ids, attn_mask, cfg, mesh,
                                  n_micro, remat)
    if mesh.shape["pp"] > 1:
        pm.all_reduce(ce, mesh, "pp")
    if mesh.shape["dp"] > 1:
        pm.all_reduce(ce, mesh, "dp")
        for g in [*dlayers.values(), *(dhead or {}).values()]:
            pm.all_reduce(g, mesh, "dp")
    return ce, dlayers, dhead, dx


def pipeline_1f1b_grads(layers: dict, head: dict | None, x, input_ids: torch.Tensor,
                        attn_mask: torch.Tensor, cfg: QwenVLConfig, mesh, n_micro: int,
                        remat: bool = False):
    """Loss numerator and gradients through the 1F1B schedule.

    ``layers``: this rank's stage of the stacked [L, ...] tree
    (``shard_params_pp``); ``head``: {"ln_f", "lm_head"}, read on the
    last stage (None elsewhere); ``x`` [B_local, T, H]: the embedded dp
    rows, read on the first stage (None elsewhere); ``input_ids`` /
    ``attn_mask``: this rank's dp rows.  At most min(S - stage, M)
    microbatch inputs are saved a stage, and idle slots compute nothing.
    Returns (ce_sum, dlayers, dhead, dx): the SUM of masked token CE over
    the whole batch (over pp and dp, on every rank) and the gradients of
    that sum: ``dlayers`` the stage's, f32, summed over dp; ``dhead`` on
    the last stage, f32, summed over dp, else None; ``dx`` [B_local, T,
    H] f32 on the first stage, else None.  The caller divides by the
    global token count and chains dx through the embedding
    (``make_train_step_pp``)."""
    pp, s = _stage(mesh)
    _check_layers(cfg.num_layers, pp)
    _micro(input_ids.shape[0], n_micro)
    # leaves that require grad, aliasing the caller's tensors
    view = tr._training_view({"layers": layers, **(head if s == pp - 1 else {})})[0]
    head_view = {k: view[k] for k in _LAST} if s == pp - 1 else None
    ce, dlayers, dhead, dx = _grads(_schedule_1f1b(pp, n_micro), view["layers"], head_view, x,
                                    input_ids, attn_mask, cfg, mesh, n_micro, remat)
    return ce, dlayers, dhead, dx


def make_train_step_pp(cfg: QwenVLConfig, optimizer, mesh, n_micro: int, remat: bool = False,
                       schedule: str = "1f1b"):
    """Pipeline-parallel train step, ``train.make_train_step``'s contract
    over a ``make_pp_mesh`` mesh: returns step(params, opt_state, batch)
    -> (params, opt_state, loss), ``params`` this rank's stage
    (``shard_params_pp``, updated in place), ``opt_state =
    optimizer.init(params)``, ``batch`` this rank's dp rows
    (``mesh.split_batch``) of input_ids and attn_mask.

    The loss is tdax's: the masked CE summed over the batch over the
    token count (``mask[:, 1:] > 0``) summed over dp.  ``"1f1b"``:
    ``pipeline_1f1b_grads``' gradients, the embedding's chained from
    dx / n on the first stage, each divided by n and cast to its param's
    dtype; the tree may not hold ``visual`` (tdax's 1F1B step builds its
    gradients from wte, layers, ln_f and lm_head alone and fails on such
    a tree).  ``"gpipe"``: the same engine on GPipe's fill-drain table,
    the same values; a ``visual`` subtree, which its loss does not read,
    gets a zero gradient, so AdamW only decays it, as tdax's.  The
    gradients are summed over dp in f32, the clip's global norm over pp
    (``OptState.update(pp=)``), and AdamW updates each stage's leaves.
    ValueError for an unknown schedule, pp not dividing the layers,
    n_micro not dividing the batch rows, and ``visual`` under 1F1B."""
    if schedule not in ("1f1b", "gpipe"):
        raise ValueError(f"unknown pipeline schedule {schedule!r}")
    pp, s = _stage(mesh)
    _check_layers(cfg.num_layers, pp)
    table = _schedule_1f1b if schedule == "1f1b" else _schedule_gpipe
    dp = mesh.shape["dp"]

    def step(params: dict, opt_state: tr.OptState, batch: dict):
        if opt_state.params is not params:
            raise ValueError("opt_state was made by optimizer.init() of another params tree")
        if schedule == "1f1b" and "visual" in params:
            raise ValueError("make_train_step_pp(schedule='1f1b') trains wte, layers, ln_f and "
                             "lm_head; the params hold a 'visual' subtree: leave it out "
                             "(init_params(with_visual=False)) or take schedule='gpipe'")
        ids, mask = batch["input_ids"], batch["attn_mask"]
        sched = table(pp, n_micro)
        _micro(ids.shape[0], n_micro)
        tree = opt_state.tree
        n = (mask[:, 1:] > 0).float().sum()
        if dp > 1:
            pm.all_reduce(n, mesh, "dp")
        n = n.clamp_min(1.0)
        x = embed_inputs(tree, cfg, ids, None, None) if s == 0 else None
        head = {k: tree[k] for k in _LAST} if s == pp - 1 else None
        ce, dlayers, dhead, dx = _grads(sched, tree["layers"], head, x, ids, mask, cfg, mesh,
                                        n_micro, remat)
        grads = []
        for leaf, (path, i) in zip(opt_state.leaves, opt_state.names):
            top, _, name = path.partition("/")
            if top == "layers":
                grads.append((dlayers[name][i] / n).to(leaf.dtype))
            elif top in _LAST:
                grads.append((dhead[top] / n).to(leaf.dtype))
            elif top == "wte":
                (g,) = torch.autograd.grad(x, [leaf], (dx / n).to(x.dtype))
                if dp > 1:
                    g = pm.all_reduce(g.float(), mesh, "dp").to(leaf.dtype)
                grads.append(g)
            else:  # visual, which the loss does not read
                grads.append(torch.zeros_like(leaf))
        del dlayers, dhead, dx  # the f32 sums, freed before AdamW's update
        opt_state.update(grads, pp=mesh if pp > 1 else None)
        return params, opt_state, ce / n

    return step
