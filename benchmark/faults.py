"""Faults planted underneath the timed path, to show that ``correct``
catches them: the CPU tests plant them in rehearsals, and
``benchmark.calibrate --fault`` reads them at the cell's own size.

``planted(job, kind)`` replaces, for the ``with`` block, the port's
entry point that the job's window calls:

- capture: ``half_batch`` (half the rows left out, the others' answers
  copied over them), ``answer_altered`` (one sample's vectors replaced by
  another's), ``state_unchanged`` (every batch returns the first batch's
  answers);
- train: ``state_unchanged`` (the step returns its state unchanged: the
  loss and no update), ``half_batch`` (half of the batch left out, the
  mean taken over the rest).
"""

from __future__ import annotations

import contextlib

import torch

KINDS = {"capture": ("half_batch", "answer_altered", "state_unchanged"),
         "train": ("state_unchanged", "half_batch")}


def _capture(kind):
    from tdax_torch.models.qwen_vl import model as port_model
    real = port_model.extract_layer_activations
    first = {}

    def broken(params, cfg, ids, mask, last, images, pos):
        if kind == "half_batch":
            h = ids.shape[0] // 2
            out = real(params, cfg, ids[:h], mask[:h], last[:h], images[:h], pos[:h])
            return torch.cat([out, out], dim=1)
        out = real(params, cfg, ids, mask, last, images, pos)
        if kind == "answer_altered":
            out = out.clone()
            out[:, 3] = out[:, 4]
        elif kind == "state_unchanged":
            out = first.setdefault("out", out)
        return out

    return port_model, "extract_layer_activations", broken


def _train(kind):
    from tdax_torch import parallel as port_parallel
    real = port_parallel.make_train_step

    def make(cfg, opt, **kw):
        step = real(cfg, opt, **kw)

        def broken(params, state, batch):
            if kind == "state_unchanged":
                loss, _ = step.loss_and_grads(params, state, batch)
                return params, state, loss
            return step(params, state, {k: v[: v.shape[0] // 2] for k, v in batch.items()})

        return broken

    return port_parallel, "make_train_step", make


@contextlib.contextmanager
def planted(job: str, kind: str):
    if kind not in KINDS[job]:
        raise ValueError(f"no fault {kind!r} for the {job} job")
    module, name, broken = (_capture if job == "capture" else _train)(kind)
    real = getattr(module, name)
    setattr(module, name, broken)
    try:
        yield
    finally:
        setattr(module, name, real)
