"""Faults planted underneath the timed path, to show that ``correct``
catches them: the CPU tests plant them in rehearsals, and
``benchmark.calibrate --fault`` reads them at the cell's own size.

Each job class declares its faults in ``FAULTS``: kind -> a factory that,
called when the fault is planted, returns (module, attribute, broken
stand-in) for the entry point the job's window calls.
``planted(job, kind)`` replaces that attribute for the ``with`` block;
``kinds(job)`` lists a job's kinds.  Two helpers make them:

- ``capture_faults``, for an entry point that returns a capture with the
  batch on axis 1: ``half_batch`` (half the rows left out, the others'
  answers copied over them), ``answer_altered`` (one sample's vectors
  replaced by another's), ``state_unchanged`` (every call returns the
  first call's answers);
- ``train_step_faults``, for a factory of training steps
  ``step(params, state, batch) -> (params, state, loss)`` with
  ``step.loss_and_grads``: ``state_unchanged`` (the step returns its
  state unchanged: the loss and no update), ``half_batch`` (half of the
  batch left out, the mean taken over the rest).
"""

from __future__ import annotations

import contextlib
import importlib

import torch

from benchmark import spec


def capture_faults(module: str, attr: str, batch_args: tuple[int, ...]) -> dict:
    """The capture kinds for ``module.attr``, whose positional arguments
    ``batch_args`` carry the batch on axis 0 and whose output carries it
    on axis 1."""

    def factory(kind):
        def make():
            mod = importlib.import_module(module)
            real = getattr(mod, attr)
            first = {}

            def broken(*args):
                if kind == "half_batch":
                    h = args[batch_args[0]].shape[0] // 2
                    out = real(*(a[:h] if i in batch_args else a for i, a in enumerate(args)))
                    return torch.cat([out, out], dim=1)
                out = real(*args)
                if kind == "answer_altered":
                    out = out.clone()
                    out[:, 3] = out[:, 4]
                elif kind == "state_unchanged":
                    out = first.setdefault("out", out)
                return out

            return mod, attr, broken
        return make

    return {kind: factory(kind) for kind in ("half_batch", "answer_altered", "state_unchanged")}


def train_step_faults(module: str, attr: str) -> dict:
    """The training kinds for the step factory ``module.attr``."""

    def factory(kind):
        def make():
            mod = importlib.import_module(module)
            real = getattr(mod, attr)

            def make_step(*args, **kw):
                step = real(*args, **kw)

                def broken(params, state, batch):
                    if kind == "state_unchanged":
                        loss, _ = step.loss_and_grads(params, state, batch)
                        return params, state, loss
                    return step(params, state, {k: v[: v.shape[0] // 2] for k, v in batch.items()})

                return broken

            return mod, attr, make_step
        return make

    return {kind: factory(kind) for kind in ("state_unchanged", "half_batch")}


def kinds(job: str) -> tuple[str, ...]:
    """The fault kinds the job ``job`` declares."""
    return tuple(spec.job(job).FAULTS)


@contextlib.contextmanager
def planted(job: str, kind: str):
    declared = spec.job(job).FAULTS
    if kind not in declared:
        raise ValueError(f"no fault {kind!r} for the {job} job")
    module, name, broken = declared[kind]()
    real = getattr(module, name)
    setattr(module, name, broken)
    try:
        yield
    finally:
        setattr(module, name, real)
