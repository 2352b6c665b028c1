"""The text-only fine-tune: the port's ``make_train_step(cfg,
default_optimizer(lr), remat=True)`` step after step on one params tree
and one optimizer state.

Set-up makes the weights and a pool of token batches from the seed,
builds the step and its AdamW state once, and drives that same object
through its first ``check_steps`` steps (batches 0, 1, 2: rows that all
differ), which also warm up every shape.  From them it keeps what the
check compares: each step's loss, the norm of the first gradient as
AdamW received it (its first moment after one step over 1 - b1), and
the norm of each parameter's change after the last of them.  The window
then goes on stepping the same object.  ``check`` follows the same steps
with the f32 reference once the program's state is freed.
"""

from __future__ import annotations

import statistics

import torch

from benchmark import work
from benchmark.faults import train_step_faults
from benchmark.jobs import Spans, qwen_config, qwen_tiny
from benchmark.inputs import TokenBatches
from benchmark.reference import numerics
from benchmark.reference.qwen_vl import exact_f32
from benchmark.reference.train import B1, TrainReference
from benchmark.weights import Weights


def _leaf_name(path: str, i) -> str:
    return path if i is None else f"{path}/{i}"


class Job:
    unit_name = "sequence"
    FAULTS = train_step_faults("tdax_torch.parallel", "make_train_step")
    SPANS = ("train_step", "decoder", "backward", "clip")
    tiny = staticmethod(qwen_tiny)

    def __init__(self, cell, seed: int, device, spans: Spans | None = None):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.spans = spans or Spans()
        self.cfg, self.mix = cell.config, cell.traffic
        self.md = work.model(self.cfg)
        self.params = self.state = self.step = None
        self.program: dict = {}

    def weights(self) -> Weights:
        return Weights(self.md, self.seed, self.device, getattr(torch, self.cfg["dtype"]),
                       with_visual=False)

    def setup(self) -> None:
        from tdax_torch import parallel as port_parallel

        if self.cfg["weights"] != self.cfg["dtype"]:
            raise ValueError("the fine-tune trains the configuration's own dtype")
        mix, md = self.mix, self.md
        cfg = qwen_config(self.cfg)
        self.batches = TokenBatches(mix, md.vocab, self.seed, self.device)
        weights = self.weights()
        self.params = weights.build()
        opt = port_parallel.default_optimizer(mix["lr"])
        self.state = opt.init(self.params)
        self.step = port_parallel.make_train_step(cfg, opt, remat=mix["remat"],
                                                  device=self.device)
        self.work = work.train_step(md, mix["batch_size"], mix["seq_len"], mix["remat"])
        losses = []
        for s in range(mix["check_steps"]):
            losses.append(self.run_step(s))
            if s == 0:
                self.program["first_update"] = self._moment_norms()
        self.program["losses"] = [float(x) for x in losses]
        self.program["change"] = self._change_norms(weights)
        self.done = mix["check_steps"]

    def _moment_norms(self) -> dict:
        """Per leaf, |mu| / (1 - b1) after one step: the first gradient as
        AdamW received it."""
        out = {}
        for leaf, (path, i) in zip(self.state.leaves, self.state.names):
            mu = self.state.torch_opt.state[leaf]["exp_avg"]
            out[_leaf_name(path, i)] = float(mu.float().norm()) / (1 - B1)
        return out

    def _change_norms(self, weights: Weights) -> dict:
        """Per leaf, |p - p0|, p0 made again leaf by leaf."""
        out = {}
        by_path: dict = {}
        for leaf, (path, i) in zip(self.state.leaves, self.state.names):
            by_path.setdefault(path, []).append((leaf, i))
        for path, leaves in by_path.items():
            p0 = weights.initial(path)
            for leaf, i in leaves:
                start = p0 if i is None else p0[i]
                out[_leaf_name(path, i)] = float((leaf.detach().float() - start.float()).norm())
            del p0
        return out

    def run_step(self, i: int) -> torch.Tensor:
        with self.spans("step"):
            self.params, self.state, loss = self.step(self.params, self.state,
                                                      self.batches.batch(i))
        return loss

    def unit(self, i: int) -> int:
        self.run_step(self.done + i)
        return self.mix["batch_size"]

    def drain(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def release(self) -> None:
        self.params = self.state = self.step = None

    # --- correct ------------------------------------------------------
    def follow(self, numerics_name: str) -> dict:
        """The reference's record of the checked steps."""
        exact_f32()
        ref = TrainReference(self.weights().build(), self.md, numerics.named(numerics_name),
                             self.mix["lr"])
        for s in range(self.mix["check_steps"]):
            b = self.batches.batch(s)
            ref.step(b["input_ids"], b["attn_mask"])
        return {"losses": ref.losses, "first_update": ref.first_update_norms(),
                "change": ref.change_norms()}

    @staticmethod
    def compare(got: dict, want: dict) -> dict:
        """The loss gap of the worst step; per norm, the worst leaf's gap
        (and its name), each leaf's against the larger of its reference
        norm and the median leaf's.  A leaf whose reference gradient is
        under a thousandth of the median leaf's moves by round-off alone
        and is left out of the change."""
        out = {"loss_gap": max(abs(a - b) for a, b in zip(got["losses"], want["losses"]))}
        still = {name for name, n in want["first_update"].items()
                 if n >= 1e-3 * statistics.median(want["first_update"].values())}
        for key, names in (("first_update", sorted(want["first_update"])), ("change", still)):
            med = statistics.median(want[key][n] for n in names)
            gaps = {n: abs(got[key][n] - want[key][n]) / max(want[key][n], med) for n in names}
            worst = max(gaps, key=gaps.get)
            out[f"{key}_gap"] = gaps[worst]
            out[f"{key}_worst_leaf"] = worst
        return out

    def check(self) -> dict:
        return self.compare(self.program, self.follow(self.cfg["weights"]))

    def control(self) -> dict:
        """The reference in the limits file's lower precision, in the
        program's place."""
        want = self.follow(self.cfg["weights"])
        return self.compare(self.follow(self.cell.limits["control"]), want)
