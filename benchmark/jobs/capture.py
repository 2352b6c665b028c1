"""The activation capture: batch after batch through the port's
``extract_layer_activations``, as ``pipeline/extract.py``'s loop runs it.

A unit is one batch: its host arrays go to the card (``h2d``), the
forward runs under ``inference_mode`` (``forward``), and the [layers,
batch, hidden] last-token vectors come back to the host as f32
(``readout``).  Every readout is kept; once the window has closed,
``check`` draws ``check_batches`` of them from the seed and holds every
vector of every layer against the f32 reference on the same inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import work
from benchmark.faults import capture_faults
from benchmark.jobs import Spans, qwen_config, qwen_tiny, rel_gap
from benchmark.inputs import CaptureInputs
from benchmark.reference import numerics
from benchmark.reference.qwen_vl import Model, exact_f32
from benchmark.weights import Weights


class Job:
    unit_name = "sample"
    # extract_layer_activations(params, cfg, ids, mask, last, images, img_pos)
    FAULTS = capture_faults("tdax_torch.models.qwen_vl.model", "extract_layer_activations",
                            batch_args=(2, 3, 4, 5, 6))
    SPANS = ("capture", "visual", "decoder")
    tiny = staticmethod(qwen_tiny)

    def __init__(self, cell, seed: int, device, spans: Spans | None = None):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.spans = spans or Spans()
        self.cfg, self.mix = cell.config, cell.traffic
        self.md = work.model(self.cfg)
        self.outputs: list[tuple[int, np.ndarray]] = []
        self.params = None

    def weights(self) -> dict:
        return Weights(self.md, self.seed, self.device, getattr(torch, self.cfg["dtype"])).build()

    def setup(self) -> None:
        from tdax_torch.models.qwen_vl import quantize as port_quantize

        self.port_cfg = qwen_config(self.cfg)
        md = self.md
        self.inputs = CaptureInputs(self.mix, md.image_size, md.n_queries, md.vocab, self.seed)
        params = self.weights()
        if self.cfg["weights"] != self.cfg["dtype"]:
            if self.cfg["weights"] != "int8_per_channel":
                raise ValueError(f"no port path serves weights {self.cfg['weights']!r}")
            params = port_quantize.quantize_params(params)
        self.params = params
        b = self.mix["batch_size"]
        self.work = work.capture_batch(md, b, self.inputs.seq)
        if self.cfg["weights"] == "int8_per_channel":
            self.work.qmm = work.capture_qmm(md, b, self.inputs.seq)
        self.run_batch(0)  # every shape of the window, once
        self.drain()

    def run_batch(self, i: int) -> np.ndarray:
        from tdax_torch.models.qwen_vl import model as port_model

        ids, mask, last, images, img_pos = self.inputs.batch(i)
        with self.spans("h2d"):
            dev = [torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                   for a in (ids, mask, last, images, img_pos)]
        with self.spans("forward"), torch.inference_mode():
            acts = port_model.extract_layer_activations(self.params, self.port_cfg, *dev)
        with self.spans("readout"):
            return acts.float().cpu().numpy()

    def unit(self, i: int) -> int:
        self.outputs.append((i, self.run_batch(i)))
        return self.mix["batch_size"]

    def drain(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def release(self) -> None:
        self.params = None

    # --- correct ------------------------------------------------------
    def checked(self) -> list[tuple[int, np.ndarray]]:
        """The readouts the check compares: ``check_batches`` of those the
        window completed, drawn from the seed, each on other inputs (a
        stale answer can then match one of them at most)."""
        rng = np.random.default_rng([self.seed % (1 << 63), 7])
        picked, slots = [], set()
        for j in rng.permutation(len(self.outputs)):
            slot = self.outputs[j][0] % len(self.inputs.pool)
            if slot not in slots and len(picked) < self.mix["check_batches"]:
                picked.append(j)
                slots.add(slot)
        return [self.outputs[j] for j in sorted(picked)]

    def reference(self, numerics_name: str, batches) -> list[torch.Tensor]:
        """The f32 reference's [layers, batch, hidden] for each batch index,
        the weights drawn again from the seed."""
        exact_f32()
        model = Model(self.weights(), self.md, numerics.named(numerics_name),
                      eps=self.cfg["layer_norm_epsilon"], rope_base=self.cfg["rotary_emb_base"])
        out = []
        for i in batches:
            arrays = self.inputs.batch(i)
            dev = [torch.from_numpy(np.ascontiguousarray(a)).to(self.device) for a in arrays]
            out.append(model.capture(*dev).cpu())
        return out

    def gaps(self, got: list, want: list) -> dict:
        """The widest relative gap of any vector, and the median."""
        gaps = torch.cat([rel_gap(torch.as_tensor(g), w).reshape(-1) for g, w in zip(got, want)])
        return {"rel_err_max": float(gaps.max()), "rel_err_median": float(gaps.median())}

    def check(self) -> dict:
        picked = self.checked()
        want = self.reference(self.cfg["weights"], [i for i, _ in picked])
        return self.gaps([acts for _, acts in picked], want)

    def control(self) -> dict:
        """The control in the program's place: the reference in the
        lower precision the limits file names, on the checked batches."""
        batches = [i for i, _ in self.checked()]
        got = self.reference(self.cell.limits["control"], batches)
        want = self.reference(self.cfg["weights"], batches)
        return self.gaps(got, want)
