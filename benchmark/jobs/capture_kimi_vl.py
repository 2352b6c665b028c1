"""Kimi-VL's activation capture: batch after batch through the port's
``tdax_torch.models.kimi_vl.model.extract_layer_activations``, as the
extract loop runs it.

The capture job's window (``jobs/capture.py``) over Kimi-VL: the same 48
samples and prompts (``CaptureInputs`` with 256 image positions, the
merged patches of a 448-px image, and Kimi-VL's vocabulary), the images
normalized with the image processor's mean and std (0.5) in place of
CLIP's, and the weights drawn by ``weights_kimi_vl``.  A unit is one
batch: h2d, the forward under ``inference_mode``, the [27, batch, 2048]
last-token vectors back as f32.

``check`` holds every vector of every layer of ``check_batches``
readouts drawn from the seed against the f32 reference
(``reference/kimi_vl.py``) on the same inputs.  Once the window has
closed and before the program's state is freed (``release``), the
checked batches run once more with each expert layer's picks recorded
(``ops.moe.PICKS``; the program is deterministic: the rerun's readout
must be the window's, bit for bit, ``rerun_gap``).  The reference routes
by its own f32 scores and takes the program's picks only where they are
a near tie: where every picked expert scores within the limits file's
``near_tie`` of its own k-th choice.  A program that picks otherwise
parts from the reference there, and the vectors' gaps show it.
``route_gap`` reads how far the program's picks fall below the
reference's own top k, the largest over tokens (0 where they are one).
Besides the compared numbers it reads the 99th percentile of the vector
gaps, the share of (token, layer) routings where the reference took
picks other than its own (``route_ties``), and, after a traced window,
the expert layers' load (``ops.moe.LOAD``: the busiest expert's routed
rows over the mean, the largest over the layers).  The control runs the
reference in its lower precision on its own routing, in the program's
place: the f32 reference takes its picks at near ties as it takes the
program's.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from benchmark import spec, work_kimi_vl
from benchmark.faults import capture_faults
from benchmark.inputs import CLIP_MEAN, CLIP_STD, CaptureInputs
from benchmark.jobs import Spans, capture, rel_gap
from benchmark.reference import numerics
from benchmark.reference.kimi_vl import Model, exact_f32, route_gap
from benchmark.weights_kimi_vl import KimiWeights


def kimi_config(cfg: dict):
    """The port's ``KimiVLConfig`` for a configuration file."""
    from tdax_torch.models.kimi_vl.config import KimiVLConfig, MoonViTConfig

    v, proj = cfg["vision_config"], cfg["projector"]
    kh, kw = v["merge_kernel_size"]
    if (kh != kw or v["init_pos_emb_height"] != v["init_pos_emb_width"]
            or len(set(cfg["image_mean"])) != 1 or len(set(cfg["image_std"])) != 1
            or proj["layer_norm_eps"] != v["layer_norm_eps"]):
        raise ValueError("the port takes square merges and tables, one mean and std for "
                         "every channel, and the projector's norm at the tower's eps")
    visual = MoonViTConfig(image_size=v["image_size"], patch_size=v["patch_size"],
                           width=v["hidden_size"], layers=v["num_hidden_layers"],
                           heads=v["num_attention_heads"], mlp_dim=v["intermediate_size"],
                           pos_grid=v["init_pos_emb_height"], merge=kh,
                           layer_norm_eps=v["layer_norm_eps"], rope_theta=float(v["rope_theta"]),
                           image_mean=cfg["image_mean"][0], image_std=cfg["image_std"][0])
    return KimiVLConfig(
        vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
        num_layers=cfg["num_hidden_layers"], num_heads=cfg["num_attention_heads"],
        intermediate_size=cfg["intermediate_size"],
        moe_intermediate_size=cfg["moe_intermediate_size"],
        n_routed_experts=cfg["n_routed_experts"], n_shared_experts=cfg["n_shared_experts"],
        num_experts_per_tok=cfg["num_experts_per_tok"],
        routed_scaling_factor=cfg["routed_scaling_factor"],
        first_k_dense_replace=cfg["first_k_dense_replace"], kv_lora_rank=cfg["kv_lora_rank"],
        qk_nope_head_dim=cfg["qk_nope_head_dim"], qk_rope_head_dim=cfg["qk_rope_head_dim"],
        v_head_dim=cfg["v_head_dim"], rms_norm_eps=cfg["rms_norm_eps"],
        kv_norm_eps=cfg["kv_a_layernorm_eps"], rope_theta=float(cfg["rope_theta"]),
        visual=visual, dtype=cfg["dtype"])


def kimi_tiny(cfg: dict, dtype: str) -> dict:
    """The configuration file with the port's ``KimiVLConfig.tiny()``
    sizes, in ``dtype``."""
    from tdax_torch.models.kimi_vl.config import KimiVLConfig

    t = KimiVLConfig.tiny()
    v = t.visual
    return {**cfg, "vocab_size": t.vocab_size, "hidden_size": t.hidden_size,
            "num_hidden_layers": t.num_layers, "num_attention_heads": t.num_heads,
            "intermediate_size": t.intermediate_size,
            "moe_intermediate_size": t.moe_intermediate_size,
            "n_routed_experts": t.n_routed_experts, "n_shared_experts": t.n_shared_experts,
            "num_experts_per_tok": t.num_experts_per_tok, "kv_lora_rank": t.kv_lora_rank,
            "qk_nope_head_dim": t.qk_nope_head_dim, "qk_rope_head_dim": t.qk_rope_head_dim,
            "v_head_dim": t.v_head_dim,
            "vision_config": {**cfg["vision_config"], "hidden_size": v.width,
                              "num_hidden_layers": v.layers, "num_attention_heads": v.heads,
                              "intermediate_size": v.mlp_dim, "init_pos_emb_height": v.pos_grid,
                              "init_pos_emb_width": v.pos_grid, "image_size": v.image_size},
            "projector": {**cfg["projector"], "hidden_size": 4 * v.width,
                          "out_size": t.hidden_size},
            "dtype": dtype, "weights": dtype}


def misrouted():
    """(``ops.moe``, ``route``, a router that swaps a token's k-th choice
    for its (k + 1)-th where the two are not a near tie but the swap stays
    inside ``route_gap``'s limit): the misroute that only the reference's
    own routing sees."""
    from tdax_torch.ops import moe

    with open(spec.ROOT / "benchmark/limits/kimi-vl-a3b-instruct.capture-kimi-vl.json") as f:
        limits = json.load(f)
    low, high = limits["near_tie"], limits["limits"]["route_gap"]

    def route(h, w_gate, bias, top_k, scale):
        s = torch.sigmoid(h.float() @ w_gate.float())
        ranked = torch.sort(s + bias.float(), dim=-1, descending=True, stable=True)
        picked = ranked.indices[:, :top_k].clone()
        margin = ranked.values[:, top_k - 1] - ranked.values[:, top_k]
        swap = (margin > low) & (margin <= high)
        picked[:, -1] = torch.where(swap, ranked.indices[:, top_k], picked[:, -1])
        w = s.gather(1, picked)
        return picked, w / (w.sum(dim=-1, keepdim=True) + 1e-20) * scale

    return moe, "route", route


class Job(capture.Job):
    # extract_layer_activations(params, cfg, ids, mask, last, images, img_pos)
    FAULTS = {**capture_faults("tdax_torch.models.kimi_vl.model", "extract_layer_activations",
                               batch_args=(2, 3, 4, 5, 6)),
              "misrouted": misrouted}
    # the spans a unit holds once (each layer's ``mla``, ``moe`` and
    # ``route`` ranges are read by the cell's per-layer metrics)
    SPANS = ("capture", "visual", "decoder")
    tiny = staticmethod(kimi_tiny)

    def __init__(self, cell, seed: int, device, spans: Spans | None = None):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.spans = spans or Spans()
        self.cfg, self.mix = cell.config, cell.traffic
        self.outputs: list[tuple[int, np.ndarray]] = []
        self.params = None

    def weights(self) -> dict:
        return KimiWeights(self.cfg, self.seed, self.device, getattr(torch, self.cfg["dtype"])
                           ).build()

    def setup(self) -> None:
        from tdax_torch.ops import moe

        if self.cfg["weights"] != self.cfg["dtype"]:
            raise ValueError(f"no port path serves Kimi-VL's weights {self.cfg['weights']!r}")
        self.port_cfg = kimi_config(self.cfg)
        vis = self.port_cfg.visual
        self.inputs = CaptureInputs(self.mix, vis.image_size, vis.n_queries,
                                    self.cfg["vocab_size"], self.seed)
        # CLIP's normalization undone, the image processor's applied
        mean, std = (np.asarray(x, np.float32)[:, None, None]
                     for x in (self.cfg["image_mean"], self.cfg["image_std"]))
        clip_mean, clip_std = CLIP_MEAN[:, None, None], CLIP_STD[:, None, None]
        self.inputs.pool = [(*b[:3], ((b[3] * clip_std + clip_mean) - mean) / std, b[4])
                            for b in self.inputs.pool]
        self.params = self.weights()
        self.work = work_kimi_vl.capture_batch(self.cfg, self.mix["batch_size"], self.inputs.seq)
        moe.LOAD.take()  # no tally of an earlier run
        self.run_batch(0)  # every shape of the window, once
        self.drain()

    def release(self) -> None:
        """The checked batches once more, each expert layer's picks
        recorded, then the program's state freed."""
        from tdax_torch.ops import moe

        self.routes, gaps = {}, [0.0]
        for i, acts in self.checked():
            with moe.PICKS.record():
                again = self.run_batch(i)
            self.routes[i] = moe.PICKS.take()
            gaps.append(float(np.abs(again - acts).max()) if again.shape == acts.shape
                        else float("inf"))
        self.rerun_gap = max(gaps)
        self.params = None

    def run_batch(self, i: int) -> np.ndarray:
        from tdax_torch.models.kimi_vl import model as port_model

        ids, mask, last, images, img_pos = self.inputs.batch(i)
        with self.spans("h2d"):
            dev = [torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                   for a in (ids, mask, last, images, img_pos)]
        with self.spans("forward"), torch.inference_mode():
            acts = port_model.extract_layer_activations(self.params, self.port_cfg, *dev)
        with self.spans("readout"):
            return acts.float().cpu().numpy()

    # --- correct ------------------------------------------------------
    def reference(self, numerics_name: str, batches, routes: dict | None) -> list[tuple]:
        """The reference on each batch index, taking the picks of
        ``routes`` (batch -> layer -> picks) at near ties: ([layers,
        batch, hidden], its routing per layer, the picks handed in), the
        weights drawn again from the seed."""
        exact_f32()
        model = Model(self.weights(), self.cfg, numerics.named(numerics_name),
                      self.cell.limits["near_tie"])
        tokens = self.mix["batch_size"] * self.inputs.seq
        k = self.cfg["num_experts_per_tok"]
        out = []
        for i in batches:
            dev = [torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                   for a in self.inputs.batch(i)]
            handed = (routes or {}).get(i)
            if handed and any(p.shape != (tokens, k) for p in handed.values()):
                handed = None  # a rerun of another batch shape: the reference routes itself
            model.routing = {}
            out.append((model.capture(*dev, routes=handed).cpu(), dict(model.routing), handed))
        return out

    def gaps(self, got: list, want: list) -> dict:
        """The widest relative gap of any vector, the median and the 99th
        percentile."""
        gaps = torch.cat([rel_gap(torch.as_tensor(g), w).reshape(-1) for g, w in zip(got, want)])
        return {"rel_err_max": float(gaps.max()), "rel_err_median": float(gaps.median()),
                "rel_err_p99": float(torch.quantile(gaps.double(), 0.99))}

    def routings(self, refs: list) -> dict:
        """``route_gap``, the largest of the picks handed in below the
        reference's choice scores over layers and batches (inf, alone,
        where picks are missing), and ``route_ties``, the share of (token,
        layer) routings that took picks other than the reference's own."""
        k, worst, taken, seen = self.cfg["num_experts_per_tok"], 0.0, 0, 0
        for _, routing, handed in refs:
            if not handed or set(handed) != set(routing):
                return {"route_gap": float("inf")}
            for layer, (choice, own, n) in routing.items():
                worst = max(worst, route_gap(choice, handed[layer], k))
                taken, seen = taken + n, seen + own.shape[0]
        return {"route_gap": worst, "route_ties": taken / seen}

    def check(self) -> dict:
        from tdax_torch.ops import moe

        picked = self.checked()
        want = self.reference(self.cfg["weights"], [i for i, _ in picked], self.routes)
        numbers = self.gaps([acts for _, acts in picked], [w for w, _, _ in want])
        numbers.update(self.routings(want))
        numbers["rerun_gap"] = self.rerun_gap
        load = moe.balance(moe.LOAD.take())
        if load:
            numbers["expert_load_max_over_mean"] = max(v["max_over_mean"] for v in load.values())
        return numbers

    def control(self) -> dict:
        """The reference in the limits file's lower precision on its own
        routing, in the program's place: the f32 reference takes its
        picks at near ties as it takes the program's."""
        batches = [i for i, _ in self.checked()]
        got = self.reference(self.cell.limits["control"], batches, None)
        picks = {i: {layer: own for layer, (_, own, _) in routing.items()}
                 for i, (_, routing, _) in zip(batches, got)}
        want = self.reference(self.cfg["weights"], batches, picks)
        numbers = self.gaps([g for g, _, _ in got], [w for w, _, _ in want])
        numbers.update(self.routings(want))
        return numbers
