"""The Kimi-VL cell's own pieces: its configuration file as the port's
defaults, its unit's work, its per-layer readers on synthetic traces,
the spans each traced unit holds once per layer, and the check's routing
gap and near ties."""

import json
import types

import pytest
import torch

from benchmark import program_spans, spec, work_kimi_vl
from benchmark.jobs.capture_kimi_vl import kimi_config, kimi_tiny
from benchmark.reference import numerics
from benchmark.reference.kimi_vl import Model, route_gap, token_gaps
from benchmark.rehearse import tiny_cell
from benchmark.trace import Trace

CELL = "kimi-vl-a3b-instruct.capture-kimi-vl"
CFG = spec.cell(CELL).config
READERS = ("mla_ms", "moe_ms", "route_ms", "expert_gemm_roofline", "mla_flash_roofline",
           "moonvit_flash_roofline")


def test_the_file_is_the_published_model_and_the_ports_defaults():
    from tdax_torch.models.kimi_vl.config import KimiVLConfig

    assert kimi_config(CFG) == KimiVLConfig()
    assert CFG["reduced"] == [] and CFG["num_hidden_layers"] == 27
    with open(spec.ROOT / "benchmark/configs/kimi-vl-a3b-instruct.json") as f:
        assert json.load(f)["n_routed_experts"] == 64
    assert kimi_config(kimi_tiny(CFG, "float32")) == KimiVLConfig.tiny(dtype="float32")


def test_a_units_work():
    """16 x 320: 39.03 TFLOP; the grouped products' bound 13.97 ms (the
    tensor cores'), every layer's latent-attention forward 0.845 ms,
    MoonViT's 27 attention forwards 2.11 ms."""
    w = work_kimi_vl.capture_batch(CFG, 16, 320)
    assert w.flops == pytest.approx(39.032e12, rel=1e-4)
    assert w.expert_bound_s == pytest.approx(13.9728e-3, rel=1e-4)
    assert w.mla_attn_bound_s == pytest.approx(0.84529e-3, rel=1e-4)
    assert w.vit_attn_bound_s == pytest.approx(27 * 4 * 16 * 16 * 1024 ** 2 * 72 / 989e12)
    assert w.expert_bound_s == pytest.approx(26 * 3 * 2 * 6 * 5120 * 2048 * 1408 / 989e12)


def _ann(name, ts, dur):
    return {"cat": "user_annotation", "ph": "X", "name": name, "ts": ts, "dur": dur, "tid": 1}


def _kernel(name, corr, at, dur):
    return [{"cat": "cuda_runtime", "ph": "X", "name": "cudaLaunchKernel", "ts": at, "dur": 2,
             "tid": 1, "args": {"correlation": corr}},
            {"cat": "kernel", "ph": "X", "name": name, "ts": at + 5, "dur": dur, "tid": 7,
             "args": {"correlation": corr}}]


def test_the_readers_on_one_layer():
    """One expert layer a unit: the latent attention's kernels, the
    routing inside the expert FFN, the grouped launch's two kernels."""
    ev = [_ann("bench.window", 0, 10000), _ann("tdax.mla", 100, 900),
          _ann("tdax.moe", 1000, 5000), _ann("tdax.route", 1100, 400),
          _ann("tdax.route", 5000, 500)]
    ev += _kernel("void (anonymous namespace)::flash_fwd_mla_kernel<true, false>", 1, 200, 300)
    ev += _kernel("nvjet_tst_128x256", 2, 600, 200)
    ev += _kernel("sort_kernel", 3, 1200, 100)
    ev += _kernel("void at::cuda::detail::prepare_grouped_gemm_data<>", 4, 1600, 10)
    ev += _kernel("_ZN7cutlass13device_kernelINS_4gemm6kernel13GemmUniversalINS5_17GroupProblem"
                  "ShapeE", 5, 1700, 990)
    ev += _kernel("index_copy_kernel", 6, 5100, 200)
    ev += _kernel("void (anonymous namespace)::flash_fwd_sm90_kernel<7, 104, false, false>",
                  7, 7000, 400)
    w = work_kimi_vl.KimiWork(flops=0.0, expert_bound_s=500e-6, mla_attn_bound_s=150e-6,
                              vit_attn_bound_s=100e-6)
    ctx = types.SimpleNamespace(trace=Trace(ev), work=w, units=1)
    got = {m: spec.layer_reader(m).read(ctx) for m in READERS}
    assert got == pytest.approx({"mla_ms": 0.5, "moe_ms": 1.0, "route_ms": 0.3,
                                 "expert_gemm_roofline": 50.0, "mla_flash_roofline": 50.0,
                                 "moonvit_flash_roofline": 25.0})
    # a unit of another cell's work reads nothing of these
    ctx.work = types.SimpleNamespace(flops=1.0)
    assert spec.layer_reader("expert_gemm_roofline").read(ctx) is None
    assert spec.layer_reader("mla_flash_roofline").read(ctx) is None
    assert spec.layer_reader("moonvit_flash_roofline").read(ctx) is None


def test_each_traced_unit_holds_a_range_per_layer():
    cell = tiny_cell(CELL)
    out = program_spans.report(cell, 2 ** 31 + 9, "cpu")
    units, layers = cell.traffic["trace_units"], cell.config["num_hidden_layers"]
    moe_layers = layers - cell.config["first_k_dense_replace"]
    assert {n: out["ranges_by_span"][n] for n in ("mla", "moe", "route")} == {
        "mla": layers * units, "moe": moe_layers * units, "route": 2 * moe_layers * units}


def test_route_gap():
    choice = torch.tensor([[0.9, 0.8, 0.7, 0.1], [0.5, 0.5, 0.2, 0.6]])
    assert route_gap(choice, torch.tensor([[0, 1], [3, 0]]), 2) == 0.0  # top 2 (a tie either way)
    assert route_gap(choice, torch.tensor([[1, 0], [3, 1]]), 2) == 0.0
    assert route_gap(choice, torch.tensor([[0, 2], [3, 0]]), 2) == pytest.approx(0.1)
    assert route_gap(choice, torch.tensor([[0, 1], [2, 3]]), 2) == pytest.approx(0.3)


def test_token_gaps():
    choice = torch.tensor([[0.9, 0.8, 0.7, 0.1], [0.5, 0.5, 0.2, 0.6]])
    got = token_gaps(choice, torch.tensor([[0, 2], [2, 3]]), 2)
    assert got.tolist() == pytest.approx([0.1, 0.3])


def test_the_reference_takes_handed_picks_only_at_near_ties():
    """Choice scores 0.8, 0.7, 0.69, 0.5 for every token, top 2: picks
    [0, 2] fall 0.01 below the second choice (a near tie at 0.04, taken),
    [0, 3] fall 0.2 below (refused: the token runs the reference's own
    [0, 1]); the weights come from the reference's scores either way."""
    cfg = {**kimi_tiny(CFG, "float32"), "num_experts_per_tok": 2, "n_routed_experts": 4}
    g = torch.Generator().manual_seed(0)
    hid, f = 8, 4
    layer = {"router_w": torch.zeros(hid, 4), "router_bias": torch.tensor([0.3, 0.2, 0.19, 0.0]),
             "experts_gate_up": torch.randn((4, hid, 2 * f), generator=g),
             "experts_down": torch.randn((4, f, hid), generator=g),
             "shared_gate_up": torch.randn((hid, 2 * f), generator=g),
             "shared_down": torch.randn((f, hid), generator=g)}
    h = torch.randn((2, hid), generator=g)

    def run(near_tie, handed):
        ref = Model({}, cfg, numerics.named("float32"), near_tie)
        out = ref.moe(h, layer, 1, None if handed is None else torch.tensor(handed))
        return out, ref.routing[1]

    got, (_, own, taken) = run(0.04, [[0, 2], [0, 3]])
    assert own.tolist() == [[0, 1], [0, 1]] and taken == 1
    want, _ = run(1.0, [[0, 2], [0, 1]])  # every pick taken
    torch.testing.assert_close(got, want)
    alone, (_, _, none_taken) = run(0.04, None)
    assert none_taken == 0 and torch.equal(alone[1], got[1]) and not torch.allclose(alone[0], got[0])
    assert run(0.0, [[0, 2], [0, 3]])[1][2] == 0  # no room: the reference's own routing
