"""The expert layer on the card: the grouped launch against the per-expert
loop, one grouped launch a projection, and no wait for the host.

Marked ``cuda``: these skip where no card is present.  This file imports
neither ``jax`` nor ``tdax``, so on the machine with the card it runs
without the JAX conftest:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_moe_cuda.py
"""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tdax_torch.ops import moe

pytestmark = pytest.mark.cuda

# Kimi-VL's expert layer: 64 experts of 1408 at width 2048, top 6 of 320 tokens
E, H, F, K, T = 64, 2048, 1408, 6, 320


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the grouped product has no CPU launch)")
    from tdax_torch.runtime import get_device
    return get_device()


def _layer(device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)

    def draw(*shape, scale=None, dtype=torch.bfloat16):
        w = torch.randn(shape, generator=g, device=device, dtype=dtype)
        return w.mul_(scale if scale is not None else shape[-2] ** -0.5)

    return {"router_w": draw(H, E), "router_bias": draw(E, scale=0.05, dtype=torch.float32),
            "experts_gate_up": draw(E, H, 2 * F), "experts_down": draw(E, F, H)}, draw(T, H,
                                                                                     scale=1.0)


def test_grouped_launch_matches_the_per_expert_loop(device):
    """One launch over the 64 groups against 64 products, each with f32
    sums rounded once to bf16: equal up to the sums' order, 1e-2."""
    layer, h = _layer(device)
    picked, _ = moe.route(h, layer["router_w"], layer["router_bias"], K, 2.446)
    order, ends, tokens, _ = moe.dispatch(picked, E)
    x = h.index_select(0, tokens)
    before = moe.GROUPED_LAUNCHES
    got = moe.grouped_mm(x, layer["experts_gate_up"], ends)
    assert moe.GROUPED_LAUNCHES == before + 1
    want = moe.grouped_mm_plain(x, layer["experts_gate_up"], ends)
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=1e-2)
    # the whole layer on the card against the same layer on the CPU, f32
    cpu = {k: v.cpu().float() for k, v in layer.items()}
    y = moe.moe(h, layer, K, 2.446, 1)
    y_cpu = moe.moe(h.cpu().float(), cpu, K, 2.446, 1)
    rel = (y.float().cpu() - y_cpu).norm() / y_cpu.norm()
    assert rel < 2e-2, rel  # bf16 operands and outputs against f32 throughout


def test_one_grouped_launch_per_projection(device, tmp_path):
    """gate-and-up and down: two grouped launches a layer, each one CUTLASS
    grouped kernel over all experts."""
    layer, h = _layer(device, 1)
    moe.moe(h, layer, K, 2.446, 1)
    torch.cuda.synchronize()
    before = moe.GROUPED_LAUNCHES
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        moe.moe(h, layer, K, 2.446, 1)
        torch.cuda.synchronize()
    assert moe.GROUPED_LAUNCHES == before + 2
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)
    events = events["traceEvents"] if isinstance(events, dict) else events
    grouped = [e for e in events if e.get("cat") == "kernel"
               and "groupproblemshape" in e["name"].lower()]
    assert len(grouped) == 2, [e["name"][:80] for e in grouped]


def test_the_expert_layer_never_waits_for_the_host(device):
    """Under the sync debug mode "error", a call that waits for the card
    raises; the layer (routing, dispatch, grouped products, combine, and
    the load tally while a profiler records) makes none."""
    layer, h = _layer(device, 2)
    moe.moe(h, layer, K, 2.446, 1)  # first-call set-up outside the check
    torch.cuda.synchronize()
    moe.LOAD.take()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.cuda.set_sync_debug_mode("error")
        try:
            moe.moe(h, layer, K, 2.446, 1)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    assert sum(moe.LOAD.take()[1]) == T * K
