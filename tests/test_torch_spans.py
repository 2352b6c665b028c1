"""The port's ``tdax.*`` profiler spans and its per-batch and per-build
events, on the CPU at ``QwenVLConfig.tiny()``.

Under ``torch.profiler`` a capture records ``tdax.capture`` holding
``tdax.visual`` and ``tdax.decoder``, and a remat train step
``tdax.train_step`` holding ``tdax.decoder``, ``tdax.backward`` and
``tdax.clip`` in that order; the values are bitwise those of a run with
no profiler, and with none recording no ``record_function`` is made.
The extract loop's ranges (its image thread's under a profiler of every
thread), its ``extract_batch`` events and the kernel build's
``kernel_build`` event, read back from ``TDAX_LOG``.
"""

import json
import os
import stat
import sys

import numpy as np
import pytest
import torch
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile

from tdax_torch.config import DatasetConfig, ExtractConfig
from tdax_torch.data.dataset import generate_dataset
from tdax_torch.models.qwen_vl import QwenVLConfig
from tdax_torch.models.qwen_vl.model import extract_layer_activations, init_params
from tdax_torch.ops import _build
from tdax_torch.parallel import default_optimizer, make_train_step
from tdax_torch.pipeline.extract import extract_activations
from tdax_torch.utils import log

CFG = QwenVLConfig.tiny(dtype="float32")


def _capture_inputs(seed=1):
    """Two rows with an image span each, the second right-padded."""
    rng = np.random.default_rng(seed)
    b, t, nq = 2, 40, CFG.visual.n_queries
    ids = torch.from_numpy(rng.integers(1, 257, (b, t))).long()
    mask = torch.ones((b, t), dtype=torch.int32)
    mask[1, 30:] = 0
    last = torch.tensor([38, 29])
    images = torch.from_numpy(rng.normal(size=(b, 3, CFG.visual.image_size,
                                               CFG.visual.image_size)).astype(np.float32))
    pos = torch.stack([torch.arange(3, 3 + nq), torch.arange(5, 5 + nq)])
    return ids, mask, last, images, pos


def _capture(params):
    with torch.inference_mode():
        return extract_layer_activations(params, CFG, *_capture_inputs())


def _train_step(seed=3):
    """One remat step from a fresh tree; returns the updated params."""
    params = init_params(CFG, "cpu", seed, with_visual=False)
    opt = default_optimizer(1e-3)
    state = opt.init(params)
    step = make_train_step(CFG, opt, remat=True, device="cpu")
    ids = torch.from_numpy(np.random.default_rng(seed).integers(1, CFG.vocab_size, (2, 24)))
    batch = {"input_ids": ids.long(), "attn_mask": torch.ones_like(ids, dtype=torch.int32)}
    params, state, loss = step(params, state, batch)
    return params, loss


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else [v])


def _ranges(prof) -> list:
    """(name, start, end, thread) of every ``tdax.*`` range, by start."""
    out = [(e.name, e.time_range.start, e.time_range.end, e.thread) for e in prof.events()
           if e.name.startswith("tdax.")]
    return sorted(out, key=lambda r: r[1])


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.fixture(scope="module")
def params():
    return init_params(CFG, "cpu", 7)


def test_capture_records_visual_and_decoder_inside_capture(params):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _capture(params)
    ranges = _ranges(prof)
    assert [r[0] for r in ranges] == ["tdax.capture", "tdax.visual", "tdax.decoder"]
    capture, visual, decoder = ranges
    assert _inside(visual, capture) and _inside(decoder, capture)
    assert visual[2] <= decoder[1]


def test_remat_step_records_decoder_backward_clip_in_order():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _train_step()
    ranges = _ranges(prof)
    # one decoder range: the block loop, not each block, and not remat's replay
    assert [r[0] for r in ranges] == ["tdax.train_step", "tdax.decoder", "tdax.backward",
                                      "tdax.clip"]
    step, decoder, backward, clip = ranges
    assert all(_inside(r, step) for r in (decoder, backward, clip))
    assert decoder[2] <= backward[1] and backward[2] <= clip[1]
    # the clip ends before torch.optim's step begins
    opt = [e for e in prof.events() if e.name.startswith("Optimizer.step")]
    assert opt and all(clip[2] <= e.time_range.start for e in opt)


def test_profiler_changes_no_value(params):
    plain = _capture(params)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = _capture(params)
    assert torch.equal(plain, traced)
    p_plain, loss_plain = _train_step()
    with profile(activities=[ProfilerActivity.CPU]):
        p_traced, loss_traced = _train_step()
    assert torch.equal(loss_plain, loss_traced)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(p_plain), _leaves(p_traced)))


def test_no_record_function_without_a_profiler(params, monkeypatch):
    calls = []
    real = torch.profiler.record_function

    def counted(name, *args):
        calls.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    assert log.span("x") is log.span("y")  # one shared no-op context
    _capture(params)
    _train_step()
    assert calls == []
    with profile(activities=[ProfilerActivity.CPU]):
        _capture(params)
    assert calls == ["tdax.capture", "tdax.visual", "tdax.decoder"]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    ds = DatasetConfig(data_dir=str(tmp_path_factory.mktemp("spans") / "d"))
    return generate_dataset(ds)[:5]


def _events(path) -> list:
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_extract_logs_each_batch(dataset, tmp_path, monkeypatch):
    log_path = tmp_path / "events.jsonl"
    monkeypatch.setenv("TDAX_LOG", str(log_path))
    extract_activations(dataset, str(tmp_path / "a.pt"), CFG,
                        ExtractConfig(model_dir=None, batch_size=2), device="cpu",
                        verbose=False)
    events = [e for e in _events(log_path) if e["event"] == "extract_batch"]
    assert [(e["batch"], e["samples"]) for e in events] == [(0, 2), (1, 2), (2, 1)]
    d2h = CFG.num_layers * 2 * CFG.hidden_size * 4  # the padded batch, f32
    image = 3 * CFG.visual.image_size ** 2 * 4
    for e in events:
        assert e["d2h_bytes"] == d2h
        # ids, mask, last index, images, image positions of two rows
        seq = (e["h2d_bytes"] - 2 * (8 + image + 8 * CFG.visual.n_queries)) // (2 * 12)
        assert e["h2d_bytes"] == 2 * (12 * seq + 8 + image + 8 * CFG.visual.n_queries)
        assert seq > 0 and seq % 64 == 0
        assert e["wait_s"] >= 0


def test_extract_records_its_ranges(dataset, tmp_path):
    every_thread = _ExperimentalConfig(profile_all_threads=True)
    with profile(activities=[ProfilerActivity.CPU], experimental_config=every_thread) as prof:
        extract_activations(dataset, str(tmp_path / "a.pt"), CFG,
                            ExtractConfig(model_dir=None, batch_size=2, save_interval=4),
                            device="cpu", verbose=False)
    ranges = _ranges(prof)
    names = [r[0] for r in ranges]
    for name in ("tdax.h2d", "tdax.capture", "tdax.readout"):
        assert names.count(name) == 3, name
    assert names.count("tdax.host_prep") == 3
    assert names.count("tdax.write") == 2  # the .tmp.npz, then the .pt with its .npz
    main = {r[3] for r in ranges if r[0] == "tdax.capture"}
    assert {r[3] for r in ranges if r[0] == "tdax.host_prep"}.isdisjoint(main)


def test_kernel_build_logs_each_build(tmp_path, monkeypatch):
    """A stand-in compiler writes the library; each build is one event."""
    fake = tmp_path / "nvcc"
    fake.write_text(f"#!{sys.executable}\nimport sys\n"
                    "open(sys.argv[sys.argv.index('-o') + 1], 'wb').close()\n")
    fake.chmod(fake.stat().st_mode | stat.S_IXUSR)
    log_path = tmp_path / "events.jsonl"
    monkeypatch.setenv("TDAX_LOG", str(log_path))
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setattr(_build, "BUILD_SECONDS", {})
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: path)
    _build.build(["qmm", "sqdist"])
    _build.build(["qmm"])  # built: no second event
    events = _events(log_path)
    assert sorted(e["name"] for e in events) == ["qmm", "sqdist"]
    assert all(e["event"] == "kernel_build" and e["seconds"] >= 0 for e in events)
    assert {e["name"]: e["seconds"] for e in events} == {
        n: round(s, 3) for n, s in _build.BUILD_SECONDS.items()}
    assert os.path.exists(_build._target("qmm"))
