"""``benchmark.program_spans`` on synthetic Chrome-trace events, the
harness's readers unchanged by the port's ``tdax.*`` ranges, and the
spans' report of each cell on the CPU at the tiny size."""

import types

import pytest

from benchmark import program_spans, spec, work
from benchmark.program_spans import ProgramSpans
from benchmark.rehearse import tiny_cell
from benchmark.trace import Trace

CELLS = [w["name"] for w in spec.load()["workloads"]]
READERS = [m["name"] for m in spec.load()["per_layer"]]
MAIN, AUTOGRAD, IMAGES = 1, 2, 3


def ann(name, ts, dur, tid=MAIN):
    return {"cat": "user_annotation", "ph": "X", "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid}


def launched(name, corr, at, start, dur, tid=MAIN, cat="kernel"):
    """A launch on host thread ``tid`` at ``at`` and its device operation."""
    return [{"cat": "cuda_runtime", "ph": "X", "name": "cudaLaunchKernel", "ts": at, "dur": 2,
             "pid": 1, "tid": tid, "args": {"correlation": corr}},
            {"cat": cat, "ph": "X", "name": name, "ts": start, "dur": dur, "pid": 0, "tid": 7,
             "args": {"correlation": corr}}]


def capture_events(with_spans=True) -> list:
    """Two capture batches of 5000 us each: h2d, the forward (the visual
    tower, the decoder, one embedding kernel between them), readout."""
    ev = [ann("bench.window", 0, 10000)]
    for u in range(2):
        t, c = 5000 * u, 10 * u
        ev += [ann("bench.h2d", t, 1000), ann("bench.forward", t + 1000, 3000),
               ann("bench.readout", t + 4000, 600)]
        if with_spans:
            ev += [ann("tdax.capture", t + 1010, 2980), ann("tdax.visual", t + 1020, 980),
                   ann("tdax.decoder", t + 2010, 1970)]
        ev += launched("Memcpy HtoD", c + 1, t + 50, t + 100, 800, cat="gpu_memcpy")
        ev += launched("flash_fwd_sm90_kernel", c + 2, t + 1100, t + 1500, 1000)
        ev += launched("nvjet_tst_192x192", c + 3, t + 2100, t + 2500, 1700)
        ev += launched("elementwise_kernel_128", c + 4, t + 2005, t + 4200, 100)
        ev += launched("Memcpy DtoH", c + 5, t + 4010, t + 4300, 200, cat="gpu_memcpy")
    return ev


def train_events(with_spans=True) -> list:
    """One remat step: the forward's decoder, the backward launched from
    autograd's thread, the clip, AdamW; the image thread's own range."""
    ev = [ann("bench.window", 0, 10000), ann("bench.step", 100, 8900),
          ann("Optimizer.step#AdamW.step", 7100, 1700)]
    if with_spans:
        ev += [ann("tdax.train_step", 100, 8900), ann("tdax.decoder", 200, 1800),
               ann("tdax.backward", 2100, 3900), ann("tdax.clip", 6100, 900),
               ann("tdax.host_prep", 100, 50, tid=IMAGES)]
    ev += launched("flash_fwd_sm90_kernel", 10, 300, 400, 1500)
    ev += launched("vectorized_elementwise_kernel", 11, 2050, 1950, 50)  # in train_step alone
    ev += launched("flash_bwd_dq_sm90", 12, 2500, 2600, 1400, tid=AUTOGRAD)
    ev += launched("nvjet_tst_256x128", 13, 5000, 4000, 1900, tid=AUTOGRAD)
    ev += launched("reduce_kernel", 14, 6200, 6300, 600)
    ev += launched("multi_tensor_apply_kernel", 15, 7200, 7300, 1400)
    # the image thread holds ranges: its launch inside the main thread's
    # decoder is not the decoder's
    ev += launched("copy_kernel", 16, 500, 1900, 20, tid=IMAGES)
    return ev


def test_capture_readings():
    ps = ProgramSpans(capture_events())
    r = ps.readings(2)
    assert r["visual_ms"] == pytest.approx(1.0)
    assert r["decoder_ms"] == pytest.approx(1.7)
    assert r["backward_ms"] is None and r["clip_ms"] is None
    # inside [1010, 3990] the device runs from 1500 on
    assert r["program_idle_ms"] == pytest.approx(0.49)
    assert ps.kernel_s("capture") == pytest.approx(2 * 100e-6)  # the embedding kernel
    assert ps.kernel_s(None) == 0  # the copies are no kernels


def test_train_readings_backward_from_another_thread():
    ps = ProgramSpans(train_events())
    r = ps.readings(1)
    assert r["visual_ms"] is None
    assert r["decoder_ms"] == pytest.approx(1.5)
    assert r["backward_ms"] == pytest.approx(3.3)
    assert r["clip_ms"] == pytest.approx(0.6)
    # [100, 9000] less [400, 1900], [1900, 1920], [1950, 2000], [2600, 5900],
    # [6300, 6900] and [7300, 8700]
    assert r["program_idle_ms"] == pytest.approx(
        (8900 - 1500 - 20 - 50 - 3300 - 600 - 1400) / 1e3)


def test_innermost_range_and_the_threads_own_ranges():
    ps = ProgramSpans(train_events())
    # the decoder's kernel is the decoder's, not the step's that holds it;
    # the step holds the kernel between the decoder and the backward, and
    # AdamW's, launched under no nested span
    assert ps.kernel_s("train_step") == pytest.approx(50e-6 + 1400e-6)
    # the image thread's launch belongs to none of the main thread's ranges
    assert ps.kernel_s(None) == pytest.approx(20e-6)


def test_no_spans_read_nothing():
    for events, units in ((capture_events(False), 2), (train_events(False), 1)):
        assert set(ProgramSpans(events).readings(units).values()) == {None}


def _readers(trace, unit_work, units):
    ctx = types.SimpleNamespace(trace=trace, work=unit_work, units=units)
    return {m: spec.layer_reader(m).read(ctx) for m in READERS}


@pytest.mark.parametrize("kind", ["capture", "train"])
def test_harness_readers_unchanged_by_program_spans(kind):
    md = work.model(spec.cell("qwen-vl-chat.capture").config)
    if kind == "capture":
        make, units, unit_work = capture_events, 2, work.capture_batch(md, 16, 320)
    else:
        make, units, unit_work = train_events, 1, work.train_step(md, 4, 1024, True)
    plain, spanned = Trace(make(False)), Trace(make(True))
    assert _readers(plain, unit_work, units) == _readers(spanned, unit_work, units)
    assert any(v is not None for v in _readers(plain, unit_work, units).values())
    assert plain.top_ops(10) == spanned.top_ops(10)
    assert plain.idle_gaps(10) == spanned.idle_gaps(10)
    assert (plain.busy_s(), plain.window_s) == (spanned.busy_s(), spanned.window_s)


@pytest.mark.parametrize("name", CELLS)
def test_cell_spans_on_the_cpu(name):
    """A cell's traced units at the tiny size: the port's spans are in the
    trace; with no device operation every reading is None."""
    out = program_spans.report(tiny_cell(name), 2 ** 31 + 5, "cpu")
    spans = set(out["kernel_ms_by_span"])
    want = {"train_step", "decoder", "backward", "clip"} if "finetune" in name else {
        "capture", "visual", "decoder"}
    assert want <= spans
    assert set(out["program_spans"].values()) == {None}
    assert out["device"] == "cpu" and out["busy_ms"] == 0
