"""The port's ``tdax.*`` spans read through ``benchmark.trace.Trace`` on
synthetic Chrome-trace events (each kernel's launch, the span it belongs
to, the five span metrics), every reader on traces with and without the
spans, and each cell's spans on the CPU at the tiny size."""

import types

import pytest

from benchmark import program_spans, spec, work
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


# what the five span readers read on the synthetic traces, ms a unit
SPAN_READINGS = {
    "capture": {"visual_ms": 1.0, "decoder_ms": 1.7, "backward_ms": None, "clip_ms": None,
                # inside [1010, 3990] the device runs from 1500 on
                "program_idle_ms": 0.49},
    "train": {"visual_ms": None, "decoder_ms": 1.5, "backward_ms": 3.3, "clip_ms": 0.6,
              # [100, 9000] less [400, 1900], [1900, 1920], [1950, 2000],
              # [2600, 5900], [6300, 6900] and [7300, 8700]
              "program_idle_ms": (8900 - 1500 - 20 - 50 - 3300 - 600 - 1400) / 1e3},
}


def _traces(kind, with_spans=True):
    md = work.model(spec.cell("qwen-vl-chat.capture").config)
    if kind == "capture":
        return Trace(capture_events(with_spans)), work.capture_batch(md, 16, 320), 2
    return Trace(train_events(with_spans)), work.train_step(md, 4, 1024, True), 1


def _read(trace, unit_work, units, names):
    ctx = types.SimpleNamespace(trace=trace, work=unit_work, units=units)
    return {m: spec.layer_reader(m).read(ctx) for m in names}


@pytest.mark.parametrize("kind", ["capture", "train"])
def test_span_readers(kind):
    tr, unit_work, units = _traces(kind)
    got = _read(tr, unit_work, units, program_spans.READINGS)
    for metric, want in SPAN_READINGS[kind].items():
        assert got[metric] == (None if want is None else pytest.approx(want)), metric


def test_each_kernel_tied_to_its_launch():
    tr = Trace(train_events())
    by_name = {op.name: op for op in tr.ops}
    bwd = by_name["flash_bwd_dq_sm90"]
    assert (bwd.launch_at, bwd.launch_tid, bwd.span) == (pytest.approx(2500e-6), AUTOGRAD,
                                                         "backward")
    img = by_name["copy_kernel"]
    assert (img.launch_at, img.launch_tid, img.span) == (pytest.approx(500e-6), IMAGES, None)
    # every device operation is clipped to the window and keeps its launch
    assert all(op.launch_at is not None for op in tr.ops)


def test_capture_spans():
    tr = Trace(capture_events())
    assert tr.span_names() == ["capture", "decoder", "visual"]
    assert tr.span_kernel_s("visual") == pytest.approx(2 * 1000e-6)
    assert tr.span_kernel_s("capture") == pytest.approx(2 * 100e-6)  # the embedding kernel
    assert tr.span_kernel_s(None) == 0  # the copies are no kernels
    assert tr.span_idle_s("capture") == pytest.approx(2 * 490e-6)
    assert {n: tr.span_count(n) for n in tr.span_names()} == {
        "capture": 2, "decoder": 2, "visual": 2}


def test_innermost_range_and_the_threads_own_ranges():
    tr = Trace(train_events())
    # the decoder's kernel is the decoder's, not the step's that holds it;
    # the step holds the kernel between the decoder and the backward, and
    # AdamW's, launched under no nested span
    assert tr.span_kernel_s("train_step") == pytest.approx(50e-6 + 1400e-6)
    # the image thread's launch belongs to none of the main thread's ranges
    assert tr.span_kernel_s(None) == pytest.approx(20e-6)
    # the image thread's range is one the window holds
    assert tr.span_count("host_prep") == 1


def test_span_count_is_of_ranges_inside_the_window():
    ev = [ann("bench.window", 1000, 5000), ann("tdax.decoder", 500, 1000),
          ann("tdax.decoder", 1500, 1000), ann("tdax.decoder", 2600, 100),
          ann("tdax.decoder", 5500, 1000)]
    assert Trace(ev).span_count("decoder") == 2


def test_no_spans_read_nothing():
    for kind in ("capture", "train"):
        tr, unit_work, units = _traces(kind, with_spans=False)
        assert tr.span_names() == []
        assert set(_read(tr, unit_work, units, program_spans.READINGS).values()) == {None}


@pytest.mark.parametrize("kind", ["capture", "train"])
def test_harness_readers_unchanged_by_program_spans(kind):
    """Every reader on the same events with and without the port's
    spans: the span readers read nothing without them and the spans with
    them; every other reader reads the same."""
    plain, unit_work, units = _traces(kind, with_spans=False)
    spanned, _, _ = _traces(kind)
    p = _read(plain, unit_work, units, READERS)
    s = _read(spanned, unit_work, units, READERS)
    assert set(program_spans.READINGS) <= set(READERS)
    for metric in READERS:
        if metric in program_spans.READINGS:
            want = SPAN_READINGS[kind][metric]
            assert p[metric] is None, metric
            assert s[metric] == (None if want is None else pytest.approx(want)), metric
        else:
            assert p[metric] == s[metric], metric
    assert any(p[m] is not None for m in READERS)
    assert plain.top_ops(10) == spanned.top_ops(10)
    assert plain.idle_gaps(10) == spanned.idle_gaps(10)
    assert (plain.busy_s(), plain.window_s) == (spanned.busy_s(), spanned.window_s)
    assert plain.kernel_s(None) == spanned.kernel_s(None)


@pytest.mark.parametrize("name", CELLS)
def test_cell_spans_on_the_cpu(name):
    """A cell's traced units at the tiny size: the spans its job declares
    are in the trace; with no device operation every reading is None."""
    cell = tiny_cell(name)
    out = program_spans.report(cell, 2 ** 31 + 5, "cpu")
    assert set(spec.job(cell.job).SPANS) <= set(out["kernel_ms_by_span"])
    assert all(out["ranges_by_span"][n] == cell.traffic["trace_units"]
               for n in spec.job(cell.job).SPANS)
    assert set(out["program_spans"].values()) == {None}
    assert out["device"] == "cpu" and out["busy_ms"] == 0
