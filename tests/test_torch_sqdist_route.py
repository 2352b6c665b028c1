"""Which sqdist kernel the port picks, the split pass's plain version, and
the 3xTF32 arithmetic of the Hopper kernel.  CPU only: ``_route`` reads
the type, shapes, strides and alignment, never the data (meta tensors
stand in for the scale path's [10000, 4096]); ``tf32_split_plain`` is the
split pass's plain version, which the kernel must equal bitwise on the
card (``tests/test_torch_sqdist_cuda.py``, ``chip_smoke.py``); the
product's arithmetic (hi.hi^T + hi.lo^T + lo.hi^T, emulated here in f64)
is held against tdax's Pallas kernel in interpret mode under
``tests/test_torch_scale.py``'s bound, 1e-5 (|x_i|^2 + |x_j|^2).
"""

import importlib.util
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from tdax.ops.pallas_distances import pairwise_sq_euclidean_pallas as j_sq_pallas

from tdax_torch.ops import _build
from tdax_torch.ops import sqdist



def _root_module(name):
    spec = importlib.util.spec_from_file_location(
        name, Path(__file__).resolve().parents[1] / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


chip_smoke = _root_module("chip_smoke")
probe_sqdist = _root_module("probe_sqdist")

SHAPES = [(36, 3), (100, 17), (130, 257), (40, 4096)]  # tests/test_torch_scale.py


def _meta(n, d):
    return torch.empty((n, d), dtype=torch.float32, device="meta")


def _scale():
    return _meta(10_000, 4096)


# layouts TMA cannot read from x itself, at n rows: the split pass reads
# them, so the row count alone routes them
def _d4097(n=10_000):
    return _meta(n, 4097)


def _stride4097(n=256):  # a column slice whose row stride is not a multiple of 4
    return torch.empty((n, 4097))[:, :4096]


def _off_grid(n=256):  # a base 4 bytes past a 16-byte boundary
    return torch.empty(n * 4096 + 4)[1:1 + n * 4096].view(n, 4096)


def _short(n=sqdist.SM90_MIN_N - 1):  # fewer rows than the Hopper kernel's tile
    return _meta(n, 4096)


def _broadcast(n=256):  # one row over n: stride 0
    return torch.empty((1, 4096)).expand(n, 4096)


LAYOUTS = [_d4097, _stride4097, _off_grid, _short, _broadcast]
LAYOUT_IDS = ["d4097", "stride4097", "off_grid", "n_short", "broadcast"]


def test_the_scale_path_takes_the_hopper_kernel():
    assert chip_smoke.SCALE_N >= sqdist.SM90_MIN_N
    assert sqdist._route(_meta(chip_smoke.SCALE_N, chip_smoke.SCALE_D)) == "sm90"


@pytest.mark.parametrize("make", LAYOUTS, ids=LAYOUT_IDS)
def test_everything_else_takes_the_fma_kernel(make):
    """Below SM90_MIN_N rows every layout takes sqdist.cu."""
    assert sqdist._route(make(sqdist.SM90_MIN_N - 1)) == "fma"


@pytest.mark.parametrize("make", LAYOUTS, ids=LAYOUT_IDS)
def test_every_layout_with_enough_rows_takes_the_hopper_kernel(make):
    """The precision of a call does not hang on its input's layout: from
    SM90_MIN_N rows an odd d, an odd row stride, an unaligned base and a
    broadcast row all take sqdist_sm90.cu, as their contiguous copies do."""
    assert sqdist._route(make(sqdist.SM90_MIN_N)) == "sm90"
    assert sqdist._route(make(1000)) == "sm90"


@pytest.mark.parametrize("n,d", [(128, 4096), (129, 4096), (1000, 4100), (1001, 332)])
def test_ragged_n_and_d_off_the_tile_take_the_hopper_kernel(n, d):
    assert sqdist._route(_meta(n, d)) == "sm90"


def test_an_aligned_strided_view_takes_the_hopper_kernel():
    x = torch.empty((300, 4104))[:, 4:4100]
    assert x.stride(0) == 4104 and x.data_ptr() % 16 == 0
    assert sqdist._route(x) == "sm90"


@pytest.mark.parametrize("forced,make,want", [
    (None, _scale, "sm90"), ("fma", _scale, "fma"), ("sm90", _scale, "sm90"),
    ("fma", _d4097, "fma"), ("sm90", _short, "sm90"), (None, _short, "fma"),
], ids=["route", "fma_forced", "sm90_forced", "fma_on_odd_d", "sm90_below_min_n",
        "route_below_min_n"])
def test_the_private_kernel_choice(forced, make, want):
    assert sqdist._pick(make(), forced) == want


@pytest.mark.parametrize("make", [_d4097, _stride4097, _off_grid, _broadcast],
                         ids=["d4097", "stride4097", "off_grid", "broadcast"])
def test_forcing_either_kernel_takes_any_layout(make):
    assert sqdist._pick(make(), "sm90") == "sm90"
    assert sqdist._pick(make(), "fma") == "fma"


def test_an_unknown_kernel_raises():
    with pytest.raises(ValueError, match="unknown kernel"):
        sqdist._pick(_scale(), "wgmma")


@pytest.mark.parametrize("kernel", [None, "fma", "sm90"])
def test_the_wrappers_refuse_cpu_tensors_before_any_launch(kernel):
    x = torch.zeros((256, 64))
    assert sqdist._route(x) == "sm90"
    before = (sqdist.LAUNCHES, sqdist.LAUNCHES_SM90, sqdist.SPLIT_LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        sqdist.pairwise_sq_euclidean_cuda(x, _kernel=kernel)
    with pytest.raises(ValueError, match="CUDA"):
        sqdist.tf32_split_cuda(x)
    assert (sqdist.LAUNCHES, sqdist.LAUNCHES_SM90, sqdist.SPLIT_LAUNCHES) == before


# (f32 bits, tf32 bits): round to nearest, ties away from zero
TF32_TABLE = [
    (0x3F800000, 0x3F800000),  # 1.0
    (0x3F800FFF, 0x3F800000),  # just below half a place: down
    (0x3F801000, 0x3F802000),  # a tie, even below: away from zero
    (0x3F803000, 0x3F804000),  # a tie, odd below: away from zero
    (0x3F801001, 0x3F802000),  # just above half a place: up
    (0xBF801000, 0xBF802000),  # a negative tie: away from zero
    (0xBF800FFF, 0xBF800000),  # a negative value: toward zero
    (0x3FFFF000, 0x40000000),  # the mantissa carries into the exponent: 2.0
    (0xBFFFFFFF, 0xC0000000),  # -1.99999988 -> -2.0
    (0x7F7FF000, 0x7F800000),  # past the largest tf32: infinity
    (0x00000000, 0x00000000),  # +0
    (0x80000000, 0x80000000),  # -0
    (0x7F800000, 0x7F800000),  # infinity
]


def _bits(v):
    return torch.tensor([v], dtype=torch.int64).to(torch.int32).view(torch.float32)


@pytest.mark.parametrize("x_bits,hi_bits", TF32_TABLE, ids=[f"{a:08x}" for a, _ in TF32_TABLE])
def test_tf32_rounding_of_bit_patterns(x_bits, hi_bits):
    x = _bits(x_bits)
    hi, lo, _ = sqdist.tf32_split_plain(x[None])
    hi, lo = hi[:, :1], lo[:, :1]  # the split pads d = 1 to 4 columns
    assert int(hi.view(torch.int32)[0, 0]) & 0xFFFFFFFF == hi_bits
    if torch.isfinite(hi).all():
        # x - hi is exact and within half a tf32 place; lo is its tf32
        r = x.double() - hi.double()[0]
        assert abs(float(r)) <= 2.0 ** -11 * abs(float(hi.double()[0])) + 1e-45
        assert torch.equal(lo[0], sqdist._tf32_rna(x - hi[0]))


def test_split_low_bits_zero_and_residual_bound():
    x = torch.as_tensor(np.random.default_rng(3).normal(size=(257, 1001)).astype(np.float32))
    x[0, :4] = torch.tensor([1e30, -1e-30, 3.0, -0.75])
    hi, lo, sq = sqdist.tf32_split_plain(x)
    assert hi.dtype == lo.dtype == torch.float32 and hi.is_contiguous() and lo.is_contiguous()
    assert hi.shape == lo.shape == (257, 1004)  # d rounded up to 4, the pad zero
    assert not hi[:, 1001:].any() and not lo[:, 1001:].any()
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((lo.view(torch.int32) & 0x1FFF) == 0).all()
    hi, lo = hi[:, :1001], lo[:, :1001]
    resid = (x.double() - hi.double() - lo.double()).abs()
    assert (resid <= 2.0 ** -22 * x.double().abs()).all()
    torch.testing.assert_close(sq, (x * x).sum(1), rtol=0, atol=0)


def test_split_of_a_strided_view_equals_the_contiguous_copy():
    base = torch.as_tensor(np.random.default_rng(4).normal(size=(60, 72)).astype(np.float32))
    view = base[:, 4:68]
    for got, want in zip(sqdist.tf32_split_plain(view),
                         sqdist.tf32_split_plain(view.contiguous())):
        assert torch.equal(got, want)


def test_split_of_a_strided_odd_d_view_is_padded_and_equals_the_contiguous_copy():
    """What the split pass gives for any layout (tests/test_torch_sqdist_cuda.py
    and chip_smoke.py hold the kernel to it bitwise): an odd d read at an
    odd row stride from an offset base, padded to d rounded up to 4, equal
    to the split of its contiguous copy."""
    base = torch.as_tensor(np.random.default_rng(6).normal(size=(40 * 141 + 3,)).astype(
        np.float32))
    view = base[3:].view(40, 141)[:, 2:135]
    assert view.shape == (40, 133) and view.stride() == (141, 1)
    assert view.storage_offset() % 4 != 0
    got, want = sqdist.tf32_split_plain(view), sqdist.tf32_split_plain(view.contiguous())
    assert got[0].shape == got[1].shape == (40, 136)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(got[0][:, :133], sqdist._tf32_rna(view))


def _sq_3xtf32(x: np.ndarray) -> np.ndarray:
    """The Hopper kernel's arithmetic on the CPU: the split, then hi.hi^T
    and hi.lo^T + lo.hi^T with exact products summed in f64, the norms in
    f32, clamped at 0."""
    hi, lo, sq = (t.double() for t in sqdist.tf32_split_plain(torch.as_tensor(x)))
    big = hi @ hi.T
    small = hi @ lo.T + lo @ hi.T
    out = (sq[:, None] + sq[None, :] - 2.0 * (big + small)).clamp_min(0.0)
    return out.numpy()


def _scale_tol(x: np.ndarray) -> np.ndarray:  # tests/test_torch_scale.py
    sq = (x.astype(np.float64) ** 2).sum(1)
    return 1e-5 * (sq[:, None] + sq[None, :])


def _scale_recipe(n: int) -> np.ndarray:
    """chip_smoke.scale_cloud's recipe (bench_scale.py:36-40) at n points."""
    rng = np.random.default_rng(42)
    z = rng.normal(size=(n, 4))
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    proj = rng.normal(size=(4, chip_smoke.SCALE_D)) / np.sqrt(4)
    return (z @ proj + rng.normal(0, 1e-3, (n, chip_smoke.SCALE_D))).astype(np.float32)


@pytest.mark.parametrize("n,d", SHAPES)
def test_3xtf32_arithmetic_matches_pallas_interpret(n, d):
    x = np.random.default_rng(0).normal(size=(n, d)).astype(np.float32)
    ref = np.asarray(j_sq_pallas(x, interpret=True))
    got = _sq_3xtf32(x)
    assert (np.abs(got - ref) <= _scale_tol(x)).all()


def test_3xtf32_arithmetic_matches_pallas_interpret_on_the_scale_cloud():
    x = _scale_recipe(512)
    ref = np.asarray(j_sq_pallas(x, interpret=True))
    got = _sq_3xtf32(x)
    assert (np.abs(got - ref) <= _scale_tol(x)).all()
    # and the emulation's own error against f64 stays far inside the bound
    x64 = x.astype(np.float64)
    sq = (x64 ** 2).sum(1)
    exact = np.maximum(sq[:, None] + sq[None, :] - 2.0 * x64 @ x64.T, 0.0)
    assert (np.abs(got - exact) <= 0.1 * _scale_tol(x)).all()


def test_build_and_smoke_name_the_hopper_source():
    assert _build.SOURCES["sqdist_sm90"] == "sqdist_sm90.cu"
    assert (_build.CSRC / "sqdist_sm90.cu").exists()
    assert "sqdist_sm90" in chip_smoke.SM90_SOURCES


def test_library_hash_of_the_hopper_sqdist_covers_sm90_cuh(tmp_path, monkeypatch):
    """An edit to sm90.cuh must rename the Hopper sqdist library (else a
    stale build would load), and leave sqdist.cu's, which does not include
    it."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {n: _build._target(n) for n in ("sqdist_sm90", "sqdist")}
    header = csrc / "sm90.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build._target("sqdist_sm90") != before["sqdist_sm90"]
    assert _build._target("sqdist") == before["sqdist"]
    src = csrc / "sqdist_sm90.cu"
    moved = _build._target("sqdist_sm90")
    src.write_text(src.read_text() + "\n// edited\n")
    assert _build._target("sqdist_sm90") != moved


@pytest.mark.parametrize("name", list(probe_sqdist.VARIANTS))
def test_every_probe_variant_applies_to_the_hopper_source(name):
    """Each substitution of probe_sqdist.py still finds its text once."""
    text = probe_sqdist.SOURCE.read_text()
    subs, _ = probe_sqdist.VARIANTS[name]
    assert (_build.substitute(text, subs) == text) == (name == "base")


def test_substitute_needs_each_text_exactly_once():
    assert _build.substitute("a b c", [("b", "x"), ("c", "y")]) == "a x y"
    with pytest.raises(ValueError, match="found 0 times"):
        _build.substitute("a b c", [("d", "x")])
    with pytest.raises(ValueError, match="found 2 times"):
        _build.substitute("a b b", [("b", "x")])


def test_build_variants_reports_a_failed_build_and_leaves_it_out(tmp_path, monkeypatch):
    """A variant nvcc refuses is reported with ptxas's and the error's
    lines and not loaded; its source text lands in the output folder."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'ptxas info    : Used 40 registers'\n"
                    "echo 'some.cu(1): error: broken' >&2\necho 'other output'\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    declared = []
    libs, reports = _build.build_variants({"broken": "// text\n"}, tmp_path / "out",
                                          declared.append)
    assert libs == {} and declared == []
    assert reports == {"broken": {"built": False,
                                  "ptxas": ["ptxas info    : Used 40 registers",
                                            "some.cu(1): error: broken"]}}
    assert (tmp_path / "out" / "broken.cu").read_text() == "// text\n"
