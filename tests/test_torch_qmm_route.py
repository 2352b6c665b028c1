"""Which kernel the port's int8 matmul picks, and what the Hopper kernel
library's build hash covers.  CPU only: ``_route`` reads the type,
shapes, strides and alignment, never the data (meta tensors stand in for
the full-width sites), and ``_build._target`` hashes files.  The kernels
themselves are held against the plain version on the card
(``tests/test_torch_qmm_cuda.py``, ``chip_smoke.py``).
"""

import importlib.util
import shutil
from pathlib import Path

import pytest
import torch

import tdax_torch.ops.quant_matmul as qm
from tdax_torch.ops import _build

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
_spec = importlib.util.spec_from_file_location(
    "probe_qmm", Path(__file__).resolve().parents[1] / "probe_qmm.py")
probe_qmm = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(probe_qmm)

# (site, M, K, N) of the int8 capture and of generate's prefill (the same
# products), and of a decode step
CAPTURE_SITES = [s[:4] for s in chip_smoke.QMM_SITES if s[4] > 0]
DECODE_SITES = [s[:4] for s in chip_smoke.QMM_SITES if s[5] > 0]


def _meta(m, k, n, dtype=torch.bfloat16):
    """x [m, k], q [k, n] int8 and s [n] f32 on the meta device (base 0)."""
    return (torch.empty((m, k), dtype=dtype, device="meta"),
            torch.empty((k, n), dtype=torch.int8, device="meta"),
            torch.empty((n,), dtype=torch.float32, device="meta"))


@pytest.mark.parametrize("site,m,k,n", [s for s in CAPTURE_SITES if s[0] != "vit.patch_w"],
                         ids=lambda v: v if isinstance(v, str) else None)
def test_capture_and_prefill_sites_take_the_hopper_kernel(site, m, k, n):
    assert m >= qm.SM90_MIN_M
    assert qm._route(*_meta(m, k, n)) == "sm90"


def test_the_patch_embedding_takes_the_mma_kernel():
    """K = 588: a row of x is 1176 bytes, not a multiple of 16, so TMA
    cannot read it."""
    (site,) = [s for s in CAPTURE_SITES if s[0] == "vit.patch_w"]
    assert site[2] % 8
    assert qm._route(*_meta(*site[1:])) == "mma"


def test_the_sites_split_358_and_1_a_capture_batch():
    calls = {r: 0 for r in ("sm90", "mma")}
    for name, m, k, n, per_batch, _ in chip_smoke.QMM_SITES:
        calls[qm._route(*_meta(m, k, n))] += per_batch
    assert calls == {"sm90": chip_smoke.QMM_PER_CAPTURE_BATCH - 1, "mma": 1}


@pytest.mark.parametrize("site,m,k,n", DECODE_SITES,
                         ids=lambda v: v if isinstance(v, str) else None)
def test_decode_sites_take_the_mma_kernel(site, m, k, n):
    assert m < qm.SM90_MIN_M
    assert qm._route(*_meta(m, k, n)) == "mma"


def _f32():
    return _meta(512, 1664, 4992, torch.float32)


def _short():  # one row fewer than the Hopper kernel's block takes
    return _meta(qm.SM90_MIN_M - 1, 4096, 4096)


def _k588():
    return _meta(16384, 588, 1664)


def _n_ragged():  # N % 16 != 0: the weight's rows are not 16-byte strides
    return _meta(256, 1664, 1000)


def _x_misaligned():  # x's base 2 bytes past a 16-byte boundary
    flat = torch.empty(256 * 1664 + 8, dtype=torch.bfloat16)
    x = flat[1:1 + 256 * 1664].view(256, 1664)
    return x, torch.empty((1664, 512), dtype=torch.int8), torch.empty(512)


def _q_misaligned():
    flat = torch.empty(1664 * 512 + 16, dtype=torch.int8)
    return (torch.empty((256, 1664), dtype=torch.bfloat16),
            flat[4:4 + 1664 * 512].view(1664, 512), torch.empty(512))


def _s_misaligned():
    return (torch.empty((256, 1664), dtype=torch.bfloat16),
            torch.empty((1664, 512), dtype=torch.int8), torch.empty(516)[2:514])


def _x_strided():  # a column slice whose row stride (1668) is not a multiple of 8
    x = torch.empty((256, 1668), dtype=torch.bfloat16)[:, :1664]
    return x, torch.empty((1664, 512), dtype=torch.int8), torch.empty(512)


def _x_broadcast():  # one row over 256: stride 0 is not a tensor map's
    x = torch.empty((1, 1664), dtype=torch.bfloat16).expand(256, 1664)
    return x, torch.empty((1664, 512), dtype=torch.int8), torch.empty(512)


@pytest.mark.parametrize("make", [_f32, _short, _k588, _n_ragged, _x_misaligned, _q_misaligned,
                                  _s_misaligned, _x_strided, _x_broadcast],
                         ids=["f32", "decode_m127", "k588", "n_ragged", "x_misaligned",
                              "q_misaligned", "s_misaligned", "x_strided", "x_broadcast"])
def test_everything_else_takes_the_mma_kernel(make):
    assert qm._route(*make()) == "mma"


def test_an_aligned_column_slice_takes_the_hopper_kernel():
    """A view of a fused projection whose row stride and base are 16-byte
    aligned is read in place."""
    fused = torch.empty((256, 3 * 1664), dtype=torch.bfloat16)
    x = fused[:, 1664:2 * 1664]
    assert x.stride(0) == 3 * 1664
    assert qm._route(x, torch.empty((1664, 512), dtype=torch.int8), torch.empty(512)) == "sm90"


@pytest.mark.parametrize("forced,make,want", [
    (None, lambda: _meta(512, 1664, 4992), "sm90"),
    ("mma", lambda: _meta(512, 1664, 4992), "mma"),
    ("sm90", lambda: _meta(512, 1664, 4992), "sm90"),
    ("mma", _short, "mma"),
    (None, _k588, "mma"),
], ids=["route", "mma_forced", "sm90_where_routed", "mma_on_decode", "route_k588"])
def test_the_private_kernel_choice(forced, make, want):
    assert qm._pick(*make(), forced) == want


@pytest.mark.parametrize("make", [_f32, _short, _k588, _x_misaligned],
                         ids=["f32", "decode_m127", "k588", "x_misaligned"])
def test_forcing_the_hopper_kernel_where_the_route_does_not_raises(make):
    with pytest.raises(ValueError, match="sm90 kernel does not take"):
        qm._pick(*make(), "sm90")


def test_the_wrapper_refuses_cpu_tensors_before_any_route():
    x, q, s = (torch.zeros((256, 1664), dtype=torch.bfloat16),
               torch.zeros((1664, 512), dtype=torch.int8), torch.ones(512))
    assert qm._route(x, q, s) == "sm90"
    before = (qm.LAUNCHES, qm.LAUNCHES_SM90)
    for forced in (None, "mma", "sm90"):
        with pytest.raises(ValueError, match="CUDA"):
            qm.quant_matmul(x, q, s, _kernel=forced)
    assert (qm.LAUNCHES, qm.LAUNCHES_SM90) == before


def test_library_hash_covers_sm90_header(tmp_path, monkeypatch):
    """An edit to sm90.cuh must rename the Hopper qmm library (else a stale
    build would load), and leave qmm.cu's, which does not include it."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    assert _build.SOURCES["qmm_sm90"] == "qmm_sm90.cu"
    before = {n: _build._target(n) for n in ("qmm_sm90", "qmm")}
    header = csrc / "sm90.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build._target("qmm_sm90") != before["qmm_sm90"]
    assert _build._target("qmm") == before["qmm"]
    src = csrc / "qmm_sm90.cu"
    moved = _build._target("qmm_sm90")
    src.write_text(src.read_text() + "\n// edited\n")
    assert _build._target("qmm_sm90") != moved


@pytest.mark.parametrize("name", list(probe_qmm.VARIANTS))
def test_every_probe_variant_applies_to_the_hopper_source(name):
    """Each substitution of probe_qmm.py still finds its text once."""
    text = probe_qmm.SOURCE.read_text()
    subs, _ = probe_qmm.VARIANTS[name]
    assert (_build.substitute(text, subs) == text) == (name == "base")
