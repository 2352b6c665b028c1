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
    calls = {r: 0 for r in ("sm90", "decode", "mma")}
    for name, m, k, n, per_batch, _ in chip_smoke.QMM_SITES:
        calls[qm._route(*_meta(m, k, n))] += per_batch
    assert calls == {"sm90": chip_smoke.QMM_PER_CAPTURE_BATCH - 1, "decode": 0, "mma": 1}


@pytest.mark.parametrize("site,m,k,n", DECODE_SITES,
                         ids=lambda v: v if isinstance(v, str) else None)
def test_decode_sites_take_the_mma_kernel(site, m, k, n):
    """Named for the kernel a decode step took before qmm_decode_sm90.cu:
    every decode site (M = 16) now takes the split-K decode kernel."""
    assert m <= qm.DECODE_MAX_M < qm.SM90_MIN_M
    assert qm._route(*_meta(m, k, n)) == "decode"


def test_a_decode_step_splits_161_products_on_the_decode_kernel():
    calls = {r: 0 for r in ("sm90", "decode", "mma")}
    for name, m, k, n, _, per_step in chip_smoke.QMM_SITES:
        calls[qm._route(*_meta(m, k, n))] += per_step
    assert calls == {"sm90": 0, "decode": chip_smoke.QMM_PER_DECODE_STEP, "mma": 0}


def _x_view(m, k, n, offset=0, ldx=None, dtype=torch.bfloat16):
    """x [m, k] as a view of a wider buffer: row stride ``ldx``, base
    ``offset`` elements in."""
    ldx = ldx or k
    flat = torch.empty(offset + m * ldx + 8, dtype=dtype)
    x = flat[offset:offset + m * ldx].view(m, ldx)[:, :k]
    return x, torch.empty((k, n), dtype=torch.int8), torch.empty(n)


@pytest.mark.parametrize("make,want", [
    (lambda: _meta(8, 4096, 4096), "decode"),          # a dp rank's rows at attn_proj
    (lambda: _meta(8, 4096, 6144), "decode"),          # and at a tp rank's qkv columns
    (lambda: _meta(16, 4096, 5504), "decode"),         # a tp rank's mlp w1 columns
    (lambda: _meta(1, 4096, 4096), "decode"),
    (lambda: _meta(64, 4096, 4096), "decode"),
    (lambda: _meta(40, 4104, 4112), "decode"),         # ragged M, K and N off the tiles
    (lambda: _meta(65, 4096, 4096), "mma"),            # 65 to 127 rows stay on qmm.cu
    (lambda: _meta(127, 4096, 4096), "mma"),
    (lambda: _meta(16, 4096, 4096, torch.float32), "mma"),
    (lambda: _meta(16, 588, 1664), "mma"),             # K % 8
    (lambda: _meta(16, 4096, 1000), "mma"),            # N % 16
    (lambda: _x_view(16, 4096, 4096, offset=1), "mma"),  # x 2 bytes off 16
    (lambda: _x_view(16, 4096, 4096, ldx=4100), "mma"),  # row stride % 8
    (lambda: _x_view(16, 4096, 4096, ldx=3 * 4096), "decode"),  # aligned column slice
    (lambda: (torch.empty((1, 4096), dtype=torch.bfloat16).expand(16, 4096),
              torch.empty((4096, 4096), dtype=torch.int8), torch.empty(4096)), "mma"),  # stride 0
], ids=["m8_proj", "m8_qkv_tp", "m16_w1_tp", "m1", "m64", "ragged40", "m65", "m127", "f32",
        "k588", "n1000", "x_misaligned", "x_ldx4100", "x_column_slice", "x_broadcast"])
def test_the_decode_route_at_the_edges(make, want):
    assert qm._route(*make()) == want


# (K tiles a split, splits) at each decode site on a 132-SM H100: about two
# blocks an SM, at least four K tiles a split; the LM head's 1187 column
# tiles need none
DECODE_SPLITS = {"decode.attn_qkv_w": (12, 3), "decode.attn_proj_w": (4, 8),
                 "decode.mlp_w1+w2": (11, 3), "decode.mlp_proj_w": (11, 8),
                 "decode.lm_head": (32, 1)}


@pytest.mark.parametrize("site,m,k,n", DECODE_SITES,
                         ids=lambda v: v if isinstance(v, str) else None)
def test_the_decode_split_at_every_decode_site(site, m, k, n):
    """The wrapper's split choice: no split empty, every K tile in one,
    the scratch [splits, M, N] f32 (none with one split) at most an eighth of
    the weight's bytes, at most ~2 blocks an SM unless the tiles alone are
    more."""
    per, splits = qm._decode_split(k, n, 132)
    assert (per, splits) == DECODE_SPLITS[site]
    k_tiles, n_tiles = -(-k // qm.DECODE_TILE), -(-n // qm.DECODE_TILE)
    assert per * splits >= k_tiles > per * (splits - 1)
    assert per >= min(qm.DECODE_MIN_K_TILES, k_tiles)
    scratch = splits * m * n * 4 if splits > 1 else 0
    assert scratch <= k * n / 8
    assert n_tiles * splits <= max(n_tiles, 2 * 132 * 1.1)


@pytest.mark.parametrize("k,n,sms", [(4104, 4112, 132), (8, 16, 132), (4096, 4096, 1),
                                     (11008, 4096, 78), (128 * 7, 128, 132)])
def test_the_decode_split_covers_k_with_no_empty_split(k, n, sms):
    per, splits = qm._decode_split(k, n, sms)
    k_tiles = -(-k // qm.DECODE_TILE)
    assert per * splits >= k_tiles > per * (splits - 1) and per >= 1


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
    (None, lambda: _meta(16, 4096, 4096), "decode"),
    ("mma", lambda: _meta(16, 4096, 4096), "mma"),
    ("decode", lambda: _meta(16, 4096, 4096), "decode"),
], ids=["route", "mma_forced", "sm90_where_routed", "mma_on_decode", "route_k588",
        "route_decode", "mma_forced_at_decode", "decode_where_routed"])
def test_the_private_kernel_choice(forced, make, want):
    assert qm._pick(*make(), forced) == want


@pytest.mark.parametrize("make", [_f32, _short, _k588, _x_misaligned],
                         ids=["f32", "decode_m127", "k588", "x_misaligned"])
def test_forcing_the_hopper_kernel_where_the_route_does_not_raises(make):
    with pytest.raises(ValueError, match="sm90 kernel does not take"):
        qm._pick(*make(), "sm90")


@pytest.mark.parametrize("make", [lambda: _meta(512, 1664, 4992), _short, _f32,
                                  lambda: _meta(16, 588, 1664)],
                         ids=["capture_site", "m127", "f32", "k588"])
def test_forcing_the_decode_kernel_where_the_route_does_not_raises(make):
    with pytest.raises(ValueError, match="decode kernel does not take"):
        qm._pick(*make(), "decode")


def test_the_wrapper_refuses_cpu_tensors_before_any_route():
    x, q, s = (torch.zeros((256, 1664), dtype=torch.bfloat16),
               torch.zeros((1664, 512), dtype=torch.int8), torch.ones(512))
    assert qm._route(x, q, s) == "sm90"
    before = (qm.LAUNCHES, qm.LAUNCHES_SM90, qm.LAUNCHES_DECODE)
    for forced in (None, "mma", "sm90"):
        with pytest.raises(ValueError, match="CUDA"):
            qm.quant_matmul(x, q, s, _kernel=forced)
    for forced in (None, "mma", "decode"):
        with pytest.raises(ValueError, match="CUDA"):
            qm.quant_matmul(x[:16], q, s, _kernel=forced)
    assert (qm.LAUNCHES, qm.LAUNCHES_SM90, qm.LAUNCHES_DECODE) == before


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


@pytest.mark.parametrize("name,headers", [("flash_decode_sm90", set()),
                                          ("qmm_decode_sm90", {"sm90.cuh"})])
def test_the_decode_sources_are_built_and_hashed(tmp_path, monkeypatch, name, headers):
    """Each decode kernel's source is one of the port's built sources, and
    an edit to it, or to a header it includes, renames its library."""
    assert _build.SOURCES[name] == f"{name}.cu"
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    src = csrc / f"{name}.cu"
    assert set(_build._INCLUDE.findall(src.read_text())) == headers
    before = _build._target(name)
    assert before.name.startswith(f"lib{name}_") and before.parent == _build.BUILD_DIR
    header = csrc / "sm90.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert (_build._target(name) != before) == ("sm90.cuh" in headers)
    moved = _build._target(name)
    src.write_text(src.read_text() + "\n// edited\n")
    assert _build._target(name) != moved
