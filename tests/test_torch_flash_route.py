"""Which forward kernel the port's flash attention picks, and what its
kernel library's build hash covers.  CPU only: ``_route`` reads shapes,
strides, alignment and dtype, never the data, and ``_build._target``
hashes files.  The kernels themselves are held against the plain
version on the card (``tests/test_torch_flash_cuda.py``, ``chip_smoke.py``).
"""

import shutil

import pytest
import torch

import tdax_torch.ops.flash_attention as fa
from tdax_torch.ops import _build


def _fused(b, t, nh, hd, n):
    """n views [B, T, nh, hd] of one fused projection [B, T, n * nh * hd]."""
    x = torch.empty((b, t, n * nh * hd), dtype=torch.bfloat16)
    return [c.reshape(b, t, nh, hd) for c in x.split(nh * hd, dim=-1)]


def _plain(b, t, nh, hd, dtype=torch.bfloat16):
    return torch.empty((b, t, nh, hd), dtype=dtype)


def _decoder():  # rotated q and k are new tensors; v is a view of the qkv projection
    v = _fused(2, 320, 32, 128, 3)[2]
    return _plain(2, 320, 32, 128), _plain(2, 320, 32, 128), v


def _vit():  # q, k and v are views of one qkv projection (row stride 3 x 1664)
    return tuple(_fused(2, 1024, 16, 104, 3))


def _resampler():  # cross-attention: 256 queries over the 1024 patches
    return _plain(2, 256, 32, 128), _plain(2, 1024, 32, 128), _plain(2, 1024, 32, 128)


def _train():  # the training shape, causal, with lse
    v = _fused(4, 1024, 32, 128, 3)[2]
    return _plain(4, 1024, 32, 128), _plain(4, 1024, 32, 128), v


def _decode():  # one query row over the layer's cache
    return _plain(16, 1, 32, 128), _plain(16, 352, 32, 128), _plain(16, 352, 32, 128)


def _f32():
    return tuple(_plain(2, 320, 4, 128, torch.float32) for _ in range(3))


def _hd20():  # hd not a multiple of 8: TMA cannot read 40-byte rows
    return tuple(_plain(2, 128, 2, 20) for _ in range(3))


def _misaligned():  # a view whose base sits 2 bytes past a 16-byte boundary
    flat = torch.empty(2 * 128 * 2 * 64 + 8, dtype=torch.bfloat16)
    q = flat[1:1 + 2 * 128 * 2 * 64].view(2, 128, 2, 64)
    return q, _plain(2, 128, 2, 64), _plain(2, 128, 2, 64)


def _short():  # fewer than SM90_MIN_TQ query rows
    return _plain(2, fa.SM90_MIN_TQ - 1, 4, 64), _plain(2, 300, 4, 64), _plain(2, 300, 4, 64)


@pytest.mark.parametrize("make", [_decoder, _vit, _resampler, _train],
                         ids=["decoder", "vit", "resampler", "train"])
def test_main_path_shapes_take_the_hopper_kernel(make):
    q, k, v = make()
    assert fa._route(q, k, v) == "sm90"


@pytest.mark.parametrize("make", [_decode, _f32, _hd20, _misaligned, _short],
                         ids=["decode", "f32", "hd20", "misaligned", "short"])
def test_everything_else_takes_the_mma_kernel(make):
    q, k, v = make()
    assert fa._route(q, k, v) == "mma"


def test_a_stride_of_zero_takes_the_mma_kernel():
    """A broadcast view (stride 0 over the batch) is not a tensor map's."""
    q = _plain(1, 256, 4, 64).expand(3, 256, 4, 64)
    k = v = _plain(3, 256, 4, 64)
    assert q.stride(0) == 0
    assert fa._route(q, k, v) == "mma"


def test_library_hash_covers_the_headers_a_source_includes(tmp_path, monkeypatch):
    """An edit to sm90.cuh must give the sm90 library a new name (else a
    stale build would load); an edit to a header the source does not
    include must not."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {name: _build._target(name) for name in _build.SOURCES}
    assert '#include "sm90.cuh"' in (csrc / "flash_fwd_sm90.cu").read_text()

    (csrc / "other.cuh").write_text("// not included\n")
    assert {name: _build._target(name) for name in _build.SOURCES} == before

    header = csrc / "sm90.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: _build._target(name) for name in _build.SOURCES}
    assert after["flash_fwd_sm90"] != before["flash_fwd_sm90"]
    assert {n: p for n, p in after.items() if n != "flash_fwd_sm90"} == {
        n: p for n, p in before.items() if n != "flash_fwd_sm90"}


def test_library_hash_covers_the_source(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = _build._target("flash_fwd")
    src = csrc / "flash_fwd.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert _build._target("flash_fwd") != before


def test_the_wrapper_refuses_cpu_tensors_before_any_route():
    q = _plain(1, 128, 2, 64)
    before = (fa.LAUNCHES, fa.LAUNCHES_SM90)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(q, q, q, torch.zeros((1, 128)), False, _kernel="mma")
    assert (fa.LAUNCHES, fa.LAUNCHES_SM90) == before
