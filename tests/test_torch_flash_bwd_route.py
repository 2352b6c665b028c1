"""Which backward kernels the port's flash attention picks, and what the
Hopper backward library's build hash covers.  CPU only: ``_bwd_route``
reads shapes, strides, alignment and dtype, never the data, and
``_build._target`` hashes files.  The kernels themselves are held against
the plain versions on the card (``tests/test_torch_flash_bwd_cuda.py``,
``chip_smoke.py``).
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


def _train():  # rotated q and k are new tensors; v a view of the qkv projection; dO contiguous
    v = _fused(4, 1024, 32, 128, 3)[2]
    return _plain(4, 1024, 32, 128), _plain(4, 1024, 32, 128), v, _plain(4, 1024, 32, 128)


def _resampler():  # cross-attention: 256 queries over the 1024 patches
    q, k, v = _plain(2, 256, 32, 128), _plain(2, 1024, 32, 128), _plain(2, 1024, 32, 128)
    return q, k, v, _plain(2, 256, 32, 128)


def _vit():  # hd 104, q, k and v views of one qkv projection: zero-filled to 128 columns
    q, k, v = _fused(2, 1024, 16, 104, 3)
    return q, k, v, _plain(2, 1024, 16, 104)


def _ragged():  # hd 40 and Tq, Tk off the tile sizes: zero-filled, clipped on the store
    return _plain(3, 77, 3, 40), _plain(3, 131, 3, 40), _plain(3, 131, 3, 40), _plain(3, 77, 3, 40)


def _f32():
    return tuple(_plain(2, 320, 4, 128, torch.float32) for _ in range(4))


def _hd20():  # hd not a multiple of 8: TMA cannot read 40-byte rows
    return tuple(_plain(2, 128, 2, 20) for _ in range(4))


def _misaligned():  # dO a view whose base sits 2 bytes past a 16-byte boundary
    flat = torch.empty(2 * 128 * 2 * 64 + 8, dtype=torch.bfloat16)
    do = flat[1:1 + 2 * 128 * 2 * 64].view(2, 128, 2, 64)
    return _plain(2, 128, 2, 64), _plain(2, 128, 2, 64), _plain(2, 128, 2, 64), do


def _stride0():  # a broadcast view (stride 0 over the batch) is not a tensor map's
    k = _plain(1, 256, 4, 64).expand(3, 256, 4, 64)
    q = v = do = _plain(3, 256, 4, 64)
    return q, k, v, do


def _short_q():  # fewer than SM90_MIN_TQ query rows
    q = _plain(2, fa.SM90_MIN_TQ - 1, 4, 64)
    return q, _plain(2, 300, 4, 64), _plain(2, 300, 4, 64), q


def _short_k():  # fewer than SM90_MIN_TQ keys
    q = _plain(2, 300, 4, 64)
    return q, _plain(2, 40, 4, 64), _plain(2, 40, 4, 64), q


@pytest.mark.parametrize("make", [_train, _resampler, _vit, _ragged],
                         ids=["train", "resampler", "vit_hd104", "ragged_hd40"])
def test_training_inputs_take_the_hopper_backward(make):
    assert fa._bwd_route(*make()) == "sm90"


@pytest.mark.parametrize("make", [_f32, _hd20, _misaligned, _stride0, _short_q, _short_k],
                         ids=["f32", "hd20", "misaligned", "stride0", "short_q", "short_k"])
def test_everything_else_takes_the_mma_backward(make):
    assert fa._bwd_route(*make()) == "mma"


@pytest.mark.parametrize("make,forced,want", [
    (_train, None, "sm90"), (_train, "sm90", "sm90"), (_train, "mma", "mma"),
    (_f32, None, "mma"), (_f32, "mma", "mma"), (_f32, "sm90", ValueError),
    (_train, "wgmma", ValueError),
], ids=["route", "sm90_fits", "mma_forced", "f32_route", "f32_mma", "f32_sm90", "unknown"])
def test_forced_kernel(make, forced, want):
    """``_kernel="mma"`` always takes; a kernel the inputs do not fit raises."""
    if want is ValueError:
        with pytest.raises(ValueError, match="does not take"):
            fa._bwd_kernel(*make(), forced)
    else:
        assert fa._bwd_kernel(*make(), forced) == want


@pytest.mark.parametrize("which", ["dq", "dkv"])
@pytest.mark.parametrize("kernel", [None, "mma", "sm90"])
def test_backward_wrappers_refuse_cpu_tensors_before_any_route(which, kernel):
    q = _plain(1, 128, 2, 64)
    bias = torch.zeros((1, 128))
    rows = torch.zeros((1, 2, 128))
    names = ("BWD_DQ_LAUNCHES", "BWD_DKV_LAUNCHES", "BWD_DQ_LAUNCHES_SM90",
             "BWD_DKV_LAUNCHES_SM90")
    before = [getattr(fa, n) for n in names]
    wrapper = fa.flash_bwd_dq if which == "dq" else fa.flash_bwd_dkv
    with pytest.raises(ValueError, match="CUDA"):
        wrapper(q, q, q, bias, rows, rows, q, True, _kernel=kernel)
    assert [getattr(fa, n) for n in names] == before


def test_library_hash_of_the_hopper_backward_covers_sm90_cuh(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    assert _build.SOURCES["flash_bwd_sm90"] == "flash_bwd_sm90.cu"
    assert '#include "sm90.cuh"' in (csrc / "flash_bwd_sm90.cu").read_text()
    before = {name: _build._target(name) for name in _build.SOURCES}
    header = csrc / "sm90.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: _build._target(name) for name in _build.SOURCES}
    assert after["flash_bwd_sm90"] != before["flash_bwd_sm90"]
    assert after["flash_bwd"] == before["flash_bwd"]
    src = csrc / "flash_bwd_sm90.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert _build._target("flash_bwd_sm90") != after["flash_bwd_sm90"]
