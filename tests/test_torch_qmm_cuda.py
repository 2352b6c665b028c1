"""The CUDA int8 matmul kernel against its plain version, on the card.

Marked ``cuda``: these skip where no card is present.  This file imports
neither ``jax`` nor ``tdax``, so on the machine with the card it runs
without the JAX conftest:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_qmm_cuda.py

Tolerances: bf16 ``|kernel - plain| <= 2^-7 |plain| + 1e-3 max|plain|``
(one bf16 rounding of the output, plus room for the order of the f32
sum); f32 ``<= 1e-5 (|x| @ |q| s)`` entrywise (the sum's rounding is
bounded by the sum of the magnitudes of its terms).
"""

import pytest
import torch

from tdax_torch.models.qwen_vl.quantize import qdot, quantize_weight
from tdax_torch.ops import quant_matmul as qm

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    from tdax_torch.runtime import get_device
    return get_device()


def _weight(gen, k, n, device):
    w = torch.randn((k, n), generator=gen, device=device) / k ** 0.5
    return quantize_weight(w)


def _check(x, w):
    got = qm.quant_matmul(x, w["q"], w["s"])
    want = qm.quant_matmul_plain(x, w["q"], w["s"])
    assert got.dtype == x.dtype and got.shape == want.shape
    err = (got.float() - want.float()).abs()
    if x.dtype == torch.bfloat16:
        limit = 2.0 ** -7 * want.float().abs() + 1e-3 * want.float().abs().max()
    else:
        limit = 1e-5 * (x.abs() @ w["q"].float().abs() * w["s"])
    assert (err <= limit).all(), float((err - limit).max())


@pytest.mark.parametrize("m,k,n", [(8, 256, 128), (130, 588, 384), (1, 33, 7), (16, 4096, 4096),
                                   (64, 96, 48), (65, 64, 17), (300, 1664, 640), (3, 40, 1000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain(device, m, k, n, dtype):
    gen = torch.Generator(device=device).manual_seed(m * 7 + n)
    x = torch.randn((m, k), generator=gen, device=device).to(dtype)
    w = _weight(gen, k, n, device)
    launches = qm.LAUNCHES
    _check(x, w)
    assert qm.LAUNCHES == launches + 1


def test_kernel_reads_strided_and_broadcast_rows(device):
    """A column slice (row stride 3K), a broadcast view and a 3-D x."""
    gen = torch.Generator(device=device).manual_seed(5)
    w = _weight(gen, 256, 192, device)
    fused = torch.randn((4, 10, 3 * 256), generator=gen, device=device).to(torch.bfloat16)
    _check(fused[..., 256:512], w)
    row = torch.randn((1, 256), generator=gen, device=device).to(torch.bfloat16)
    _check(row.expand(6, 256), w)
    odd = torch.randn((5, 7, 255), generator=gen, device=device).to(torch.bfloat16)
    _check(odd[..., :250], _weight(gen, 250, 192, device))


def test_qdot_launches_the_kernel_on_the_card(device):
    gen = torch.Generator(device=device).manual_seed(6)
    w = _weight(gen, 64, 32, device)
    x = torch.randn((2, 3, 64), generator=gen, device=device)
    launches = qm.LAUNCHES
    out = qdot(x, w)
    assert qm.LAUNCHES == launches + 1 and out.shape == (2, 3, 32)


def test_wrapper_raises_on_what_the_kernel_does_not_take(device):
    w = quantize_weight(torch.ones((8, 4), device=device))
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        qm.quant_matmul(torch.zeros((2, 8), device=device, dtype=torch.float16), w["q"], w["s"])
    with pytest.raises(ValueError, match="contiguous"):
        qm.quant_matmul(torch.zeros((2, 8), device=device), w["q"].t().contiguous().t(), w["s"])
    with pytest.raises(ValueError, match="do not match"):
        qm.quant_matmul(torch.zeros((2, 9), device=device), w["q"], w["s"])
    with pytest.raises(ValueError, match="CUDA device"):
        qm.quant_matmul(torch.zeros((2, 8), device=device), w["q"].cpu(), w["s"])
