"""The CUDA flash-attention kernel against its plain version, on the card.

Marked ``cuda``: these skip where no card is present.  This file imports
neither ``jax`` nor ``tdax``, so on the machine with the card it runs
without the JAX conftest:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_flash_cuda.py
"""

import pytest
import torch

import tdax_torch.ops.flash_attention as fa

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    from tdax_torch.runtime import get_device
    return get_device()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tq,tk,nh,hd,causal", [
    (40, 40, 2, 16, True),
    (8, 40, 2, 20, False),
    (130, 130, 1, 128, True),
    (70, 300, 2, 104, False),
    (257, 257, 3, 64, True),
])
def test_kernel_matches_plain(device, dtype, tq, tk, nh, hd, causal):
    gen = torch.Generator(device=device).manual_seed(0)
    b = 2
    q, k, v = (torch.randn((b, t, nh, hd), generator=gen, device=device, dtype=dtype)
               for t in (tq, tk, tk))
    valid = torch.ones((b, tk), dtype=torch.int32, device=device)
    valid[0, tk - 7:] = 0
    bias = torch.where(valid > 0, 0.0, fa.NEG_INF).to(torch.float32)
    launches = fa.LAUNCHES
    got = fa.flash_attention(q, k, v, bias, causal)
    assert fa.LAUNCHES == launches + 1
    want = fa.flash_attention_plain(q, k, v, bias, causal)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_kernel_reads_strided_views(device):
    """q/k/v as views of one fused projection, as the model passes them."""
    gen = torch.Generator(device=device).manual_seed(1)
    b, t, nh, hd = 2, 96, 4, 104
    qkv = torch.randn((b, t, 3 * nh * hd), generator=gen, device=device, dtype=torch.bfloat16)
    q, k, v = (x.reshape(b, t, nh, hd) for x in qkv.split(nh * hd, dim=-1))
    bias = torch.zeros((b, t), dtype=torch.float32, device=device)
    got = fa.flash_attention(q, k, v, bias, False)
    want = fa.flash_attention_plain(q, k, v, bias, False)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)


def test_wrapper_raises_on_what_the_kernel_does_not_take(device):
    q = torch.zeros((1, 8, 1, 160), device=device, dtype=torch.bfloat16)
    bias = torch.zeros((1, 8), device=device)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, q, q, bias, False)
    q = torch.zeros((1, 8, 1, 16), device=device, dtype=torch.float16)
    with pytest.raises(TypeError):
        fa.flash_attention(q, q, q, bias, False)
