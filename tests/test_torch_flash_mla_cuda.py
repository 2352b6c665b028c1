"""The flash forward with v of its own width on the card: the sm90
latent-attention kernel (q.k over 192 columns, v of 128) and
``flash_fwd.cu`` against the plain version.

Marked ``cuda``: these skip where no card is present.  This file imports
neither ``jax`` nor ``tdax``, so on the machine with the card it runs
without the JAX conftest:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_flash_mla_cuda.py
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


def _mla_inputs(gen, device, b, t, nh, hd=192, hd_v=128, dtype=torch.bfloat16):
    """q and k new tensors, v the second half of each head of one kv
    product, as the decoder makes them."""
    q = torch.randn((b, t, nh, hd), generator=gen, device=device, dtype=dtype)
    k = torch.randn((b, t, nh, hd), generator=gen, device=device, dtype=dtype)
    kv = torch.randn((b, t, nh, 2 * hd_v), generator=gen, device=device, dtype=dtype)
    return q, k, kv[..., hd_v:]


# (name, B, T, nh, causal, keys masked at the end of row 0)
CASES = [("capture", 16, 320, 16, True, 25), ("ragged", 2, 130, 3, True, 7),
         ("keys", 2, 200, 2, False, 9), ("one_tile", 1, 64, 1, True, 0)]


@pytest.mark.parametrize("with_lse", [False, True], ids=["o", "o_lse"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_mla_kernel_matches_plain(device, case, with_lse):
    """bf16 products summed in f32 in another order than the plain
    version's, p rounded to bf16 in both: 2e-2, as the other forwards."""
    _, b, t, nh, causal, masked = case
    gen = torch.Generator(device=device).manual_seed(t)
    q, k, v = _mla_inputs(gen, device, b, t, nh)
    valid = torch.ones((b, t), dtype=torch.int32, device=device)
    if masked:
        valid[0, t - masked:] = 0
    bias = fa.AttnSpec(valid, causal).bias(b, t, device)
    assert fa._route(q, k, v) == "sm90"
    before = (fa.LAUNCHES_SM90, fa.LAUNCHES_MLA)
    got = fa.flash_attention(q, k, v, bias, causal, return_lse=with_lse)
    assert (fa.LAUNCHES_SM90, fa.LAUNCHES_MLA) == (before[0] + 1, before[1] + 1)
    want = fa.flash_attention_plain(q, k, v, bias, causal, return_lse=with_lse)
    if with_lse:
        torch.testing.assert_close(got[1], want[1], rtol=1e-3, atol=1e-3)
        got, want = got[0], want[0]
    assert got.shape == (b, t, nh, 128)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd,hd_v", [(192, 128), (24, 16)], ids=["mla", "tiny"])
def test_mma_kernel_with_v_of_its_own_width(device, dtype, hd, hd_v):
    gen = torch.Generator(device=device).manual_seed(hd)
    q, k, v = _mla_inputs(gen, device, 2, 100, 3, hd, hd_v, dtype)
    bias = torch.zeros((2, 100), dtype=torch.float32, device=device)
    got = fa.flash_attention(q, k, v, bias, True, _kernel="mma")
    want = fa.flash_attention_plain(q, k, v, bias, True)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_the_moonvit_shape_takes_the_vits_instantiation(device):
    """MoonViT's hd 72 (16 images of 1024 patches, 16 heads, q, k and v
    views of one qkv product) on the (7, 104) kernel, against plain."""
    gen = torch.Generator(device=device).manual_seed(72)
    qkv = torch.randn((16, 1024, 3 * 1152), generator=gen, device=device, dtype=torch.bfloat16)
    q, k, v = (x.reshape(16, 1024, 16, 72) for x in qkv.split(1152, dim=-1))
    assert fa._route(q, k, v) == "sm90"
    before = fa.LAUNCHES_MLA
    bias = torch.zeros((16, 1024), dtype=torch.float32, device=device)
    got = fa.flash_attention(q, k, v, bias, False)
    assert fa.LAUNCHES_MLA == before
    torch.testing.assert_close(got.float(), fa.flash_attention_plain(q, k, v, bias, False).float(),
                               rtol=2e-2, atol=2e-2)
