"""Flash attention with v of its own width (latent attention): the plain
version against explicit attention on the CPU, and which kernel each
shape takes.  The kernels themselves are held against the plain version
on the card (``tests/test_torch_flash_mla_cuda.py``)."""

import math

import pytest
import torch

import tdax_torch.ops.flash_attention as fa


def _explicit(q, k, v, valid, causal):
    """softmax(q k^T / sqrt(hd) over the valid (and causal) keys) v, f64."""
    q, k, v = (x.double() for x in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    allowed = valid[:, None, None, :] > 0
    if causal:
        allowed = allowed & torch.ones(s.shape[-2:], dtype=torch.bool).tril()
    p = torch.softmax(s.masked_fill(~allowed, float("-inf")), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


@pytest.mark.parametrize("hd,hd_v", [(192, 128), (24, 16)], ids=["mla", "tiny"])
@pytest.mark.parametrize("causal", [False, True], ids=["keys", "causal"])
def test_plain_version_with_v_of_its_own_width(hd, hd_v, causal):
    """The output takes v's width; the lse is that of the q.k scores at
    1 / sqrt(hd).  f32 sums against f64: 1e-5."""
    gen = torch.Generator().manual_seed(hd + causal)
    b, t, nh = 2, 37, 3
    q, k = (torch.randn((b, t, nh, hd), generator=gen) for _ in range(2))
    v = torch.randn((b, t, nh, hd_v), generator=gen)
    valid = torch.ones((b, t), dtype=torch.int32)
    valid[1, 30:] = 0
    bias = fa.AttnSpec(valid, causal).bias(b, t, "cpu")
    out, lse = fa.flash_attention_plain(q, k, v, bias, causal, return_lse=True)
    assert out.shape == (b, t, nh, hd_v) and lse.shape == (b, nh, t)
    torch.testing.assert_close(out.double(), _explicit(q, k, v, valid, causal), rtol=1e-5,
                               atol=1e-5)
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()) / math.sqrt(hd)
    s = s + bias.double()[:, None, None, :]
    if causal:
        s = s.masked_fill(~torch.ones((t, t), dtype=torch.bool).tril(), float("-inf"))
    torch.testing.assert_close(lse.double(), torch.logsumexp(s, -1), rtol=1e-5, atol=1e-5)
    # mha takes the same route on CPU tensors
    torch.testing.assert_close(fa.mha(q, k, v, fa.AttnSpec(valid, causal)), out)


def _mla(b=16, t=320, nh=16, kv_view=True):
    """q and k as MLA makes them (new tensors of 192 columns), v the second
    half of each head of the kv_b product [B, T, nh, 256]."""
    q = torch.empty((b, t, nh, 192), dtype=torch.bfloat16)
    k = torch.empty((b, t, nh, 192), dtype=torch.bfloat16)
    kv = torch.empty((b, t, nh, 256), dtype=torch.bfloat16)
    return q, k, (kv[..., 128:] if kv_view else torch.empty((b, t, nh, 128),
                                                             dtype=torch.bfloat16))


@pytest.mark.parametrize("kv_view", [True, False], ids=["kv_view", "plain_v"])
def test_latent_attention_takes_the_hopper_kernel(kv_view):
    q, k, v = _mla(kv_view=kv_view)
    assert fa._route(q, k, v) == "sm90"


@pytest.mark.parametrize("make,want", [
    (lambda: tuple(x.float() for x in _mla(2, 128, 2)), "mma"),              # f32
    (lambda: tuple(x[:, :40] for x in _mla(2, 128, 2)), "mma"),              # 40 rows
    (lambda: _mla(2, 1, 2), "mma"),                                          # one row
    (lambda: (torch.empty((2, 128, 2, 24), dtype=torch.bfloat16),
              torch.empty((2, 128, 2, 24), dtype=torch.bfloat16),
              torch.empty((2, 128, 2, 16), dtype=torch.bfloat16)), "mma"),  # q.k <= 128
], ids=["f32", "short", "decode", "narrow"])
def test_other_widths_apart_take_the_mma_kernel(make, want):
    assert fa._route(*make()) == want


@pytest.mark.parametrize("hd", [64, 72, 104, 128], ids=["hd64", "moonvit", "vit", "hd128"])
def test_v_of_qs_width_routes_as_before(hd):
    """v of q's width keeps its Hopper route (the C launcher's (4, 64),
    (7, 104) and (8, 128) instantiations, MoonViT's hd 72 on the ViT's)."""
    x = torch.empty((2, 1024, 4, hd), dtype=torch.bfloat16)
    assert fa._route(x, x, x) == "sm90"


@pytest.mark.parametrize("hd,hd_v", [(200, 128), (192, 136), (160, 160)],
                         ids=["qk_too_wide", "v_too_wide", "equal_above_128"])
def test_widths_no_kernel_takes_are_refused(hd, hd_v):
    q = k = torch.zeros((1, 8, 2, hd))
    v = torch.zeros((1, 8, 2, hd_v))
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, k, v, torch.zeros((1, 8)), False)


def test_the_backward_kernels_refuse_v_of_another_width():
    q = k = torch.zeros((1, 64, 2, 192), dtype=torch.bfloat16)
    v = torch.zeros((1, 64, 2, 128), dtype=torch.bfloat16)
    rows = torch.zeros((1, 2, 64))
    with pytest.raises(ValueError, match="v of q's width"):
        fa.flash_bwd_dq(q, k, v, torch.zeros((1, 64)), rows, rows, torch.zeros_like(q), True)
