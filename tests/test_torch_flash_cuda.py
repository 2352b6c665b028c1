"""The CUDA flash-attention forward kernels against their plain version, on the card.

Marked ``cuda``: these skip where no card is present.  This file imports
neither ``jax`` nor ``tdax``, so on the machine with the card it runs
without the JAX conftest:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_flash_cuda.py
"""

import math

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


def _inputs(gen, device, b, tq, tk, nh, hd, fused_q=False, fused_kv=False):
    """bf16 q/k/v, as views of one fused projection where the model makes
    them so (the ViT: q, k and v; the decoder: k and v)."""
    def fused(t, n):
        x = torch.randn((b, t, n * nh * hd), generator=gen, device=device, dtype=torch.bfloat16)
        return [c.reshape(b, t, nh, hd) for c in x.split(nh * hd, dim=-1)]

    def plain(t):
        return torch.randn((b, t, nh, hd), generator=gen, device=device, dtype=torch.bfloat16)

    if fused_q:
        return fused(tq, 3)
    return (plain(tq), *(fused(tk, 2) if fused_kv else (plain(tk), plain(tk))))


# (name, B, Tq, Tk, nh, hd, causal, fused q, fused k/v, padded keys)
KERNEL_CASES = [
    ("decoder", 2, 320, 320, 32, 128, True, False, True, True),
    ("vit", 2, 1024, 1024, 16, 104, False, True, False, False),
    ("resampler", 2, 256, 1024, 32, 128, False, False, False, False),
    ("train", 2, 1024, 1024, 32, 128, True, False, True, True),
    ("ragged", 3, 77, 131, 3, 40, False, False, False, True),
    ("hd64", 2, 200, 333, 4, 64, True, False, False, True),
    ("hd104_causal", 2, 130, 130, 2, 104, True, False, False, True),
]


@pytest.mark.parametrize("kernel", ["sm90", "mma"])
@pytest.mark.parametrize("case", KERNEL_CASES, ids=[c[0] for c in KERNEL_CASES])
def test_both_forward_kernels_match_plain(device, case, kernel):
    """Both forward kernels at the main path's shapes (batch cut), ragged
    Tq/Tk, hd 40, 64 and 104, with lse: the output within the bf16
    tolerance and lse within 1e-5 of 1 + |lse| on every row that sees a
    key; the route sends each case to the Hopper kernel."""
    name, b, tq, tk, nh, hd, causal, fused_q, fused_kv, padded = case
    gen = torch.Generator(device=device).manual_seed(7)
    q, k, v = _inputs(gen, device, b, tq, tk, nh, hd, fused_q, fused_kv)
    assert fa._route(q, k, v) == "sm90"
    valid = torch.ones((b, tk), dtype=torch.int32, device=device)
    if padded:  # right-padded rows of other lengths, the first one full
        valid[1:, tk - tk // 4:] = 0
    bias = torch.where(valid > 0, 0.0, fa.NEG_INF).to(torch.float32)
    total, sm90 = fa.LAUNCHES, fa.LAUNCHES_SM90
    got, lse = fa.flash_attention(q, k, v, bias, causal, return_lse=True,
                                  _kernel=None if kernel == "sm90" else "mma")
    torch.cuda.synchronize()
    assert fa.LAUNCHES == total + 1
    assert fa.LAUNCHES_SM90 == sm90 + (kernel == "sm90")
    want, lse_want = fa.flash_attention_plain(q, k, v, bias, causal, return_lse=True)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)
    assert ((lse - lse_want).abs() <= 1e-5 * (1 + lse_want.abs())).all()


@pytest.mark.parametrize("kernel", ["sm90", "mma"])
def test_rows_that_see_no_key_are_finite_with_lse_zero(device, kernel):
    gen = torch.Generator(device=device).manual_seed(3)
    q, k, v = _inputs(gen, device, 2, 192, 192, 2, 128)
    bias = torch.full((2, 192), fa.NEG_INF, device=device)
    bias[1, 100:] = 0.0  # batch 1: rows below 100 see no key under the causal mask
    out, lse = fa.flash_attention(q, k, v, bias, True, return_lse=True,
                                  _kernel=None if kernel == "sm90" else "mma")
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert (lse[0] == 0).all() and (lse[1, :, :100] == 0).all()
    assert (lse[1, :, 100:] != 0).all()


def test_route_sends_decode_f32_and_odd_views_to_the_mma_kernel(device):
    """Named for the kernel the decode step took before
    flash_decode_sm90.cu: one bf16 query row now takes the decode kernel;
    f32 and an odd view (hd 20) stay on flash_fwd.cu."""
    gen = torch.Generator(device=device).manual_seed(5)
    q, k, v = _inputs(gen, device, 2, 1, 352, 4, 128)
    bias = torch.zeros((2, 352), device=device)
    sm90, decode = fa.LAUNCHES_SM90, fa.LAUNCHES_DECODE
    out = fa.flash_attention(q, k, v, bias, False)
    torch.cuda.synchronize()
    assert (fa.LAUNCHES_SM90, fa.LAUNCHES_DECODE) == (sm90, decode + 1)
    torch.testing.assert_close(out.float(), fa.flash_attention_plain(q, k, v, bias, False).float(),
                               rtol=2e-2, atol=2e-2)
    with pytest.raises(ValueError, match="sm90"):
        fa.flash_attention(q, k, v, bias, False, _kernel="sm90")
    for qq, kk, vv in ((q.float(), k.float(), v.float()),
                       tuple(x[..., :20].contiguous() for x in (q, k, v))):
        out = fa.flash_attention(qq, kk, vv, bias, False)
        torch.cuda.synchronize()
        assert (fa.LAUNCHES_SM90, fa.LAUNCHES_DECODE) == (sm90, decode + 1)
        want = fa.flash_attention_plain(qq, kk, vv, bias, False)
        torch.testing.assert_close(out.float(), want.float(), rtol=2e-2, atol=2e-2)


# (name, B, Tk, nh, hd): the decode step, a tp rank's heads, a dp x tp
# rank's, ragged sizes, the ViT's head dim
DECODE_CASES = [("main", 16, 352, 32, 128), ("tp16", 16, 352, 16, 128),
                ("dp8_tp16", 8, 352, 16, 128), ("ragged", 3, 37, 5, 64), ("hd104", 2, 100, 4, 104), ("one_key", 2, 1, 4, 128),
                ("long", 1, 3000, 2, 128)]


@pytest.mark.parametrize("kernel", ["decode", "mma"])
@pytest.mark.parametrize("case", DECODE_CASES, ids=[c[0] for c in DECODE_CASES])
@pytest.mark.parametrize("causal", [False, True], ids=["keys", "causal"])
def test_both_kernels_at_one_query_row(device, case, kernel, causal):
    """flash_decode_sm90.cu (the route's choice) and flash_fwd.cu (forced)
    at one query row: k and v one layer of a cache, each row's keys valid
    up to its own position, the output within the bf16 tolerance and lse
    within 1e-5 of 1 + |lse|; the decode kernel bitwise on a repeat."""
    name, b, tk, nh, hd = case
    gen = torch.Generator(device=device).manual_seed(11)
    q = torch.randn((b, 1, 3 * nh * hd), generator=gen, device=device,
                    dtype=torch.bfloat16)[..., :nh * hd].reshape(b, 1, nh, hd)
    cache = torch.randn((2, 2, b, tk, nh, hd), generator=gen, device=device, dtype=torch.bfloat16)
    k, v = cache[0, 1], cache[1, 1]
    assert fa._route(q, k, v) == "decode"
    cur = torch.randint(0, tk, (b,), generator=gen, device=device)
    cur[0] = tk - 1
    bias = torch.where(torch.arange(tk, device=device)[None] <= cur[:, None], 0.0,
                       fa.NEG_INF).to(torch.float32)
    total, decode = fa.LAUNCHES, fa.LAUNCHES_DECODE
    forced = None if kernel == "decode" else "mma"
    got, lse = fa.flash_attention(q, k, v, bias, causal, True, _kernel=forced)
    torch.cuda.synchronize()
    assert (fa.LAUNCHES, fa.LAUNCHES_DECODE) == (total + 1, decode + (kernel == "decode"))
    want, lse_want = fa.flash_attention_plain(q, k, v, bias, causal, True)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)
    assert ((lse - lse_want).abs() <= 1e-5 * (1 + lse_want.abs())).all()
    if kernel == "decode":
        again, lse_again = fa.flash_attention(q, k, v, bias, causal, True)
        assert torch.equal(again, got) and torch.equal(lse_again, lse)


@pytest.mark.parametrize("warps", [4, 8, 16])
def test_a_split_whose_keys_are_all_masked_merges_to_nothing(device, warps, monkeypatch):
    """At each block size: split 1's keys masked on every row, and one
    row whose every key is masked (finite, lse 0)."""
    monkeypatch.setattr(fa, "_decode_warps", lambda *args: warps)
    gen = torch.Generator(device=device).manual_seed(12)
    b, tk, nh, hd = 3, 352, 4, 128
    q, k, v = _inputs(gen, device, b, 1, tk, nh, hd)
    at_once = fa.DECODE_KEYS_AT_ONCE
    chunk = math.ceil(math.ceil(tk / (2 * warps)) / at_once) * at_once  # keys a split
    bias = torch.zeros((b, tk), device=device)
    bias[:, chunk:2 * chunk] = fa.NEG_INF
    bias[2] = fa.NEG_INF
    got, lse = fa.flash_attention(q, k, v, bias, False, True)
    want, lse_want = fa.flash_attention_plain(q, k, v, bias, False, True)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all() and (lse[2] == 0).all() and (lse_want[2] == 0).all()
    torch.testing.assert_close(got[:2].float(), want[:2].float(), rtol=2e-2, atol=2e-2)
    assert ((lse - lse_want).abs() <= 1e-5 * (1 + lse_want.abs())).all()


def test_wrapper_raises_on_what_the_kernel_does_not_take(device):
    q = torch.zeros((1, 8, 1, 160), device=device, dtype=torch.bfloat16)
    bias = torch.zeros((1, 8), device=device)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, q, q, bias, False)
    q = torch.zeros((1, 8, 1, 16), device=device, dtype=torch.float16)
    with pytest.raises(TypeError):
        fa.flash_attention(q, q, q, bias, False)
