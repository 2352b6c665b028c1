"""The CUDA flash-attention backward kernels and the forward's lse
output against their plain versions, on the card.

Marked ``cuda``: these skip where no card is present.  This file imports
neither ``jax`` nor ``tdax``, so on the machine with the card it runs
without the JAX conftest:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_flash_bwd_cuda.py

Tolerances: f32 within 1e-5 of the magnitude of the summed terms
(``fa_terms``); bf16 within 2^-7 |plain| + 1e-3 max|plain| (the output's
rounding) plus 2^-8 of the summed terms' magnitude (each ds or p is
rounded to bf16 before its product, and may land one bf16 step from the
plain version's where the two f32 values straddle a rounding edge).  The
Hopper kernels (``flash_bwd_sm90.cu``) are held to the same bf16 bound:
their ex2 on (s - lse) log2 e is ~2^-22 from expf, far inside a bf16 step.
"""

import pytest
import torch

import tdax_torch.ops.flash_attention as fa

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from tdax_torch.runtime import get_device
    return get_device()


def _inputs(device, dtype, b, tq, tk, nh, hd, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    q, do = (torch.randn((b, tq, nh, hd), generator=gen, device=device, dtype=dtype)
             for _ in range(2))
    k, v = (torch.randn((b, tk, nh, hd), generator=gen, device=device, dtype=dtype)
            for _ in range(2))
    valid = torch.ones((b, tk), dtype=torch.int32, device=device)
    valid[-1, tk - min(7, tk - 1):] = 0
    bias = torch.where(valid > 0, 0.0, fa.NEG_INF).to(torch.float32)
    return q, k, v, do, bias


def fa_terms(q, k, v, bias, lse, delta, do, causal):
    """The magnitude of the terms each gradient sums: |ds| times |k| or
    |q| (in f32 ds's size bound p (|dO| . |v| + |delta|) scale, as ds
    cancels dp against delta); p |dO| for dv."""
    p, mag = fa._probs_and_ds(q, k, v, bias, lse, delta, do, causal)
    if q.dtype == torch.float32:
        dp_mag = torch.einsum("bqhd,bkhd->bhqk", do.float().abs(), v.float().abs())
        mag = p * (dp_mag + delta.abs()[..., None]) / q.shape[-1] ** 0.5
    mag = mag.abs()
    return {"dq": torch.einsum("bhqk,bkhd->bqhd", mag, k.float().abs()),
            "dk": torch.einsum("bhqk,bqhd->bkhd", mag, q.float().abs()),
            "dv": torch.einsum("bhqk,bqhd->bkhd", p, do.float().abs())}


def _limit(want, dtype, terms):
    if dtype == torch.bfloat16:
        ref = want.float().abs()
        return ref * 2.0 ** -7 + 1e-3 * float(ref.max()) + terms * 2.0 ** -8
    return terms * 1e-5 + 1e-30


def _assert_matches_plain(q, k, v, bias, lse, delta, do, causal, got):
    want_dq = fa.flash_bwd_dq_plain(q, k, v, bias, lse, delta, do, causal)
    want_dk, want_dv = fa.flash_bwd_dkv_plain(q, k, v, bias, lse, delta, do, causal)
    terms = fa_terms(q, k, v, bias, lse, delta, do, causal)
    for name, g, want in zip(("dq", "dk", "dv"), got, (want_dq, want_dk, want_dv)):
        assert g.dtype == q.dtype and g.shape == want.shape
        err = (g.float() - want.float()).abs()
        excess = float((err - _limit(want, q.dtype, terms[name])).max())
        assert excess <= 0, f"{name}: max |kernel - plain| {float(err.max()):.3e}"


_COUNTERS = ("BWD_DQ_LAUNCHES", "BWD_DKV_LAUNCHES", "BWD_DQ_LAUNCHES_SM90",
             "BWD_DKV_LAUNCHES_SM90")


def _counts():
    return [getattr(fa, n) for n in _COUNTERS]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tq,tk,nh,hd,causal", [
    (40, 40, 2, 16, True),
    (8, 40, 2, 20, False),
    (130, 130, 1, 128, True),
    (70, 300, 2, 104, False),
    (257, 257, 3, 64, True),
])
def test_kernels_match_plain(device, dtype, tq, tk, nh, hd, causal):
    q, k, v, do, bias = _inputs(device, dtype, 2, tq, tk, nh, hd)
    counts = (fa.LAUNCHES, fa.BWD_DQ_LAUNCHES, fa.BWD_DKV_LAUNCHES)
    o, lse = fa.flash_attention(q, k, v, bias, causal, return_lse=True)
    _, lse_plain = fa.flash_attention_plain(q, k, v, bias, causal, return_lse=True)
    torch.testing.assert_close(lse, lse_plain, rtol=1e-5, atol=1e-5)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    dq = fa.flash_bwd_dq(q, k, v, bias, lse, delta, do, causal)
    dk, dv = fa.flash_bwd_dkv(q, k, v, bias, lse, delta, do, causal)
    torch.cuda.synchronize()
    assert (fa.LAUNCHES, fa.BWD_DQ_LAUNCHES, fa.BWD_DKV_LAUNCHES) == tuple(
        c + 1 for c in counts)
    _assert_matches_plain(q, k, v, bias, lse, delta, do, causal, (dq, dk, dv))


# (Tq, Tk, nh, hd, causal, v a view of a fused kv projection): the shapes
# the route sends to flash_bwd_sm90.cu, hd 64 and 128, causal and not,
# Tq and Tk off the 64- and 128-row tiles, hd 40 and 104 zero-filled
SM90_CASES = [
    (128, 128, 2, 128, True, True),
    (200, 333, 2, 128, False, False),
    (333, 200, 2, 128, True, False),
    (257, 190, 2, 64, True, True),
    (64, 64, 1, 64, False, False),
    (77, 131, 3, 40, True, False),
    (130, 70, 2, 104, True, False),
]


def _sm90_inputs(device, tq, tk, nh, hd, fused_v, seed):
    q, k, v, do, bias = _inputs(device, torch.bfloat16, 2, tq, tk, nh, hd, seed=seed)
    if fused_v:
        kv = torch.cat([k.reshape(2, tk, nh * hd), v.reshape(2, tk, nh * hd)], dim=-1)
        v = kv[..., nh * hd:].view(2, tk, nh, hd)
        assert not v.is_contiguous()
    return q, k, v, do, bias


@pytest.mark.parametrize("kernel", ["sm90", "mma"])
@pytest.mark.parametrize("tq,tk,nh,hd,causal,fused_v", SM90_CASES)
def test_bf16_backward_at_hopper_shapes_matches_plain(device, kernel, tq, tk, nh, hd, causal,
                                                      fused_v):
    """Each kernel pair the route or ``_kernel="mma"`` picks, against the
    plain versions; the counters move as the choice says."""
    q, k, v, do, bias = _sm90_inputs(device, tq, tk, nh, hd, fused_v, seed=3)
    assert fa._bwd_route(q, k, v, do) == "sm90"
    o, lse = fa.flash_attention(q, k, v, bias, causal, return_lse=True)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    forced = None if kernel == "sm90" else "mma"
    before = _counts()
    dq = fa.flash_bwd_dq(q, k, v, bias, lse, delta, do, causal, _kernel=forced)
    dk, dv = fa.flash_bwd_dkv(q, k, v, bias, lse, delta, do, causal, _kernel=forced)
    torch.cuda.synchronize()
    sm90 = int(kernel == "sm90")
    assert [a - b for a, b in zip(_counts(), before)] == [1, 1, sm90, sm90]
    _assert_matches_plain(q, k, v, bias, lse, delta, do, causal, (dq, dk, dv))


def test_sm90_backward_is_bitwise_deterministic(device):
    """No atomics: the same inputs give the same bits (train_loop's
    bitwise resume depends on it)."""
    q, k, v, do, bias = _sm90_inputs(device, 512, 512, 4, 128, True, seed=4)
    o, lse = fa.flash_attention(q, k, v, bias, True, return_lse=True)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    runs = [(fa.flash_bwd_dq(q, k, v, bias, lse, delta, do, True),
             *fa.flash_bwd_dkv(q, k, v, bias, lse, delta, do, True)) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_forcing_sm90_on_inputs_it_does_not_take_raises(device):
    q, k, v, do, bias = _inputs(device, torch.float32, 1, 128, 128, 2, 64)
    rows = torch.zeros((1, 2, 128), device=device)
    before = _counts()
    with pytest.raises(ValueError, match="does not take"):
        fa.flash_bwd_dq(q, k, v, bias, rows, rows, do, False, _kernel="sm90")
    with pytest.raises(ValueError, match="does not take"):
        fa.flash_bwd_dkv(q, k, v, bias, rows, rows, do, False, _kernel="sm90")
    assert _counts() == before


def test_function_through_the_kernels_matches_the_cpu(device):
    """FlashAttention on the card (kernels) against the same on the CPU
    (plain versions), f32, through autograd."""
    q, k, v, do, bias = _inputs(device, torch.float32, 2, 96, 96, 2, 64, seed=1)
    grads = {}
    for dev in ("cuda", "cpu"):
        leaves = [x.detach().clone().to(dev).requires_grad_() for x in (q, k, v)]
        out = fa.mha(*leaves, fa.AttnSpec(kv_valid=(bias > -1).to(dev), causal=True))
        (out * do.to(dev)).sum().backward()
        grads[dev] = [x.grad.cpu() for x in leaves]
    for got, want in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_rows_with_no_visible_key_get_lse_zero(device):
    q, k, v, do, _ = _inputs(device, torch.bfloat16, 2, 64, 64, 2, 32, seed=2)
    bias = torch.zeros((2, 64), device=device)
    bias[1, :10] = fa.NEG_INF
    _, lse = fa.flash_attention(q, k, v, bias, True, return_lse=True)
    assert (lse[1, :, :10] == 0).all() and (lse[0] != 0).all()
    delta = torch.zeros((2, 2, 64), device=device)
    dq = fa.flash_bwd_dq(q, k, v, bias, lse, delta, do, True)
    assert (dq[1, :10] == 0).all()


def test_wrappers_raise_on_what_the_kernels_do_not_take(device):
    q = torch.zeros((1, 8, 1, 160), device=device, dtype=torch.bfloat16)
    bias = torch.zeros((1, 8), device=device)
    rows = torch.zeros((1, 1, 8), device=device)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_bwd_dq(q, q, q, bias, rows, rows, q, False)
    q = torch.zeros((1, 8, 1, 16), device=device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="delta"):
        fa.flash_bwd_dkv(q, q, q, bias, rows, rows.double(), q, False)
