"""Port's flash-attention lse output and backward (plain versions, CPU)
against tdax's Pallas kernels in interpret mode.

The same numpy inputs go through both packages: tdax's forward with
``return_lse`` and its fused tiled backward (``_build_flash(causal, True,
False)``: the dq and dk/dv kernels), the port's ``flash_attention_plain(...,
return_lse=True)`` and its ``FlashAttention`` autograd Function, which on
CPU tensors runs ``flash_bwd_dq_plain`` and ``flash_bwd_dkv_plain``.
f32 at rtol 2e-4, atol 2e-5, tdax's tolerance for its own fused backward
(tests/test_flash_attention.py:139-140).  On CPU tensors no kernel is
launched and the kernel wrappers refuse the input.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tdax.ops.flash_attention import _build_flash, _flash_impl
import tdax_torch.ops.flash_attention as fa

TOL = dict(rtol=2e-4, atol=2e-5)

SHAPES = [
    # tests/test_flash_attention.py:106-111
    (256, 256, 4, 64, False, None),
    (256, 256, 4, 64, True, None),
    (200, 200, 2, 128, True, 150),
    (130, 130, 4, 128, False, 100),
    # cross-attention, Tq != Tk, the ViT's head dim
    (40, 300, 2, 104, False, 250),
]


def _inputs(seed, b, tq, tk, nh, hd, nvalid):
    rng = np.random.default_rng(seed)
    q, g = (rng.normal(size=(b, tq, nh, hd)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(b, tk, nh, hd)).astype(np.float32) for _ in range(2))
    valid = np.ones((b, tk), np.int32)
    if nvalid is not None:
        valid[:, nvalid:] = 0
    bias = np.where(valid > 0, 0.0, fa.NEG_INF).astype(np.float32)
    return q, k, v, bias, g


def _port_grads(q, k, v, bias, g, causal):
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = fa.FlashAttention.apply(tq, tk, tv, torch.from_numpy(bias), causal)
    (out * torch.from_numpy(g)).sum().backward()
    return out.detach().numpy(), tq.grad.numpy(), tk.grad.numpy(), tv.grad.numpy()


@pytest.mark.parametrize("tq,tk,nh,hd,causal,nvalid", SHAPES)
def test_lse_and_backward_match_tdax_kernels(tq, tk, nh, hd, causal, nvalid):
    b = 2
    q, k, v, bias, g = _inputs(10, b, tq, tk, nh, hd, nvalid)
    counts = (fa.LAUNCHES, fa.BWD_DQ_LAUNCHES, fa.BWD_DKV_LAUNCHES)

    jq, jk, jv, jbias = map(jnp.asarray, (q, k, v, bias))
    j_out, j_lse = _flash_impl(jq, jk, jv, jbias, causal, True, return_lse=True)
    j_lse = np.asarray(j_lse).reshape(b, nh, -1)[..., :tq]
    fused = _build_flash(causal, True, False)
    j_grads = jax.grad(lambda a, c, d: jnp.vdot(fused(a, c, d, jbias), jnp.asarray(g)),
                       argnums=(0, 1, 2))(jq, jk, jv)

    out, lse = fa.flash_attention_plain(*map(torch.from_numpy, (q, k, v, bias)), causal,
                                        return_lse=True)
    assert lse.shape == (b, nh, tq) and lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), **TOL)
    np.testing.assert_allclose(lse.numpy(), j_lse, **TOL)

    f_out, dq, dk, dv = _port_grads(q, k, v, bias, g, causal)
    np.testing.assert_array_equal(f_out, out.numpy())
    for got, want in zip((dq, dk, dv), j_grads):
        np.testing.assert_allclose(got, np.asarray(want), **TOL)
    assert (fa.LAUNCHES, fa.BWD_DQ_LAUNCHES, fa.BWD_DKV_LAUNCHES) == counts


@pytest.mark.parametrize("causal", [False, True])
def test_function_grads_equal_autograd_through_the_reference(causal):
    """FlashAttention's backward (recomputed p, delta, the two plain
    kernels) against torch autograd through the softmax reference."""
    q, k, v, bias, g = _inputs(11, 2, 33, 47 if not causal else 33, 3, 24, 30)
    _, *grads = _port_grads(q, k, v, bias, g, causal)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    add = fa._additive(torch.from_numpy(bias), causal, q.shape[1], k.shape[1])
    ref = fa._reference_mha(tq, tk, tv, add)
    want = torch.autograd.grad((ref * torch.from_numpy(g)).sum(), (tq, tk, tv))
    for got, w in zip(grads, want):
        np.testing.assert_allclose(got, w.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("causal", [False, True])
def test_rows_with_no_visible_key_get_lse_zero_and_no_gradient(causal):
    """Sample 1 masks its first 12 keys: with causal its first 12 rows
    see none; without, sample 0 masks every key.  Those rows get lse 0,
    dq 0, and add nothing to dk and dv (the same dk/dv with their dO
    zeroed)."""
    b, t, nh, hd = 2, 40, 2, 16
    q, k, v, _, g = _inputs(12, b, t, t, nh, hd, None)
    valid = np.ones((b, t), np.int32)
    valid[1, :12] = 0
    if not causal:
        valid[0] = 0
    bias = np.where(valid > 0, 0.0, fa.NEG_INF).astype(np.float32)
    blind = np.zeros((b, t), bool)
    blind[1, :12] = causal
    blind[0] = not causal
    _, lse = fa.flash_attention_plain(*map(torch.from_numpy, (q, k, v, bias)), causal,
                                      return_lse=True)
    lse = lse.numpy().transpose(0, 2, 1)  # [B, T, nh]
    assert (lse[blind] == 0).all() and (lse[~blind] != 0).all()
    _, dq, dk, dv = _port_grads(q, k, v, bias, g, causal)
    assert (dq[blind] == 0).all() and np.abs(dq[~blind]).max() > 0
    g0 = g.copy()
    g0[blind] = 0
    _, _, dk0, dv0 = _port_grads(q, k, v, bias, g0, causal)
    np.testing.assert_array_equal(dk, dk0)
    np.testing.assert_array_equal(dv, dv0)


def test_bf16_plain_backward_casts_like_tdax():
    """bf16: p (for dv) and ds (for dq, dk) are rounded to bf16 before
    their products, which accumulate in f32; outputs are bf16 and near
    the f32 gradients."""
    q, k, v, bias, g = _inputs(13, 2, 48, 48, 2, 32, 40)
    f32 = _port_grads(q, k, v, bias, g, True)
    bf = [torch.from_numpy(x).to(torch.bfloat16).requires_grad_() for x in (q, k, v)]
    out = fa.FlashAttention.apply(*bf, torch.from_numpy(bias), True)
    (out.float() * torch.from_numpy(g)).sum().backward()
    for x, want in zip(bf, f32[1:]):
        assert x.grad.dtype == torch.bfloat16
        np.testing.assert_allclose(x.grad.float().numpy(), want, rtol=5e-2, atol=5e-2)


def test_mha_takes_the_function_only_when_autograd_needs_it():
    q, k, v, _, _ = _inputs(14, 1, 8, 8, 1, 8, None)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    spec = fa.AttnSpec(causal=True)
    assert fa.mha(tq, tk, tv, spec).grad_fn is None
    tq.requires_grad_()
    assert type(fa.mha(tq, tk, tv, spec).grad_fn).__name__ == "FlashAttentionBackward"
    with torch.no_grad():
        assert fa.mha(tq, tk, tv, spec).grad_fn is None
    with torch.inference_mode():
        plain = fa.mha(tq.detach(), tk, tv, spec)
    np.testing.assert_array_equal(plain.numpy(), fa.mha(tq, tk, tv, spec).detach().numpy())


def test_backward_wrappers_refuse_cpu_tensors_and_bad_rows():
    q = torch.zeros((2, 8, 2, 16))
    bias = torch.zeros((2, 8))
    rows = torch.zeros((2, 2, 8))
    counts = (fa.BWD_DQ_LAUNCHES, fa.BWD_DKV_LAUNCHES)
    for fn in (fa.flash_bwd_dq, fa.flash_bwd_dkv):
        with pytest.raises(ValueError, match="CUDA"):
            fn(q, q, q, bias, rows, rows, q, False)
        with pytest.raises(ValueError, match="lse"):
            fn(q, q, q, bias, torch.zeros((2, 8, 2)), rows, q, False)
        with pytest.raises(ValueError, match="dO"):
            fn(q, q, q, bias, rows, rows, torch.zeros((2, 8, 2, 8)), False)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(q, q, q, bias, False, return_lse=True)
    assert (fa.BWD_DQ_LAUNCHES, fa.BWD_DKV_LAUNCHES) == counts
