"""Port's flash attention (plain version, CPU) against tdax's Pallas
kernel in interpret mode and tdax's reference einsum path.

The same numpy inputs go through both packages.  f32 at rtol = atol =
2e-5, as tdax's own kernel test; query rows with no visible key are
undefined on every path and are only checked to be finite.  On CPU
tensors the CUDA kernel is never launched: its counter stays put and
the wrapper refuses CPU tensors instead of falling back.
"""

import math

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tdax.ops.flash_attention import AttnSpec as JAttnSpec
from tdax.ops.flash_attention import NEG_INF as J_NEG_INF
from tdax.ops.flash_attention import _get_flash, _reference_mha
import tdax_torch.ops.flash_attention as fa

SHAPES = [
    # the shapes of tests/test_flash_attention.py::test_flash_matches_reference
    (40, 40, 2, 16, True),
    (40, 40, 2, 16, False),
    (8, 40, 2, 20, False),
    (130, 130, 1, 128, True),
    (16, 260, 1, 32, False),
    (64, 192, 2, 128, False),
    (256, 256, 2, 128, True),
    (1024, 1024, 1, 128, True),
    (128, 640, 2, 128, True),
    # the ViT's head dim (1664 / 16), not a power of two
    (70, 70, 2, 104, True),
    (24, 300, 2, 104, False),
]


def _inputs(seed, b, tq, tk, nh, hd):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, tq, nh, hd)).astype(np.float32)
    k = rng.normal(size=(b, tk, nh, hd)).astype(np.float32)
    v = rng.normal(size=(b, tk, nh, hd)).astype(np.float32)
    valid = np.ones((b, tk), np.int32)
    valid[0, tk - 7:] = 0                      # ragged sample
    valid[1, : rng.integers(1, tk)] = 0        # leading keys masked: some rows see none
    return q, k, v, valid


def _visible_rows(valid, tq, tk, causal):
    """[B, Tq] True where the query row sees at least one valid key."""
    keyed = np.broadcast_to(valid[:, None, :] > 0, (valid.shape[0], tq, tk))
    if causal:
        keyed = keyed & np.tril(np.ones((tq, tk), bool))[None]
    return keyed.any(-1)


def _port(q, k, v, valid, causal):
    spec = fa.AttnSpec(kv_valid=torch.from_numpy(valid), causal=causal)
    out = fa.mha(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), spec)
    return out.numpy()


@pytest.mark.parametrize("tq,tk,nh,hd,causal", SHAPES)
def test_port_plain_matches_tdax_kernel_and_reference(tq, tk, nh, hd, causal):
    q, k, v, valid = _inputs(0, 2, tq, tk, nh, hd)
    launches = fa.LAUNCHES
    got = _port(q, k, v, valid, causal)
    assert fa.LAUNCHES == launches  # CPU tensors never reach the kernel

    jq, jk, jv, jvalid = map(jnp.asarray, (q, k, v, valid))
    bias = jnp.where(jvalid > 0, 0.0, J_NEG_INF).astype(jnp.float32)
    kernel = np.asarray(_get_flash(causal, True)(jq, jk, jv, bias))
    ref = np.asarray(_reference_mha(
        jq, jk, jv, JAttnSpec(kv_valid=jvalid, causal=causal).additive(tq, tk, 2)))

    assert got.shape == (2, tq, nh, hd) and got.dtype == np.float32
    assert np.isfinite(got).all()
    rows = _visible_rows(valid, tq, tk, causal)
    assert rows.any()
    np.testing.assert_allclose(got[rows], kernel[rows], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got[rows], ref[rows], rtol=2e-5, atol=2e-5)


def test_plain_version_applies_bias_and_causal_mask():
    """flash_attention_plain on an explicit bias equals mha's spec path."""
    q, k, v, valid = _inputs(1, 2, 33, 33, 2, 16)
    bias = torch.from_numpy(np.where(valid > 0, 0.0, fa.NEG_INF).astype(np.float32))
    got = fa.flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), bias, True).numpy()
    want = _port(q, k, v, valid, True)
    np.testing.assert_array_equal(got, want)


def test_fully_masked_rows_finite():
    q, k, v, _ = _inputs(4, 2, 8, 8, 1, 8)
    valid = np.zeros((2, 8), np.int32)  # nothing valid at all
    out = _port(q, k, v, valid, False)
    assert np.isfinite(out).all()


def test_bf16_plain_version_casts_probabilities():
    """bf16 inputs: f32 logits and softmax, probabilities cast to bf16
    before the PV product, output in bf16 (tdax's _reference_mha)."""
    q, k, v, valid = _inputs(5, 2, 16, 24, 2, 16)
    tq, tk = 16, 24
    bf = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)]
    got = fa.mha(*bf, fa.AttnSpec(kv_valid=torch.from_numpy(valid)))
    assert got.dtype == torch.bfloat16
    jbf = [jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)]
    want = _reference_mha(*jbf, JAttnSpec(kv_valid=jnp.asarray(valid)).additive(tq, tk, 2))
    rows = _visible_rows(valid, tq, tk, False)
    np.testing.assert_allclose(got.float().numpy()[rows],
                               np.asarray(want.astype(jnp.float32))[rows],
                               rtol=1e-2, atol=1e-2)


def test_wrapper_refuses_cpu_tensors():
    """flash_attention launches the kernel or raises; it never falls
    back to the plain version."""
    q, k, v, valid = _inputs(6, 2, 8, 8, 1, 8)
    bias = torch.zeros((2, 8), dtype=torch.float32)
    launches = fa.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                           bias, False)
    assert fa.LAUNCHES == launches


@pytest.mark.parametrize("case", ["head_dim", "dtype", "bias_shape", "bias_dtype",
                                  "kv_shape", "strided_last_dim"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    """Input checks run before the device check, so they raise here too."""
    q = torch.zeros((2, 8, 2, 16))
    k = v = torch.zeros((2, 12, 2, 16))
    bias = torch.zeros((2, 12))
    if case == "head_dim":
        q = torch.zeros((2, 8, 2, 160))
        k = v = torch.zeros((2, 12, 2, 160))
    elif case == "dtype":
        q, k, v = (x.to(torch.float16) for x in (q, k, v))
    elif case == "bias_shape":
        bias = torch.zeros((2, 8))
    elif case == "bias_dtype":
        bias = bias.double()
    elif case == "kv_shape":  # v may be narrower than k (latent attention), not shorter
        v = torch.zeros((2, 10, 2, 16))
    else:
        q = torch.zeros((2, 8, 2, 32))[..., ::2]
    with pytest.raises((ValueError, TypeError)) as info:
        fa.flash_attention(q, k, v, bias, False)
    assert "CUDA device" not in str(info.value)


def test_mha_rejects_additive_masks():
    q = torch.zeros((1, 4, 1, 8))
    with pytest.raises(TypeError):
        fa.mha(q, q, q, torch.zeros((1, 1, 4, 4)))


def _split_kv_decode(q, k, v, bias, causal, warps, p_dtype=None):
    """flash_decode_sm90.cu's arithmetic in PyTorch, f32: per (b, h) the keys
    cut into 2 x ``warps`` contiguous splits of ceil(Tk / splits) rounded up
    to DECODE_KEYS_AT_ONCE; each split walks its keys in groups of that
    many, one running max a group (from NEG_INF), alpha = exp(m - m'), p =
    exp(s - m') (rounded to ``p_dtype`` for PV, as the kernel rounds to
    bf16), l and acc rescaled; then the splits merge in split order with
    w_s = exp(m_s - M), out = sum acc_s w_s / sum l_s w_s (l == 0 -> 1), lse
    = M + log(L), 0 when M is NEG_INF or L == 0."""
    b, _, nh, hd = q.shape
    tk = 1 if causal else k.shape[1]
    at_once = fa.DECODE_KEYS_AT_ONCE
    splits = 2 * warps
    chunk = math.ceil(math.ceil(tk / splits) / at_once) * at_once  # keys a split
    scale = 1.0 / np.sqrt(hd)
    s_all = torch.einsum("bhd,bkhd->bhk", q[:, 0].float(), k[:, :tk].float()) * scale
    s_all = s_all + bias[:, None, :tk]
    out = torch.empty((b, nh, hd))
    lse = torch.empty((b, nh))
    for bi in range(b):
        for h in range(nh):
            ms, ls, accs = [], [], []
            for sp in range(splits):
                m, l, acc = torch.tensor(fa.NEG_INF), torch.tensor(0.0), torch.zeros(hd)
                for k0 in range(sp * chunk, min(sp * chunk + chunk, tk), at_once):
                    keys = range(k0, min(k0 + at_once, sp * chunk + chunk, tk))
                    sc = s_all[bi, h, list(keys)]
                    mx = torch.maximum(m, sc.max())
                    alpha = torch.exp(m - mx)
                    p = torch.exp(sc - mx)
                    pv = p.to(p_dtype).float() if p_dtype is not None else p
                    l = l * alpha + p.sum()
                    acc = acc * alpha + pv @ v[bi, list(keys), h].float()
                    m = mx
                ms.append(m)
                ls.append(l)
                accs.append(acc)
            mm = torch.stack(ms).max()
            w = torch.exp(torch.stack(ms) - mm)
            big_l = (torch.stack(ls) * w).sum()
            out[bi, h] = (torch.stack(accs) * w[:, None]).sum(0) / (1.0 if big_l == 0 else big_l)
            lse[bi, h] = 0.0 if (big_l == 0 or mm <= fa.NEG_INF) else mm + torch.log(big_l)
    return out[:, None], lse[..., None]


@pytest.mark.parametrize("causal", [False, True])
def test_the_split_kv_merge_matches_tdax_attention(causal):
    """The decode kernel's split-KV merge, written out above, against
    tdax's reference einsum attention (its decode path) at a small decode
    shape with 8 splits of 8 keys over 40 keys: split 1's keys all masked
    on every row, splits 5 to 7 empty, one row whose only visible keys sit
    in split 0 (masked splits must merge to exactly nothing), and the
    decode step's own mask (each row's keys up to its position).  f32 at
    tdax's kernel tolerance; lse against the plain version's."""
    rng = np.random.default_rng(4)
    b, tk, nh, hd = 3, 40, 2, 16
    q = rng.normal(size=(b, 1, nh, hd)).astype(np.float32)
    k = rng.normal(size=(b, tk, nh, hd)).astype(np.float32)
    v = rng.normal(size=(b, tk, nh, hd)).astype(np.float32)
    valid = (np.arange(tk)[None] <= np.array([39, 30, 5])[:, None]).astype(np.int32)
    valid[:, 8:16] = 0
    warps = 4  # 8 splits of 8 keys: split 1 masked, splits 5-7 empty
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    bias = torch.where(torch.from_numpy(valid) > 0, 0.0, fa.NEG_INF).to(torch.float32)
    got, lse = _split_kv_decode(qt, kt, vt, bias, causal, warps)

    jq, jk, jv, jvalid = map(jnp.asarray, (q, k, v, valid))
    want = np.asarray(_reference_mha(
        jq, jk, jv, JAttnSpec(kv_valid=jvalid, causal=causal).additive(1, tk, 2)))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    _, lse_plain = fa.flash_attention_plain(qt, kt, vt, bias, causal, return_lse=True)
    np.testing.assert_allclose(lse.numpy(), lse_plain.numpy(), rtol=1e-6, atol=1e-6)

    # with p rounded to bf16 before PV, as the kernel does: within the bf16
    # plain version's rounding of the probabilities
    got_bf16, _ = _split_kv_decode(qt, kt, vt, bias, causal, warps, torch.bfloat16)
    np.testing.assert_allclose(got_bf16.numpy(), want, rtol=1e-2, atol=1e-2)


def test_a_row_that_sees_no_key_merges_to_lse_zero():
    """Every key masked: each split ends at m = NEG_INF, the merge weights
    are all 1, lse is 0 and the output finite (the plain version's
    uniform mean over the keys, as a single pass gives)."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               for s in ((2, 1, 2, 16), (2, 24, 2, 16), (2, 24, 2, 16)))
    bias = torch.full((2, 24), fa.NEG_INF)
    got, lse = _split_kv_decode(q, k, v, bias, False, 4)
    want, lse_plain = fa.flash_attention_plain(q, k, v, bias, False, return_lse=True)
    assert (lse == 0).all() and (lse_plain == 0).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5, atol=2e-5)
