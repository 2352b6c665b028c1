"""The port's KV-cached generation against tdax's, on the CPU.

The tiny f32 config, with and without images, with tdax's fp tree and
tdax's int8 tree, both converted by ``params_from_numpy``.  Prefill
hidden states and caches, and decode-step logits, agree within 1e-4 (f32
on both sides, summed in other orders); greedy tokens are identical on
tdax's own ragged, EOS-and-pad and one-token cases.  int8 caches: q
within one count (a value 1e-6 from a rounding boundary may round the
other way), s within 1e-5 relative.  Sampling draws from a
``torch.Generator`` where tdax draws from ``jax.random``, so the filters
are held by their support sets and the draws by their frequencies.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tdax.models.qwen_vl import QwenVLConfig as JConfig
from tdax.models.qwen_vl import init_params as j_init_params
from tdax.models.qwen_vl.generate import _decode_step as j_decode_step
from tdax.models.qwen_vl.generate import generate as j_generate
from tdax.models.qwen_vl.generate import prefill as j_prefill
from tdax.models.qwen_vl.generate import sample_logits as j_sample_logits
from tdax.models.qwen_vl.quantize import quantize_params as j_quantize_params

from tdax_torch.models.qwen_vl import QwenVLConfig, forward
from tdax_torch.models.qwen_vl.convert import params_from_numpy
from tdax_torch.models.qwen_vl.generate import (_decode_step, _kv_dequant, filter_logits,
                                                generate, prefill, sample_logits)

CFG = QwenVLConfig.tiny(dtype="float32")
JCFG = JConfig.tiny(dtype="float32")
TOL = dict(rtol=1e-4, atol=1e-4)
T_MAX = 30


@pytest.fixture(scope="module")
def trees():
    """{"fp": (tdax tree, port tree), "int8": (...)}."""
    fp = jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(0), JCFG))
    rng = np.random.default_rng(1)
    for name in ("ln_1", "ln_2", "attn_qkv_b"):  # away from 1 and 0, so a bug shows
        fp["layers"][name] = fp["layers"][name] + rng.normal(0, 0.1, fp["layers"][name].shape
                                                            ).astype(np.float32)
    q8 = jax.tree.map(np.asarray, j_quantize_params(jax.tree.map(jnp.asarray, fp)))
    return {kind: (jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, "cpu", "float32"))
            for kind, tree in (("fp", fp), ("int8", q8))}


def _prompts(images: bool, seed=0):
    """Right-padded prompts of lengths 20, 16 and 12; with images, the
    first two carry an image span and the third is text-only."""
    rng = np.random.default_rng(seed)
    b, t, nq = 3, 20, CFG.visual.n_queries
    ids = rng.integers(1, CFG.vocab_size, (b, t)).astype(np.int32)
    mask = np.ones((b, t), np.int32)
    for row, length in enumerate((20, 16, 12)):
        ids[row, length:] = 0
        mask[row, length:] = 0
    out = {"input_ids": ids, "attn_mask": mask}
    if images:
        pos = np.full((b, nq), -1, np.int32)
        pos[0] = np.arange(2, 2 + nq)
        pos[1] = np.arange(0, nq)
        out["images"] = rng.normal(size=(b, 3, CFG.visual.image_size, CFG.visual.image_size)
                                   ).astype(np.float32)
        out["image_positions"] = pos
    return out


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 and k != "attn_mask"
            else torch.from_numpy(v) for k, v in batch.items()}


def _flat(cache):
    if isinstance(cache, dict):
        return {k: np.asarray(v) for k, v in cache.items()}
    return {"x": np.asarray(cache)}


CASES = [("fp", False), ("fp", True), ("int8", False), ("int8", True)]


@pytest.mark.parametrize("kind,images", CASES)
@pytest.mark.parametrize("kv_int8", [False, True])
def test_prefill_matches_tdax(trees, kind, images, kv_int8):
    jp, tp = trees[kind]
    batch = _prompts(images)
    b = _j(batch)
    jh, jk, jv = j_prefill(jp, JCFG, b.pop("input_ids"), b.pop("attn_mask"), t_max=T_MAX,
                           kv_int8=kv_int8, **b)
    b = _t(batch)
    th, tk, tv = prefill(tp, CFG, b.pop("input_ids"), b.pop("attn_mask"), t_max=T_MAX,
                         kv_int8=kv_int8, **b)
    valid = batch["attn_mask"] > 0
    np.testing.assert_allclose(th.numpy()[valid], np.asarray(jh)[valid], **TOL)
    for want, got in ((jk, tk), (jv, tv)):
        want, got = _flat(want), _flat(got)
        assert set(want) == set(got)
        for key in want:
            assert got[key].shape == want[key].shape and got[key].dtype == want[key].dtype
            w, g = want[key][:, :, :20][:, valid], got[key][:, :, :20][:, valid]
            if key == "q":    # int8 counts: a value at a rounding edge may round either way
                assert np.abs(g.astype(np.int32) - w.astype(np.int32)).max() <= 1
            elif key == "s":
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=0)
            else:
                np.testing.assert_allclose(g, w, **TOL)
            np.testing.assert_array_equal(got[key][:, :, 20:], want[key][:, :, 20:])  # padding


@pytest.mark.parametrize("kind,images", CASES)
@pytest.mark.parametrize("kv_int8", [False, True])
def test_decode_step_matches_tdax(trees, kind, images, kv_int8):
    jp, tp = trees[kind]
    batch = _prompts(images, seed=1)
    lengths = batch["attn_mask"].sum(1).astype(np.int32)
    tok = np.array([5, 77, 300], np.int32)
    b = _j(batch)
    _, jk, jv = j_prefill(jp, JCFG, b.pop("input_ids"), b.pop("attn_mask"), t_max=T_MAX,
                          kv_int8=kv_int8, **b)
    b = _t(batch)
    _, tk, tv = prefill(tp, CFG, b.pop("input_ids"), b.pop("attn_mask"), t_max=T_MAX,
                        kv_int8=kv_int8, **b)
    if kv_int8:
        # the port's int8 caches may hold a count that rounded the other way
        # (test_prefill_matches_tdax), which moves the logits by ~1e-3:
        # the step itself is held on tdax's caches
        tk, tv = ({k: torch.from_numpy(np.array(v)) for k, v in c.items()} for c in (jk, jv))
    jl, jk, jv = j_decode_step(jp, JCFG, jnp.asarray(tok), jnp.asarray(lengths), jk, jv)
    tl, tk2, tv2 = _decode_step(tp, CFG, torch.from_numpy(tok).long(),
                                torch.from_numpy(lengths).long(), tk, tv)
    assert tk2 is tk and tv2 is tv  # updated in place
    assert tl.shape == (3, CFG.vocab_size) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    rows = np.arange(3)
    for want, got in ((jk, tk), (jv, tv)):  # the new rows, at each sample's own position
        w = np.asarray(_kv_dequant_j(want))[:, rows, lengths]
        g = _kv_dequant(got, torch.float32).numpy()[:, rows, lengths]
        np.testing.assert_allclose(g, w, rtol=2e-2 if kv_int8 else 1e-4, atol=2e-2 if kv_int8
                                   else 1e-4)


def _kv_dequant_j(c):
    if isinstance(c, dict):
        return np.asarray(c["q"], np.float32) * np.asarray(c["s"])[..., None]
    return np.asarray(c)


@pytest.mark.parametrize("kind,images", CASES)
@pytest.mark.parametrize("kv_int8", [False, True])
def test_greedy_generate_matches_tdax(trees, kind, images, kv_int8):
    """Ragged prompts, 8 new tokens: identical ids."""
    jp, tp = trees[kind]
    batch = _prompts(images, seed=2)
    b = _j(batch)
    want = np.asarray(j_generate(jp, JCFG, b.pop("input_ids"), b.pop("attn_mask"),
                                 max_new_tokens=8, kv_int8=kv_int8, **b))
    b = _t(batch)
    got = generate(tp, CFG, b.pop("input_ids"), b.pop("attn_mask"), max_new_tokens=8,
                   kv_int8=kv_int8, **b)
    assert got.shape == (3, 8) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", ["fp", "int8"])
def test_generate_eos_pad_and_one_token_match_tdax(trees, kind):
    """tdax's EOS case (an id that occurs mid-stream, pad -1) and
    max_new_tokens=1, with identical ids."""
    jp, tp = trees[kind]
    batch = _prompts(False, seed=3)
    jargs = (jnp.asarray(batch["input_ids"]), jnp.asarray(batch["attn_mask"]))
    targs = (torch.from_numpy(batch["input_ids"]).long(), torch.from_numpy(batch["attn_mask"]))
    base = np.asarray(j_generate(jp, JCFG, *jargs, max_new_tokens=8))
    eos = int(base[0, 3])
    want = np.asarray(j_generate(jp, JCFG, *jargs, max_new_tokens=8, eos_token_id=eos,
                                 pad_token_id=-1))
    got = generate(tp, CFG, *targs, max_new_tokens=8, eos_token_id=eos, pad_token_id=-1)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy()[0, 4:] == -1).all()
    one = generate(tp, CFG, *targs, max_new_tokens=1)
    np.testing.assert_array_equal(one.numpy(), np.asarray(j_generate(jp, JCFG, *jargs,
                                                                     max_new_tokens=1)))


def test_ragged_prompt_generates_as_if_unpadded(trees):
    _, tp = trees["fp"]
    batch = _t(_prompts(False, seed=4))
    ids, mask = batch["input_ids"], batch["attn_mask"]
    for kv_int8 in (False, True):
        gen = generate(tp, CFG, ids, mask, max_new_tokens=4, kv_int8=kv_int8)
        solo = generate(tp, CFG, ids[2:, :12], mask[2:, :12], max_new_tokens=4, kv_int8=kv_int8)
        torch.testing.assert_close(gen[2], solo[0], rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["fp", "int8"])
def test_greedy_matches_incremental_full_forward(trees, kind):
    """The cached decode against re-running the uncached forward (tdax's
    test_greedy_matches_incremental_full_forward)."""
    _, tp = trees[kind]
    ids = torch.from_numpy(np.random.default_rng(0).integers(1, CFG.vocab_size, (2, 10)))
    mask = torch.ones_like(ids)
    gen = generate(tp, CFG, ids, mask, max_new_tokens=6)
    cur = ids
    for step in range(6):
        nxt = forward(tp, CFG, cur)[:, -1].argmax(-1)
        torch.testing.assert_close(gen[:, step], nxt, rtol=0, atol=0)
        cur = torch.cat([cur, nxt[:, None]], dim=1)


def test_kv_int8_decode_logits_close_to_fp_caches(trees):
    """tdax's gate (tests/test_generate.py:94): < 0.05 * max|logit|."""
    _, tp = trees["fp"]
    b = _t(_prompts(False, seed=5))
    lengths = b["attn_mask"].sum(1)
    tok = b["input_ids"][:, 0]
    logits = {}
    for kv_int8 in (False, True):
        _, ks, vs = prefill(tp, CFG, b["input_ids"], b["attn_mask"], t_max=T_MAX,
                            kv_int8=kv_int8)
        logits[kv_int8], ks, _ = _decode_step(tp, CFG, tok, lengths, ks, vs)
        if kv_int8:
            assert ks["q"].dtype == torch.int8
    scale = logits[False].abs().max()
    assert (logits[True] - logits[False]).abs().max() < 0.05 * scale


LOGITS = np.array([[0.0, 3.0, 1.0, 2.5, -1.0],
                   [5.0, 0.0, 0.1, 0.2, 0.3]], np.float32)


def _tdax_support(temperature, top_k=0, top_p=1.0, n=300):
    draws = np.stack([np.asarray(j_sample_logits(jnp.asarray(LOGITS), jax.random.PRNGKey(s),
                                                 temperature, top_k=top_k, top_p=top_p))
                      for s in range(n)])
    return [set(draws[:, r].tolist()) for r in range(LOGITS.shape[0])]


@pytest.mark.parametrize("temperature,top_k,top_p", [(3.0, 3, 1.0), (1.0, 0, 0.7),
                                                     (2.0, 4, 0.9), (1.0, 0, 1e-6),
                                                     (5.0, 1, 1.0)])
def test_filter_support_matches_tdax(temperature, top_k, top_p):
    kept = torch.isfinite(filter_logits(torch.from_numpy(LOGITS), temperature, top_k, top_p))
    port = [set(np.flatnonzero(row).tolist()) for row in kept.numpy()]
    assert port == _tdax_support(temperature, top_k, top_p)


def test_temperature_zero_is_argmax():
    logits = torch.from_numpy(np.random.default_rng(0).normal(size=(6, 50)).astype(np.float32))
    got = sample_logits(logits, torch.Generator().manual_seed(0), 0.0, top_k=3, top_p=0.5)
    torch.testing.assert_close(got, logits.argmax(-1), rtol=0, atol=0)


@pytest.mark.parametrize("temperature,top_k,top_p", [(1.0, 0, 1.0), (3.0, 3, 1.0),
                                                     (1.0, 0, 0.7), (2.0, 4, 0.9)])
def test_sampled_frequencies_follow_filtered_softmax(temperature, top_k, top_p):
    """20,000 draws a row: each token's frequency within 0.02 of the
    softmax of the filtered logits (the standard error is at most 0.0036)."""
    gen = torch.Generator().manual_seed(11)
    logits = torch.from_numpy(LOGITS).repeat(20_000, 1)
    draws = sample_logits(logits, gen, temperature, top_k, top_p).reshape(20_000, 2)
    probs = torch.softmax(filter_logits(torch.from_numpy(LOGITS), temperature, top_k, top_p), -1)
    for r in range(2):
        freq = torch.bincount(draws[:, r], minlength=LOGITS.shape[1]).double() / 20_000
        assert (freq - probs[r].double()).abs().max() < 0.02
        assert (freq[probs[r] == 0] == 0).all()


def test_sampled_generate_follows_its_generator(trees):
    _, tp = trees["fp"]
    b = _t(_prompts(False, seed=6))
    kw = dict(max_new_tokens=6, temperature=1.0, top_k=5, top_p=0.9)
    a = generate(tp, CFG, b["input_ids"], b["attn_mask"],
                 generator=torch.Generator().manual_seed(3), **kw)
    again = generate(tp, CFG, b["input_ids"], b["attn_mask"],
                     generator=torch.Generator().manual_seed(3), **kw)
    other = generate(tp, CFG, b["input_ids"], b["attn_mask"],
                     generator=torch.Generator().manual_seed(4), max_new_tokens=6,
                     temperature=1.0)
    torch.testing.assert_close(a, again, rtol=0, atol=0)
    assert a.shape == other.shape == (3, 6)
    assert ((a >= 0) & (a < CFG.vocab_size)).all()
