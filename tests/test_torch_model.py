"""Port's Qwen-VL forward against tdax's on the tiny f32 config.

tdax's random parameters (with noise added to the norm weights and to
every bias, which tdax inits to 1 and 0 and would hide a bias bug) go to
both packages as one numpy tree; the port's copy is made by
``params_from_numpy``.  The visual tower, the decoder capture and the
whole capture entry point agree at rtol = atol = 1e-4 (f32 on both
sides, summed in different orders).  tdax runs once through its Pallas
kernel in interpret mode (TDAX_FLASH_INTERPRET=1) and once through its
einsum path; the port runs its plain attention on the CPU.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tdax.models.qwen_vl import QwenVLConfig as JConfig
from tdax.models.qwen_vl import extract_layer_activations as j_extract
from tdax.models.qwen_vl import forward as j_forward
from tdax.models.qwen_vl import init_params as j_init_params
from tdax.models.qwen_vl.decoder import decoder_capture as j_decoder_capture
from tdax.models.qwen_vl.model import embed_inputs as j_embed_inputs
from tdax.models.qwen_vl.vit import layer_norm as j_layer_norm
from tdax.models.qwen_vl.vit import visual_encode as j_visual_encode

from tdax_torch.models.qwen_vl import QwenVLConfig, extract_layer_activations, forward
from tdax_torch.models.qwen_vl.convert import params_from_numpy
from tdax_torch.models.qwen_vl.decoder import decoder_capture
from tdax_torch.models.qwen_vl.model import embed_inputs, init_params
from tdax_torch.models.qwen_vl.vit import layer_norm, visual_encode
from tdax_torch.ops.vit_elementwise import gelu_tanh

CFG = QwenVLConfig.tiny(dtype="float32")
JCFG = JConfig.tiny(dtype="float32")
TOL = dict(rtol=1e-4, atol=1e-4)


def _noisy(tree, rng):
    """Noise on the norm weights (around 1) and every bias (around 0)."""
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            out[name] = _noisy(leaf, rng)
            continue
        leaf = np.array(leaf, dtype=np.float32)
        if name.startswith("ln") or name.endswith("_b"):
            leaf = leaf + rng.normal(0, 0.1, leaf.shape).astype(np.float32)
        out[name] = leaf
    return out


@pytest.fixture(scope="module")
def params():
    tree = jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(3), JCFG))
    tree = _noisy(tree, np.random.default_rng(0))
    return jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, "cpu", "float32")


@pytest.fixture(params=["interpret", "einsum"])
def tdax_flash(request, monkeypatch):
    """tdax through its Pallas kernel (interpret mode) or its einsum path."""
    if request.param == "interpret":
        monkeypatch.setenv("TDAX_FLASH_INTERPRET", "1")
    else:
        monkeypatch.delenv("TDAX_FLASH_INTERPRET", raising=False)
    return request.param


def _batch(seed=1):
    """Token ids with one image span each, ragged right padding."""
    rng = np.random.default_rng(seed)
    b, t, nq = 3, 40, CFG.visual.n_queries
    ids = rng.integers(1, 257, (b, t)).astype(np.int32)
    mask = np.ones((b, t), np.int32)
    for row, length in enumerate((40, 31, 26)):
        mask[row, length:] = 0
        ids[row, length:] = 0
    pos = np.full((b, nq), -1, np.int32)
    pos[0] = np.arange(3, 3 + nq)
    pos[1] = np.arange(5, 5 + nq)          # sample 2 stays text-only (-1)
    last = np.array([38, 30, 20], np.int32)
    images = rng.normal(size=(b, 3, CFG.visual.image_size, CFG.visual.image_size))
    return ids, mask, last, pos, images.astype(np.float32)


def test_noise_reaches_every_norm_and_bias(params):
    _, tp = params
    assert not torch.equal(tp["layers"]["ln_1"], torch.ones_like(tp["layers"]["ln_1"]))
    assert not torch.equal(tp["visual"]["resampler"]["attn_q_b"],
                           torch.zeros_like(tp["visual"]["resampler"]["attn_q_b"]))


def test_visual_encode_matches_tdax(params, tdax_flash):
    jp, tp = params
    *_, images = _batch()
    want = np.asarray(j_visual_encode(jnp.asarray(images), jp["visual"], JCFG.visual))
    got = visual_encode(torch.from_numpy(images), tp["visual"], CFG.visual).numpy()
    assert got.shape == (3, CFG.visual.n_queries, CFG.visual.output_dim)
    np.testing.assert_allclose(got, want, **TOL)


def test_decoder_capture_matches_tdax(params, tdax_flash):
    jp, tp = params
    ids, mask, last, _, _ = _batch()
    x = np.random.default_rng(2).normal(size=(3, 40, CFG.hidden_size)).astype(np.float32)
    jf, jc = j_decoder_capture(jp["layers"], jnp.asarray(x), JCFG, jnp.asarray(mask),
                               jnp.asarray(last))
    tf, tc = decoder_capture(tp["layers"], torch.from_numpy(x), CFG,
                             torch.from_numpy(mask), torch.from_numpy(last).long())
    assert tc.shape == (CFG.num_layers, 3, CFG.hidden_size)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
    valid = mask > 0  # padded rows attend to padding; compare the real ones
    np.testing.assert_allclose(tf.numpy()[valid], np.asarray(jf)[valid], **TOL)


def test_extract_layer_activations_matches_tdax(params, tdax_flash):
    jp, tp = params
    ids, mask, last, pos, images = _batch()
    want = np.asarray(j_extract(jp, JCFG, *map(jnp.asarray, (ids, mask, last, images, pos))))
    got = extract_layer_activations(
        tp, CFG, torch.from_numpy(ids).long(), torch.from_numpy(mask),
        torch.from_numpy(last).long(), torch.from_numpy(images),
        torch.from_numpy(pos).long()).numpy()
    assert got.shape == (CFG.num_layers, 3, CFG.hidden_size)
    np.testing.assert_allclose(got, want, **TOL)


def test_forward_logits_match_tdax(params):
    """The plain depth loop + ln_f + lm_head (no capture)."""
    jp, tp = params
    ids, mask, _, pos, images = _batch()
    want = np.asarray(j_forward(jp, JCFG, *map(jnp.asarray, (ids, mask, images, pos))))
    got = forward(tp, CFG, torch.from_numpy(ids).long(), torch.from_numpy(mask),
                  torch.from_numpy(images), torch.from_numpy(pos).long()).numpy()
    assert got.shape == (3, 40, CFG.vocab_size) and got.dtype == np.float32
    valid = mask > 0
    np.testing.assert_allclose(got[valid], want[valid], **TOL)


def test_embed_inputs_fuses_image_span_exactly(params):
    """Pad span replaced by the visual tokens; text-only rows untouched."""
    jp, tp = params
    ids, _, _, pos, images = _batch()
    want = np.asarray(j_embed_inputs(jp, JCFG, *map(jnp.asarray, (ids, images, pos))))
    got = embed_inputs(tp, CFG, torch.from_numpy(ids).long(), torch.from_numpy(images),
                       torch.from_numpy(pos).long()).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(got[2], tp["wte"][torch.from_numpy(ids[2]).long()].numpy())


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-4, 4, 41, dtype=np.float32)
    got = gelu_tanh(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.nn.gelu(jnp.asarray(x))), rtol=1e-6, atol=1e-6)
    erf = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(got - erf).max() > 1e-4  # the erf GELU is a different function


def test_layer_norm_population_variance_then_affine():
    rng = np.random.default_rng(4)
    x = rng.normal(2.0, 3.0, (5, 7)).astype(np.float32)
    w = rng.normal(1.0, 0.2, (7,)).astype(np.float32)
    b = rng.normal(0.0, 0.2, (7,)).astype(np.float32)
    want = np.asarray(j_layer_norm(*map(jnp.asarray, (x, w, b)), 1e-6))
    got = layer_norm(*map(torch.from_numpy, (x, w, b)), 1e-6).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_init_params_layout_matches_tdax():
    """Same tree, shapes and dtypes as tdax's init; random numbers from a
    torch.Generator; deterministic sincos tables equal."""
    jtree = jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(0), JCFG))
    tp = init_params(CFG, "cpu", seed=0)

    def walk(j, t, path=""):
        assert set(j) == set(t), path
        for name in j:
            if isinstance(j[name], dict):
                walk(j[name], t[name], path + name + "/")
            else:
                assert tuple(t[name].shape) == j[name].shape, path + name
                assert t[name].dtype == torch.float32
    walk(jtree, tp)
    for name in ("q_pos", "kv_pos"):
        np.testing.assert_allclose(tp["visual"]["resampler"][name].numpy(),
                                   jtree["visual"]["resampler"][name], rtol=1e-6, atol=1e-6)
    again = init_params(CFG, "cpu", seed=0)
    assert torch.equal(again["layers"]["attn_qkv_w"], tp["layers"]["attn_qkv_w"])
    assert not torch.equal(init_params(CFG, "cpu", seed=1)["layers"]["attn_qkv_w"],
                           tp["layers"]["attn_qkv_w"])
