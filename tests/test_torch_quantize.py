"""The port's int8 weight-only path against tdax's, on the CPU.

Inputs come from numpy seeds and go to both packages.  ``q`` of
``quantize_weight`` is compared exactly (both round half to even on the
same f32 quotients), ``s`` within one ulp.  The plain int8 product
(``quant_matmul_plain``, what every int8 ``qdot`` takes on a CPU tensor)
is held against tdax's Pallas kernel in interpret mode in bf16 at
rtol = atol = 2e-2 (tdax's own ``test_pallas_qmm_interpret_matches_xla``:
bf16 outputs, sums in other orders) and against tdax's ``qdot`` in f32
within 1e-5.  The tiny model's int8 capture and logits, from tdax's own
int8 tree through ``params_from_numpy``, agree within 1e-4 (f32, other
summation orders), as the fp model does in ``test_torch_model.py``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tdax.config import ExtractConfig as JExtractConfig
from tdax.models.qwen_vl import QwenVLConfig as JConfig
from tdax.models.qwen_vl import extract_layer_activations as j_extract_layer_activations
from tdax.models.qwen_vl import forward as j_forward
from tdax.models.qwen_vl import init_params as j_init_params
from tdax.models.qwen_vl.quantize import embed_lookup as j_embed_lookup
from tdax.models.qwen_vl.quantize import init_params_quantized as j_init_params_quantized
from tdax.models.qwen_vl.quantize import qdot as j_qdot
from tdax.models.qwen_vl.quantize import quantize_params as j_quantize_params
from tdax.models.qwen_vl.quantize import quantize_weight as j_quantize_weight
from tdax.models.qwen_vl.quantize import quantized_bytes as j_quantized_bytes
from tdax.ops.quant_matmul import _qmm_bwd as j_qmm_bwd
from tdax.ops.quant_matmul import quant_matmul_interpret
from tdax.pipeline.extract import extract_activations as j_extract_activations

from tdax_torch.config import DatasetConfig, ExtractConfig
from tdax_torch.data.dataset import generate_dataset
from tdax_torch.models.qwen_vl import QwenVLConfig, extract_layer_activations, forward
from tdax_torch.models.qwen_vl.convert import params_from_numpy
from tdax_torch.models.qwen_vl.model import init_params
from tdax_torch.models.qwen_vl.quantize import (embed_lookup, init_params_quantized, is_quantized,
                                                layer_at, qdot, quantize_params, quantize_weight,
                                                quantized_bytes)
from tdax_torch.ops import quant_matmul as qm
from tdax_torch.pipeline.extract import extract_activations

CFG = QwenVLConfig.tiny(dtype="float32")
JCFG = JConfig.tiny(dtype="float32")
TOL = dict(rtol=1e-4, atol=1e-4)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def trees():
    """tdax's fp tree (numpy), tdax's int8 tree, and the port's copies."""
    fp = _np(j_init_params(jax.random.PRNGKey(3), JCFG))
    rng = np.random.default_rng(0)
    for name in ("ln_1", "ln_2"):  # norms away from 1, so a norm bug shows
        fp["layers"][name] = fp["layers"][name] + rng.normal(0, 0.1, fp["layers"][name].shape
                                                            ).astype(np.float32)
    j8 = _np(j_quantize_params(jax.tree.map(jnp.asarray, fp)))
    return fp, j8, params_from_numpy(j8, "cpu", "float32")


def _batch(seed=1):
    rng = np.random.default_rng(seed)
    b, t, nq = 3, 40, CFG.visual.n_queries
    ids = rng.integers(1, 257, (b, t)).astype(np.int32)
    mask = np.ones((b, t), np.int32)
    for row, length in enumerate((40, 31, 26)):
        mask[row, length:] = 0
        ids[row, length:] = 0
    pos = np.full((b, nq), -1, np.int32)
    pos[0] = np.arange(3, 3 + nq)
    pos[1] = np.arange(5, 5 + nq)
    last = np.array([38, 30, 20], np.int32)
    images = rng.normal(size=(b, 3, CFG.visual.image_size, CFG.visual.image_size))
    return ids, mask, last, pos, images.astype(np.float32)


@pytest.mark.parametrize("shape,dtype", [((64, 128), np.float32), ((3, 32, 48), np.float32),
                                         ((588, 40), np.float32), ((96, 24), "bfloat16")])
def test_quantize_weight_matches_tdax(shape, dtype):
    w = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    w[..., 0, 1] = 0.0
    if dtype == "bfloat16":
        jw = jnp.asarray(w, jnp.bfloat16)
        tw = torch.from_numpy(w).to(torch.bfloat16)
    else:
        jw, tw = jnp.asarray(w), torch.from_numpy(w)
    want = _np(j_quantize_weight(jw))
    got = quantize_weight(tw)
    assert got["q"].dtype == torch.int8 and got["s"].dtype == torch.float32
    np.testing.assert_array_equal(got["q"].numpy(), want["q"])
    np.testing.assert_array_max_ulp(got["s"].numpy(), want["s"], maxulp=1)


def test_quantize_weight_zero_column_and_half_way_rounding():
    """An all-zero output channel keeps s = 1e-12 and q = 0; a quotient
    exactly half way rounds to even in both packages."""
    w = np.zeros((4, 3), np.float32)
    w[:, 1] = [127.0, 0.5, 1.5, -2.5]  # s = 1: q = 127, 0, 2, -2
    w[:, 2] = [1.0, -1.0, 0.25, 0.0]
    want = _np(j_quantize_weight(jnp.asarray(w)))
    got = quantize_weight(torch.from_numpy(w))
    np.testing.assert_array_equal(got["q"].numpy(), want["q"])
    np.testing.assert_array_equal(got["q"].numpy()[:, 1], [127, 0, 2, -2])
    assert got["s"][0].item() == pytest.approx(1e-12) and not got["q"][:, 0].any()


@pytest.mark.parametrize("m,k,n", [(8, 256, 128), (130, 256, 384), (64, 512, 256)])
def test_plain_qmm_matches_tdax_interpret_kernel_bf16(m, k, n):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.normal(size=(k, n)).astype(np.float32) / np.sqrt(k)
    jq = j_quantize_weight(jnp.asarray(w))
    want = quant_matmul_interpret(jnp.asarray(x, jnp.bfloat16), jq["q"], jq["s"])
    tq = quantize_weight(torch.from_numpy(w))
    got = qm.quant_matmul_plain(torch.from_numpy(x).to(torch.bfloat16), tq["q"], tq["s"])
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("xshape,n", [((4, 64), 32), ((130, 588), 384), ((2, 3, 64), 48)])
def test_qdot_matches_tdax_f32(xshape, n):
    rng = np.random.default_rng(1)
    x = rng.normal(size=xshape).astype(np.float32)
    w = (rng.normal(size=(xshape[-1], n)) / np.sqrt(xshape[-1])).astype(np.float32)  # fan-in
    want = np.asarray(j_qdot(jnp.asarray(x), j_quantize_weight(jnp.asarray(w))))
    launches = qm.LAUNCHES
    got = qdot(torch.from_numpy(x), quantize_weight(torch.from_numpy(w)))
    assert qm.LAUNCHES == launches  # the CPU takes the plain version
    assert got.shape == xshape[:-1] + (n,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # an fp weight stays a plain product
    np.testing.assert_allclose(qdot(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
                               np.asarray(j_qdot(jnp.asarray(x), jnp.asarray(w))),
                               rtol=1e-5, atol=1e-5)


def test_qmm_raises_where_it_has_no_kernel():
    """No CUDA tensor here: the kernel wrapper refuses a CPU tensor, and
    the dispatch refuses a device it does not know."""
    x = torch.zeros((2, 8))
    w = quantize_weight(torch.ones((8, 4)))
    with pytest.raises(ValueError, match="CUDA"):
        qm.quant_matmul(x, w["q"], w["s"])
    with pytest.raises(TypeError, match="int8"):
        qm.quant_matmul(x, w["q"].float(), w["s"])
    with pytest.raises(ValueError, match="unsupported device"):
        qm.qmm(x.to("meta"), w["q"].to("meta"), w["s"].to("meta"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_lookup_matches_tdax(dtype):
    rng = np.random.default_rng(4)
    table = rng.normal(0, 0.02, (50, 16)).astype(np.float32)
    ids = rng.integers(0, 50, (3, 7)).astype(np.int32)
    jq = j_quantize_weight(jnp.asarray(table))
    want = np.asarray(j_embed_lookup(jq, jnp.asarray(ids), jnp.dtype(dtype)), np.float32)
    tdtype = torch.float32 if dtype == "float32" else torch.bfloat16
    got = embed_lookup(quantize_weight(torch.from_numpy(table)), torch.from_numpy(ids).long(),
                       tdtype)
    assert got.dtype == tdtype
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_quantize_params_matches_tdax_tree(trees):
    fp, j8, _ = trees
    port = quantize_params(params_from_numpy(fp, "cpu", "float32"))

    def walk(j, t, path=""):
        assert set(j) == set(t), path
        for name in j:
            if is_quantized(j[name]):
                assert is_quantized(t[name]), path + name
                np.testing.assert_array_equal(t[name]["q"].numpy(), j[name]["q"])
                np.testing.assert_array_max_ulp(t[name]["s"].numpy(), j[name]["s"], maxulp=1)
            elif isinstance(j[name], dict):
                walk(j[name], t[name], path + name + "/")
            else:
                np.testing.assert_array_equal(t[name].numpy(), j[name])
    walk(j8, port)
    assert is_quantized(port["wte"]) and is_quantized(port["visual"]["proj"])
    assert not is_quantized(port["ln_f"]) and not is_quantized(port["visual"]["pos_embed"])
    assert quantized_bytes(port) == j_quantized_bytes(j8)
    assert quantized_bytes(port) < 0.5 * quantized_bytes(params_from_numpy(fp, "cpu", "float32"))
    again = quantize_params(port)  # already quantized: a no-op
    assert again["layers"]["mlp_w1"]["q"] is port["layers"]["mlp_w1"]["q"]


def test_params_from_numpy_keeps_an_int8_tree(trees):
    """int8 leaves stay int8 and scales stay f32 in a bf16 model; the
    other leaves take the model dtype."""
    _, j8, _ = trees
    tp = params_from_numpy(j8, "cpu", "bfloat16")
    node = tp["layers"]["attn_qkv_w"]
    assert node["q"].dtype == torch.int8 and node["s"].dtype == torch.float32
    np.testing.assert_array_equal(node["q"].numpy(), j8["layers"]["attn_qkv_w"]["q"])
    np.testing.assert_array_equal(node["s"].numpy(), j8["layers"]["attn_qkv_w"]["s"])
    assert tp["visual"]["proj"]["s"].dtype == torch.float32
    assert tp["layers"]["ln_1"].dtype == torch.bfloat16
    bare = params_from_numpy({"w": j8["wte"]["q"]}, "cpu", "float32")
    assert bare["w"].dtype == torch.int8


def test_init_params_quantized_structure():
    """As tdax's test_init_params_quantized_structure, plus: the draws are
    init_params' own, quantized one weight at a time."""
    q = init_params_quantized(CFG, "cpu", seed=0)
    assert is_quantized(q["layers"]["attn_qkv_w"]) and is_quantized(q["wte"])
    assert not is_quantized(q["layers"]["ln_1"])
    assert torch.equal(q["layers"]["ln_1"], torch.ones_like(q["layers"]["ln_1"]))
    assert torch.equal(q["layers"]["attn_qkv_b"], torch.zeros_like(q["layers"]["attn_qkv_b"]))
    jfp = j_init_params(jax.random.PRNGKey(0), JCFG)
    assert tuple(q["layers"]["mlp_w1"]["q"].shape) == jfp["layers"]["mlp_w1"].shape
    assert tuple(q["layers"]["mlp_w1"]["s"].shape) == (CFG.num_layers, CFG.ff_half)
    want = quantize_params(init_params(CFG, "cpu", seed=0))
    for name in ("attn_qkv_w", "mlp_proj_w"):
        assert torch.equal(q["layers"][name]["q"], want["layers"][name]["q"])
        assert torch.equal(q["layers"][name]["s"], want["layers"][name]["s"])
    assert torch.equal(q["visual"]["resampler"]["attn_v_w"]["q"],
                       want["visual"]["resampler"]["attn_v_w"]["q"])
    assert quantized_bytes(q) == j_quantized_bytes(j_quantize_params(jfp))
    ids = torch.from_numpy(np.random.default_rng(5).integers(1, CFG.vocab_size, (1, 8)))
    assert torch.isfinite(forward(q, CFG, ids)).all()


def _keys(tree: dict, prefix: str = "") -> set:
    out = set()
    for name, node in tree.items():
        out |= _keys(node, f"{prefix}{name}/") if isinstance(node, dict) else {prefix + name}
    return out


def test_init_params_quantized_without_visual_is_tdaxs_text_tree():
    """tdax's ``with_visual=False``: no "visual", its key set leaf for
    leaf, and the draws of ``init_params(..., with_visual=False)``
    quantized."""
    q = init_params_quantized(CFG, "cpu", seed=0, with_visual=False)
    assert "visual" not in q
    assert _keys(q) == _keys(j_init_params_quantized(jax.random.PRNGKey(0), JCFG,
                                                     with_visual=False))
    want = quantize_params(init_params(CFG, "cpu", 0, with_visual=False))
    assert _keys(want) == _keys(q)
    flat_q, flat_want = dict(_flat(q)), dict(_flat(want))
    for path, t in flat_want.items():
        assert torch.equal(flat_q[path], t), path
    assert _keys(init_params_quantized(CFG, "cpu", seed=0)) == _keys(
        j_init_params_quantized(jax.random.PRNGKey(0), JCFG))


def _flat(tree: dict, prefix: str = ""):
    for name, node in tree.items():
        if isinstance(node, dict):
            yield from _flat(node, f"{prefix}{name}/")
        else:
            yield prefix + name, node


def test_qmm_backward_matches_tdax_qmm_bwd():
    """dx of ``qmm`` (``QuantMatmul``'s backward) against tdax's
    ``_qmm_bwd`` on the same inputs: tests/test_quantize.py's shapes and
    its 3e-2 tolerance; no gradient for the int8 weight or its scale."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 3, 256)).astype(np.float32)
    w = rng.normal(size=(256, 128)).astype(np.float32) / 16.0
    dy = rng.normal(size=(2, 3, 128)).astype(np.float32)
    jq = j_quantize_weight(jnp.asarray(w))
    jx, jdy = jnp.asarray(x, jnp.bfloat16), jnp.asarray(dy, jnp.bfloat16)
    want, _, _ = j_qmm_bwd((jx, jq["q"], jq["s"]), jdy)
    tq = quantize_weight(torch.from_numpy(w))
    tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    out = qm.qmm(tx, tq["q"], tq["s"])
    assert out.grad_fn is not None and type(out.grad_fn).__name__ == "QuantMatmulBackward"
    out.backward(torch.from_numpy(dy).to(torch.bfloat16))
    assert tx.grad.dtype == torch.bfloat16 and tx.grad.shape == tx.shape
    assert tq["q"].grad is None and tq["s"].grad is None
    np.testing.assert_allclose(tx.grad.float().numpy(), np.asarray(want, np.float32),
                               rtol=3e-2, atol=3e-2)
    ref = np.einsum("btn,kn->btk", dy, tq["q"].float().numpy() * tq["s"].numpy())
    np.testing.assert_allclose(tx.grad.float().numpy(), ref, rtol=3e-2, atol=3e-2)


def test_qmm_without_grad_keeps_the_plain_call():
    x = torch.randn(4, 64, requires_grad=True)
    w = quantize_weight(torch.randn(64, 32))
    with torch.inference_mode():
        out = qm.qmm(x, w["q"], w["s"])
    assert out.grad_fn is None
    assert torch.equal(out, qm.quant_matmul_plain(x.detach(), w["q"], w["s"]))
    assert qm.qmm(x.detach(), w["q"], w["s"]).grad_fn is None


def _dequantized(tree: dict) -> dict:
    """Every {"q", "s"} node as the f32 weight q * s."""
    return {name: (node["q"].float() * node["s"].unsqueeze(-2) if is_quantized(node)
                   else _dequantized(node) if isinstance(node, dict) else node)
            for name, node in tree.items()}


def test_int8_forward_gives_a_gradient_wrt_the_embeddings():
    """An input saliency of the tiny int8 model: every ``qdot`` of the
    decoder and the LM head passes the gradient on to the embeddings,
    equal within TOL to the gradient through the dequantized f32
    weights."""
    from tdax_torch.models.qwen_vl.decoder import decoder, rms_norm
    from tdax_torch.models.qwen_vl.model import embed_inputs, lm_logits
    q = init_params_quantized(CFG, "cpu", seed=3, with_visual=False)
    ids, mask, _, _, _ = _batch()
    ids, mask = torch.from_numpy(ids).long(), torch.from_numpy(mask)

    def saliency(params):
        x = embed_inputs(params, CFG, ids, None, None).detach().requires_grad_()
        h = decoder(params["layers"], x, CFG, mask)
        logits = lm_logits(rms_norm(h, params["ln_f"], CFG.layer_norm_eps), params, CFG)
        logits.logsumexp(-1).sum().backward()
        return x.grad

    got, want = saliency(q), saliency(_dequantized(q))
    assert got is not None and torch.isfinite(got).all() and float(got.abs().max()) > 0
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_layer_at_indexes_quantized_nodes(trees):
    _, _, tp = trees
    layer = layer_at(tp["layers"], 2)
    assert tuple(layer["attn_qkv_w"]["q"].shape) == (CFG.hidden_size, 3 * CFG.hidden_size)
    assert torch.equal(layer["attn_qkv_w"]["s"], tp["layers"]["attn_qkv_w"]["s"][2])
    assert torch.equal(layer["ln_1"], tp["layers"]["ln_1"][2])


def test_int8_capture_matches_tdax(trees):
    """The tiny int8 capture with the visual tower, from tdax's int8 tree."""
    _, j8, tp = trees
    ids, mask, last, pos, images = _batch()
    want = np.asarray(j_extract_layer_activations(
        jax.tree.map(jnp.asarray, j8), JCFG, *map(jnp.asarray, (ids, mask, last, images, pos))))
    got = extract_layer_activations(
        tp, CFG, torch.from_numpy(ids).long(), torch.from_numpy(mask),
        torch.from_numpy(last).long(), torch.from_numpy(images),
        torch.from_numpy(pos).long()).numpy()
    assert got.shape == (CFG.num_layers, 3, CFG.hidden_size)
    np.testing.assert_allclose(got, want, **TOL)


def test_int8_forward_logits_match_tdax(trees):
    _, j8, tp = trees
    ids, mask, _, pos, images = _batch(2)
    want = np.asarray(j_forward(jax.tree.map(jnp.asarray, j8), JCFG,
                                *map(jnp.asarray, (ids, mask, images, pos))))
    got = forward(tp, CFG, torch.from_numpy(ids).long(), torch.from_numpy(mask),
                  torch.from_numpy(images), torch.from_numpy(pos).long()).numpy()
    valid = mask > 0
    np.testing.assert_allclose(got[valid], want[valid], **TOL)


def test_int8_capture_stays_close_to_fp(trees):
    """tdax's fidelity gate (tests/test_quantize.py:60) on the port: the
    minimum cosine per captured vector above 0.98."""
    fp, _, tp = trees
    ids, mask, last, pos, images = (torch.from_numpy(a) for a in _batch(3))
    args = (ids.long(), mask, last.long(), images, pos.long())
    a = extract_layer_activations(params_from_numpy(fp, "cpu", "float32"), CFG, *args)
    b = extract_layer_activations(tp, CFG, *args)
    cos = torch.nn.functional.cosine_similarity(a, b, dim=-1)
    assert cos.min() > 0.98, cos.min()


def test_extract_int8_pipeline_matches_tdax(trees, tmp_path):
    """extract_activations with quantize_int8 on given fp params, in both
    packages, over 6 samples at batch 4."""
    fp, _, _ = trees
    metadata = generate_dataset(DatasetConfig(data_dir=str(tmp_path / "ds")))[:6]
    want = j_extract_activations(metadata, str(tmp_path / "tdax.pt"), JCFG,
                                 JExtractConfig(model_dir=None, batch_size=4,
                                                quantize_int8=True),
                                 params=jax.tree.map(jnp.asarray, fp), verbose=False)
    got = extract_activations(metadata, str(tmp_path / "port.pt"), CFG,
                              ExtractConfig(batch_size=4, quantize_int8=True),
                              params=params_from_numpy(fp, "cpu", "float32"), device="cpu",
                              verbose=False)
    for m in metadata:
        for i in range(CFG.num_layers):
            np.testing.assert_allclose(got[m["id"]]["activations"][f"layer_{i}"],
                                       want[m["id"]]["activations"][f"layer_{i}"], **TOL)
