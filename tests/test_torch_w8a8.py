"""The port's W8A8 serving mode (int8 activations x int8 weights) against
tdax's, on the CPU.

Inputs come from numpy seeds and go to both packages.  ``qdot`` under
W8A8 is compared bitwise: the port computes tdax's arithmetic step for
step (per-token abs-max scale over the last axis, division by a tensor
127, round half to even, clip, the exact int32 product, (acc * s_x) * s,
one cast), and every step is exact or one correctly rounded f32
operation on both sides.  The padded route the card takes
(``int8_mm_padded``) is held bitwise against the unpadded product.

The tiny model under W8A8, an int8 tree in tdax's layout given to both
packages (``params_from_numpy`` for the port): every int8 product of the
port's forward,
capture, pipeline and ``generate`` is held bitwise against tdax's
``qdot`` on the same input (``checked``), and their count against the
model's.  End to end the two packages' values differ upstream of each
quantization by f32 summation order (~1e-6), and where an activation
lies that close to an int8 rounding boundary it lands a level apart
(1/127 of its row's max), which the later layers carry on.  So logits
and captures are held within tdax's own bound between
W8A8 and the weight-only product, 2e-2 of the largest value
(tests/test_quantize.py), and greedy tokens exactly.

The switch is process-global in both packages, so every test that turns
it on turns it off again (the ``w8a8`` fixture, ``monkeypatch``).  tdax
reads it when a program is traced: its jitted ``generate`` runs here
with ``max_new_tokens=7``, which no other test uses, so no trace of
either mode is reused by the other.
"""

import importlib.util
from pathlib import Path

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
from tdax.models.qwen_vl.generate import generate as j_generate
from tdax.models.qwen_vl.quantize import qdot as j_qdot
from tdax.models.qwen_vl.quantize import quantize_params as j_quantize_params
from tdax.models.qwen_vl.quantize import quantize_weight as j_quantize_weight
from tdax.models.qwen_vl.quantize import set_w8a8 as j_set_w8a8
from tdax.pipeline.extract import extract_activations as j_extract_activations

from tdax_torch.config import DatasetConfig, ExtractConfig
from tdax_torch.data.dataset import generate_dataset
from tdax_torch.models.qwen_vl import QwenVLConfig, extract_layer_activations, forward
from tdax_torch.models.qwen_vl import decoder, model, vit
from tdax_torch.models.qwen_vl.convert import params_from_numpy
from tdax_torch.models.qwen_vl.generate import generate
from tdax_torch.models.qwen_vl.model import init_params
from tdax_torch.models.qwen_vl.quantize import (embed_lookup, is_quantized, qdot,
                                                quantize_activations, quantize_params,
                                                quantize_weight, set_w8a8, w8a8_enabled)
from tdax_torch.ops import quant_matmul as qm
from tdax_torch.pipeline.extract import extract_activations

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

CFG = QwenVLConfig.tiny(dtype="float32")
JCFG = JConfig.tiny(dtype="float32")
W8A8_REL_TOL = 2e-2  # of the largest value: tdax's W8A8 bound (see the docstring)
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture
def w8a8():
    """W8A8 on in both packages for the test, off after it."""
    set_w8a8(True)
    j_set_w8a8(True)
    try:
        yield
    finally:
        set_w8a8(False)
        j_set_w8a8(False)


@pytest.fixture
def checked(monkeypatch):
    """Every int8 product of the port's model code, held bitwise against
    tdax's ``qdot`` on the same input and weight; returns their list."""
    seen = []

    def check(x, w):
        out = qdot(x, w)
        if is_quantized(w):
            jw = {"q": jnp.asarray(w["q"].numpy()), "s": jnp.asarray(w["s"].numpy())}
            want = np.asarray(j_qdot(jnp.asarray(x.numpy()), jw))
            np.testing.assert_array_equal(out.numpy(), want)
            seen.append(tuple(x.shape))
        return out
    for module in (decoder, vit, model):  # generate's LM head is model.lm_logits
        monkeypatch.setattr(module, "qdot", check)
    return seen


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=W8A8_REL_TOL * np.abs(want).max())


def _products(cfg, images: bool, lm_head: bool) -> int:
    """int8 products of one forward: the ViT (patch embedding, four a
    block), the resampler (kv, q, k, v, out) and the projection; five a
    decoder layer; the LM head."""
    visual = 1 + 4 * cfg.visual.layers + 5 + 1 if images else 0
    return visual + 5 * cfg.num_layers + int(lm_head)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("xshape", [(1, 588), (7, 588), (16, 588), (2, 7, 588), (3, 5, 64)])
def test_qdot_matches_tdax_bitwise(w8a8, dtype, xshape):
    rng = np.random.default_rng(sum(xshape))
    x = rng.normal(size=xshape).astype(np.float32)
    x.reshape(-1, xshape[-1])[0] = 0.0  # an all-zero row: s_x clamps to 1e-12
    w = (rng.normal(size=(xshape[-1], 40)) / np.sqrt(xshape[-1])).astype(np.float32)
    tdt, jdt = DTYPES[dtype]
    want = np.asarray(j_qdot(jnp.asarray(x, jdt), j_quantize_weight(jnp.asarray(w))))
    tw = quantize_weight(torch.from_numpy(w))
    np.testing.assert_array_equal(tw["q"].numpy(), np.asarray(j_quantize_weight(w)["q"]))
    before = qm.LAUNCHES_INT8, qm.LAUNCHES
    got = qdot(torch.from_numpy(x).to(tdt), tw)
    assert (qm.LAUNCHES_INT8, qm.LAUNCHES) == (before[0] + 1, before[1])
    assert got.dtype == tdt and tuple(got.shape) == xshape[:-1] + (40,)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    assert not got.reshape(-1, 40)[0].any()


def test_quantize_activations_scales_and_rounding():
    """Half-way quotients round to even; the clip holds at +-127; a zero
    row keeps s_x = 1e-12 and q = 0."""
    x = torch.tensor([[127.0, 0.5, 1.5, -2.5, -127.0], [0.0] * 5, [254.0, 1.0, 3.0, -1.0, 0.0]])
    q, s_x = quantize_activations(x)
    assert q.dtype == torch.int8 and s_x.dtype == torch.float32 and s_x.shape == (3, 1)
    np.testing.assert_array_equal(q.numpy(), [[127, 0, 2, -2, -127], [0] * 5,
                                              [127, 0, 2, 0, 0]])
    assert s_x[1, 0].item() == pytest.approx(1e-12)


@pytest.mark.parametrize("m,k,n", [(1, 588, 40), (16, 72, 1664), (5, 13, 11), (33, 592, 24),
                                   (40, 64, 48)])
def test_int8_mm_padded_route_equals_the_product(m, k, n):
    """The card's route (rows to 32 at M <= 16, K and N to multiples of 8,
    the weight column-major) against the unpadded product and int64."""
    rng = np.random.default_rng(m * k + n)
    a = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8))
    b = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8))
    got = qm.int8_mm_padded(a, b)
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got, torch._int_mm(a, b))
    assert torch.equal(got.long(), a.long() @ b.long())
    col_major = b.t().contiguous().t()  # taken as it is, no copy
    assert torch.equal(qm.int8_mm_padded(a, col_major), got)
    # the extremes: |acc| = K * 127^2 at the largest K of the model
    big = torch.full((2, 11008), -127, dtype=torch.int8)
    assert qm.int8_mm_padded(big, torch.full((11008, 8), -127, dtype=torch.int8))[0, 0] == (
        11008 * 127 * 127)


def test_int8_mm_padded_keeps_one_column_major_copy_per_weight():
    """The card's route keeps each weight's column-major copy: one per
    layer view of a stacked weight, made again after a write to it,
    dropped with the weight."""
    import gc
    rng = np.random.default_rng(8)
    stacked = torch.from_numpy(rng.integers(-127, 128, (3, 20, 12)).astype(np.int8))
    xq = torch.from_numpy(rng.integers(-127, 128, (5, 20)).astype(np.int8))
    for _ in range(2):
        for i in range(3):
            got = qm.int8_mm_padded(xq, stacked[i])
            assert torch.equal(got.long(), xq.long() @ stacked[i].long())
    assert len(qm._COLUMN_MAJOR[stacked]) == 3
    stacked[1].add_(1)  # in place: the copy of layer 1 is stale
    assert torch.equal(qm.int8_mm_padded(xq, stacked[1]).long(), xq.long() @ stacked[1].long())
    del stacked
    gc.collect()
    assert not any(len(v) == 3 for v in qm._COLUMN_MAJOR.values())


def test_int8_mm_counts_products_and_refuses_bad_inputs():
    a = torch.ones((3, 8), dtype=torch.int8)
    b = torch.ones((8, 5), dtype=torch.int8)
    before = qm.LAUNCHES_INT8
    assert torch.equal(qm.int8_mm(a, b), torch.full((3, 5), 8, dtype=torch.int32))
    assert qm.LAUNCHES_INT8 == before + 1
    with pytest.raises(TypeError, match="int8"):
        qm.int8_mm(a.float(), b)
    with pytest.raises(ValueError, match="do not match"):
        qm.int8_mm(a, b[:4])
    with pytest.raises(ValueError, match="unsupported device"):
        qm.int8_mm(a.to("meta"), b.to("meta"))
    assert qm.LAUNCHES_INT8 == before + 1


def test_switch_by_call_and_by_environment(monkeypatch):
    monkeypatch.delenv("TDAX_W8A8", raising=False)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(4, 64)).astype(np.float32))
    w = quantize_weight(torch.from_numpy(rng.normal(size=(64, 96)).astype(np.float32)))
    base = qdot(x, w)
    assert not w8a8_enabled()
    try:
        set_w8a8(True)
        assert w8a8_enabled()
        on = qdot(x, w)
    finally:
        set_w8a8(False)
    assert not w8a8_enabled() and torch.equal(qdot(x, w), base)
    assert not torch.equal(on, base)
    # tdax's own bound between the two modes (tests/test_quantize.py)
    np.testing.assert_allclose(on.numpy(), base.numpy(), atol=2e-2 * base.abs().max().item())
    monkeypatch.setenv("TDAX_W8A8", "1")
    assert w8a8_enabled() and torch.equal(qdot(x, w), on)  # read at each call
    monkeypatch.setenv("TDAX_W8A8", "0")
    assert not w8a8_enabled() and torch.equal(qdot(x, w), base)


def test_fp_weights_and_embeddings_are_unaffected(w8a8):
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(3, 5, 64)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(64, 32)).astype(np.float32))
    before = qm.LAUNCHES_INT8
    assert torch.equal(qdot(x, w), x @ w)
    np.testing.assert_allclose(qdot(x, w).numpy(),
                               np.asarray(j_qdot(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()))),
                               rtol=1e-5, atol=1e-5)
    table = quantize_weight(torch.from_numpy(rng.normal(0, 0.02, (50, 16)).astype(np.float32)))
    ids = torch.from_numpy(rng.integers(0, 50, (3, 7)))
    assert torch.equal(embed_lookup(table, ids, torch.float32),
                       table["q"][ids].float() * table["s"])
    assert qm.LAUNCHES_INT8 == before


# --- the tiny model ---------------------------------------------------------------

def _numpy(tree):
    return {k: _numpy(v) if isinstance(v, dict) else v.numpy() for k, v in tree.items()}


@pytest.fixture(scope="module")
def trees():
    """An int8 tree in tdax's layout as jax arrays, the port's copy of it,
    and the fp tree it was quantized from (numpy).  The values are drawn
    by the port's seeded init (tdax's eager init and quantization cost
    ~16 s a process here; both packages get the same numpy arrays)."""
    fp = _numpy(init_params(CFG, "cpu", seed=3))
    rng = np.random.default_rng(0)
    for name in ("ln_1", "ln_2", "attn_qkv_b"):  # away from 1 and 0, so a bug shows
        fp["layers"][name] = fp["layers"][name] + rng.normal(0, 0.1, fp["layers"][name].shape
                                                            ).astype(np.float32)
    j8 = _numpy(quantize_params(params_from_numpy(fp, "cpu", "float32")))
    assert jax.tree.structure(j8) == jax.tree.structure(jax.eval_shape(
        lambda: j_quantize_params(j_init_params(jax.random.PRNGKey(0), JCFG))))
    return jax.tree.map(jnp.asarray, j8), params_from_numpy(j8, "cpu", "float32"), fp


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


def _torch(ids, mask, last, pos, images):
    return (torch.from_numpy(ids).long(), torch.from_numpy(mask), torch.from_numpy(last).long(),
            torch.from_numpy(pos).long(), torch.from_numpy(images))


def test_forward_and_capture_match_tdax(w8a8, trees, checked):
    """Logits and the capture with the visual tower: every int8 product
    bitwise tdax's on its input, none on the weight-only path."""
    jp, tp, _ = trees
    ids, mask, last, pos, images = _batch()
    t_ids, t_mask, t_last, t_pos, t_images = _torch(ids, mask, last, pos, images)
    before = qm.LAUNCHES_INT8, qm.LAUNCHES
    got = forward(tp, CFG, t_ids, t_mask, t_images, t_pos).numpy()
    assert len(checked) == _products(CFG, True, True)
    want = np.asarray(j_forward(jp, JCFG, *map(jnp.asarray, (ids, mask, images, pos))))
    valid = mask > 0
    _close(got[valid], want[valid])

    acts = extract_layer_activations(tp, CFG, t_ids, t_mask, t_last, t_images, t_pos).numpy()
    assert len(checked) == _products(CFG, True, True) + _products(CFG, True, False)
    assert (qm.LAUNCHES_INT8 - before[0], qm.LAUNCHES - before[1]) == (len(checked), 0)
    want = np.asarray(j_extract_layer_activations(
        jp, JCFG, *map(jnp.asarray, (ids, mask, last, images, pos))))
    assert acts.shape == (CFG.num_layers, 3, CFG.hidden_size)
    _close(acts, want)


def test_extract_pipeline_matches_tdax(w8a8, trees, checked, tmp_path):
    """extract_activations with quantize_int8 on the fp tree under W8A8, in
    both packages, 6 samples at batch 4."""
    _, _, fp = trees
    metadata = generate_dataset(DatasetConfig(data_dir=str(tmp_path / "ds")))[:6]
    want = j_extract_activations(metadata, str(tmp_path / "tdax.pt"), JCFG,
                                 JExtractConfig(model_dir=None, batch_size=4,
                                                quantize_int8=True),
                                 params=jax.tree.map(jnp.asarray, fp), verbose=False)
    got = extract_activations(metadata, str(tmp_path / "port.pt"), CFG,
                              ExtractConfig(batch_size=4, quantize_int8=True),
                              params=params_from_numpy(fp, "cpu", "float32"), device="cpu",
                              verbose=False)
    assert len(checked) == 2 * _products(CFG, True, False)
    for m in metadata:
        _close(np.stack([got[m["id"]]["activations"][f"layer_{i}"]
                         for i in range(CFG.num_layers)]),
               np.stack([want[m["id"]]["activations"][f"layer_{i}"]
                         for i in range(CFG.num_layers)]))


def test_greedy_generate_matches_tdax(w8a8, trees, checked):
    """Ragged prompts, one with an image and two text-only, 7 new tokens,
    f32 caches: identical ids; the prefill's and every decode step's
    products bitwise tdax's."""
    jp, tp, _ = trees
    rng = np.random.default_rng(2)
    ids = rng.integers(1, CFG.vocab_size, (3, 20)).astype(np.int32)
    mask = np.ones((3, 20), np.int32)
    for row, length in enumerate((20, 16, 12)):
        ids[row, length:] = 0
        mask[row, length:] = 0
    pos = np.full((3, CFG.visual.n_queries), -1, np.int32)
    pos[0] = np.arange(2, 2 + CFG.visual.n_queries)
    extra = {"images": rng.normal(size=(3, 3, CFG.visual.image_size, CFG.visual.image_size)
                                  ).astype(np.float32), "image_positions": pos}
    want = np.asarray(j_generate(jp, JCFG, jnp.asarray(ids), jnp.asarray(mask),
                                 max_new_tokens=7, **{k: jnp.asarray(v) for k, v in extra.items()}))
    got = generate(tp, CFG, torch.from_numpy(ids).long(), torch.from_numpy(mask),
                   max_new_tokens=7, **{k: torch.from_numpy(v).long() if v.dtype == np.int32
                                        else torch.from_numpy(v) for k, v in extra.items()})
    # the prefill's forward and its LM head, then 6 steps of 5 a layer + the head
    assert len(checked) == _products(CFG, True, True) + 6 * _products(CFG, False, True)
    np.testing.assert_array_equal(got.numpy(), want)


def test_w8a8_logits_stay_close_to_weight_only(trees):
    """tdax's fidelity bar (tests/test_quantize.py): relative logit drift
    under 0.15 and top-1 agreement above 0.9 against the weight-only
    forward, here with the visual tower too."""
    _, tp, _ = trees
    ids, mask, last, pos, images = _batch(4)
    t_ids, t_mask, _, t_pos, t_images = _torch(ids, mask, last, pos, images)
    base = forward(tp, CFG, t_ids, t_mask, t_images, t_pos).numpy()
    try:
        set_w8a8(True)
        got = forward(tp, CFG, t_ids, t_mask, t_images, t_pos).numpy()
    finally:
        set_w8a8(False)
    valid = mask > 0
    drift = np.abs(got - base)[valid].max() / np.abs(base)[valid].max()
    assert 0 < drift < 0.15, drift
    assert (got.argmax(-1) == base.argmax(-1))[valid].mean() > 0.9


def test_chip_smoke_int8_bounds():
    """The bounds the card's W8A8 phase reports: a capture batch's 359
    products are 128.4 T int8 operations (64.9 ms at 1979 TOP/s), a decode
    step's 161 read 7.10 GB of int8 weights (2.12 ms at 3.35 TB/s); the
    int32 outputs add the rest."""
    sites = chip_smoke.QMM_SITES
    assert sum(s[4] for s in sites) == chip_smoke.QMM_PER_CAPTURE_BATCH == 359
    assert sum(s[5] for s in sites) == chip_smoke.QMM_PER_DECODE_STEP == 161
    ops = sum(2 * m * k * n * per_batch for _, m, k, n, per_batch, _ in sites)
    assert ops == pytest.approx(128.38e12, rel=1e-4)
    assert 1e3 * ops / chip_smoke.INT8_PEAK == pytest.approx(64.87, rel=1e-3)
    weights = sum(k * n * per_step for _, _, k, n, _, per_step in sites)
    assert 1e3 * weights / chip_smoke.HBM_BYTES_PER_S == pytest.approx(2.119, rel=1e-3)
    capture = sum(chip_smoke.w8a8_bound(m, k, n)[0] * pb for _, m, k, n, pb, _ in sites)
    decode = sum(chip_smoke.w8a8_bound(m, k, n)[0] * ps for _, m, k, n, _, ps in sites)
    assert 64.87 < capture < 1.01 * 64.87 and 2.119 < decode < 1.02 * 2.119
    assert chip_smoke.w8a8_bound(16, 4096, 12288)[1] == "bytes"
    assert chip_smoke.w8a8_bound(5120, 4096, 11008)[1] == "operations"
