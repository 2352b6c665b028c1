"""The port's FSDP (ZeRO-3) training and hybrid dcn x dp x tp mesh against
tdax's, on the CPU (tdax's dry-run stages 11 and 12).

tdax runs its sharded ``jit`` on the conftest's 8 virtual XLA devices;
the port runs a gloo world of 8 ranks and a world of one
(``torch_parallel_worlds``), each spawned once per test session.  Both
take the same numpy trees (tdax's tiny f32 init, text-only unless named,
every bias and norm moved off 0 and 1) and the same batches (numpy
seeds), AdamW at lr 1e-3 with the global-norm clip, remat on.  Checks
and their tolerances:

  * the rules: the port's ``fsdp_sharding_rules`` equal tdax's, tuple for
    tuple, on the tiny tree with and without ``visual``; on a mesh they
    read its dp (a hybrid mesh's within-slice dp) and equal the ``dp=``
    form (tests/test_parallel.py's mesh test);
  * the FSDP step at dp=4 tp=2 (tests/test_parallel.py's FSDP test)
    against tdax's FSDP step: the loss within rtol 1e-5, the updated
    params within rtol 1e-3 and atol 1e-5 (tdax's tolerance for its
    sequence-parallel step: Adam's m / sqrt(v) turns a gradient's
    summation-order noise near zero into a visible step);
    ``layers/attn_qkv_w`` and both its moments at 1/8 a rank; the
    collectives: every dp-sharded weight gathered once in the forward and
    once more in remat's replay, its gradient reduce-scattered once;
  * with ``sp_mesh`` against tdax's FSDP step with ``sp_mesh`` (tdax
    runs it), and with images against tdax's one-device step with images
    (tdax's FSDP step with images intermittently stalls XLA's CPU
    collectives on the 8 virtual devices: an all_gather over 4 devices
    and a collective-permute over 8 wait on each other past XLA's 40 s
    rendezvous limit, which aborts the process): the loss as above,
    AdamW's first moment (a tenth of the clipped gradient) within 1e-4
    relative plus 1e-5 of each leaf's largest magnitude, as
    tests/test_torch_parallel_train.py holds its images step, since
    there Adam's near-sign first step turns a gradient's noise into a
    visible update: the resampler's key bias and the key third of the
    ViT's qkv bias have a gradient that is zero in exact arithmetic
    (softmax does not change when a row's scores move by one constant;
    1.4e-2 relative in the params), those moments below 1e-6 of the
    largest moment on both sides; under ``sp_mesh`` one entry of
    ``attn_proj_w`` has a gradient of 5e-9, at Adam's eps of 1e-8
    (2.3e-3 relative in the params, its moment within 1.7e-6 of the
    largest);
  * accumulation (2 microbatches) with FSDP and remat at dp=2 tp=4
    against tdax's (tests/test_parallel.py's composition test): the same
    tolerances;
  * the hybrid mesh at dcn=2 dp=2 tp=2: the FSDP step against tdax's
    (tests/test_parallel.py's hybrid test), the same tolerances,
    ``attn_qkv_w`` at 1/4 a rank (1/dp within a slice, replicated over
    dcn), every weight gather over dp and the gradients' cross-slice
    sums over dcn, no gather over dcn; the capture at that mesh against
    tdax's one-device capture within tdax's stage-1 / stage-12 capture
    tolerance, rtol 2e-3 and atol 5e-3 (the tp sums reorder, as in
    tests/test_torch_parallel_serve.py); ``make_hybrid_mesh``'s two
    refusals, as tdax's;
  * ``train_loop(param_shardings=)`` stopped after its first checkpoint
    and resumed: bitwise the uninterrupted run, its checkpoint the whole
    one-device tree;
  * a world of one (dp=1 tp=1, and a hybrid mesh of one): the FSDP step
    bitwise the step without a process group.
"""

import pickle

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tdax.models.qwen_vl import QwenVLConfig as JConfig
from tdax.models.qwen_vl import init_params as j_init_params
from tdax.models.qwen_vl.model import extract_layer_activations as j_capture
from tdax.parallel import fsdp_sharding_rules as j_fsdp_rules
from tdax.parallel import hybrid_batch_sharding as j_hybrid_batch_sharding
from tdax.parallel import make_hybrid_mesh as j_make_hybrid_mesh
from tdax.parallel import make_mesh as j_make_mesh
from tdax.parallel import make_train_step as j_make_train_step
from tdax.parallel import named_shardings as j_named_shardings
from tdax.parallel import param_sharding_rules as j_rules
from tdax.parallel import shard_params as j_shard_params
from tdax.parallel.mesh import batch_sharding as j_batch_sharding
from tdax.parallel.train import default_optimizer as j_default_optimizer

import torch_parallel_worlds as worlds
from tdax_torch.models.qwen_vl import QwenVLConfig
from tdax_torch.parallel import mesh as pm

CFG = QwenVLConfig.tiny(dtype="float32")
JCFG = JConfig.tiny(dtype="float32")
LOSS_RTOL = 1e-5                          # against tdax's sharded step
PARAM_TOL = dict(rtol=1e-3, atol=1e-5)    # tdax's sequence-parallel test
CAPTURE_TOL = dict(rtol=2e-3, atol=5e-3)  # tdax's stages 1 and 12
MOMENT_RTOL, MOMENT_ATOL_OF_MAX = 1e-4, 1e-5   # tests/test_torch_train_step.py
NOISE_OF_MAX = 1e-6   # a zero gradient's rounding noise, of the largest moment
# the FSDP cases: (the port's result key, tdax's mesh (dp, tp), "hybrid" or
# None (one device), the batch, accumulation steps, step keywords)
CASES = {"fsdp": ((4, 2), "batch", 1, {}),
         "images": (None, "batch_images", 1, {"with_images": True}),
         "sp": ((4, 2), "batch_sp", 1, {"sp": True}),
         "accum": ((2, 4), "batch_accum", 2, {}),
         "hybrid": ("hybrid", "batch_hybrid", 1, {})}
# the ranks each case's attn_qkv_w is split over
SHARE = {"fsdp": 8, "images": 8, "sp": 8, "accum": 8, "hybrid": 4}


def _tree(seed: int, with_visual: bool) -> dict:
    """tdax's tiny f32 init as numpy, every bias and norm moved by N(0, 0.1)."""
    tree = jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(seed), JCFG,
                                                  with_visual=with_visual))
    rng = np.random.default_rng(seed + 10)

    def move(path, leaf):
        name = path[-1].key
        if name.endswith("_b") or name.startswith("ln"):
            return leaf + rng.normal(0, 0.1, leaf.shape).astype(np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(move, tree)


def _inputs() -> dict:
    rng = np.random.default_rng(31)
    b, t = 4, 32
    batch = {"input_ids": rng.integers(1, 64, (b, t)).astype(np.int32),  # learnable
             "attn_mask": np.ones((b, t), np.int32)}
    batch["attn_mask"][:, t - 3:] = 0
    sp = {"input_ids": rng.integers(1, CFG.vocab_size, (b, t)).astype(np.int32),
          "attn_mask": np.ones((b, t), np.int32)}
    sp["attn_mask"][2:, 20:] = 0  # the dp ranks' token counts differ
    sp["attn_mask"][3, 9:] = 0
    nq, size = CFG.visual.n_queries, CFG.visual.image_size
    pos = np.full((b, nq), -1, np.int32)
    pos[0::2] = np.arange(2, 2 + nq)
    images = {"input_ids": rng.integers(1, CFG.vocab_size, (b, t)).astype(np.int32),
              "attn_mask": np.ones((b, t), np.int32), "image_positions": pos,
              "images": rng.normal(size=(b, 3, size, size)).astype(np.float32)}
    images["attn_mask"][1, 25:] = 0
    accum = {"input_ids": rng.integers(1, CFG.vocab_size, (4, 16)).astype(np.int32),
             "attn_mask": np.ones((4, 16), np.int32)}
    accum["attn_mask"][:2, 11:] = 0  # the microbatches' token counts differ
    hybrid = {"input_ids": rng.integers(1, CFG.vocab_size, (8, 24)).astype(np.int32),
              "attn_mask": np.ones((8, 24), np.int32)}
    hybrid["attn_mask"][:4, 18:] = 0
    t_c = 64
    capture = {"ids": rng.integers(1, CFG.vocab_size, (b, t_c)).astype(np.int32),
               "mask": np.ones((b, t_c), np.int32), "last": np.full(b, t_c - 1, np.int32),
               "images": rng.normal(size=(b, 3, size, size)).astype(np.float32),
               "img_pos": np.tile(np.arange(2, 2 + nq, dtype=np.int32), (b, 1))}
    return {"tree": _tree(15, False), "tree_visual": _tree(16, True),
            "tree_capture": _tree(0, True), "batch": batch, "batch_sp": sp,
            "batch_images": images, "batch_accum": accum, "batch_hybrid": hybrid,
            "capture": capture}


def _tdax_step(tree: dict, batch: dict, mesh_of, accum: int, kw: dict) -> dict:
    """tdax's FSDP step (remat on) on the 8 virtual devices, or its step on
    one device."""
    p = jax.tree.map(jnp.asarray, tree)
    opt = j_default_optimizer(1e-3)
    if mesh_of is None:
        b = {k: jnp.asarray(v) for k, v in batch.items()}
        step = j_make_train_step(JCFG, opt, with_images=kw.get("with_images", False),
                                 remat=True)
        return _tdax_result(*step(p, opt.init(p), b))
    if mesh_of == "hybrid":
        mesh = j_make_hybrid_mesh(dcn=2, dp=2, tp=2)
        bs = j_hybrid_batch_sharding(mesh)
    else:
        mesh = j_make_mesh(dp=mesh_of[0], tp=mesh_of[1])
        bs = j_batch_sharding(mesh)
    rules = j_fsdp_rules(p, mesh, base_rules=j_rules("visual" in tree))
    p = j_shard_params(p, mesh, rules)
    if accum > 1:
        micro = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec(None, "dp"))
        b = {k: jax.device_put(jnp.asarray(v).reshape(accum, -1, *v.shape[1:]), micro)
             for k, v in batch.items()}
    else:
        b = {k: jax.device_put(jnp.asarray(v), bs) for k, v in batch.items()}
    sp_mesh = mesh if kw.get("sp") else None
    step = j_make_train_step(JCFG, opt, remat=True, sp_mesh=sp_mesh,
                             param_shardings=j_named_shardings(mesh, rules), accum_steps=accum)
    return _tdax_result(*step(p, jax.jit(opt.init)(p), b))


def _tdax_result(p, state, loss) -> dict:
    adam = next(s for s in jax.tree_util.tree_leaves(
        state, is_leaf=lambda node: hasattr(node, "mu")) if hasattr(s, "mu"))
    return {"loss": float(loss), "params": jax.tree.map(np.asarray, p),
            "mu": jax.tree.map(np.asarray, adam.mu)}


def _spec_tuples(rules) -> dict:
    return jax.tree.map(tuple, rules, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))


def _tdax(inp: dict) -> dict:
    out = {case: _tdax_step(inp["tree_visual" if case == "images" else "tree"], inp[batch],
                            mesh_of, accum, kw)
           for case, (mesh_of, batch, accum, kw) in CASES.items()}
    for vis, key in ((False, "tree"), (True, "tree_visual")):
        p = jax.tree.map(jnp.asarray, inp[key])
        out[f"rules_{vis}"] = _spec_tuples(j_fsdp_rules(p, dp=4, base_rules=j_rules(vis)))
    out["rules_dp2"] = _spec_tuples(j_fsdp_rules(jax.tree.map(jnp.asarray, inp["tree"]), dp=2))
    c = {k: jnp.asarray(v) for k, v in inp["capture"].items()}
    out["capture"] = np.asarray(j_capture(jax.tree.map(jnp.asarray, inp["tree_capture"]), JCFG,
                                          c["ids"], c["mask"], c["last"], c["images"],
                                          c["img_pos"]))
    return out


def _compute(work) -> dict:
    inp = _inputs()
    inp_path = work / "inp.pkl"
    with open(inp_path, "wb") as f:
        pickle.dump(inp, f)
    for name in ("eight", "one"):
        (work / name).mkdir()
    eight = worlds.run_world(worlds.fsdp_world, 8, work / "eight", str(inp_path),
                             str(work / "eight"))
    one = worlds.run_world(worlds.one_fsdp_world, 1, work / "one", str(inp_path))[0]
    return {"inp": inp, "tdax": _tdax(inp), "eight": eight, "one": one}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return worlds.once(tmp_path_factory, "torch_parallel_fsdp", _compute)


def _leaves(tree, path=""):
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            yield from _leaves(leaf, f"{path}/{name}")
        else:
            yield f"{path}/{name}", np.asarray(leaf)


def _close_trees(got: dict, want: dict, tol=PARAM_TOL):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    for path, w in want.items():
        assert got[path].shape == w.shape, path
        np.testing.assert_allclose(got[path], w, err_msg=path, **tol)


def _zero_gradient(path: str, leaf: np.ndarray) -> np.ndarray:
    """True at the entries whose gradient is zero in exact arithmetic:
    the resampler's key bias and the key third of the ViT's qkv bias."""
    mask = np.zeros(leaf.shape, bool)
    if path == "/visual/resampler/attn_k_b":
        mask[...] = True
    elif path == "/visual/blocks/attn_qkv_b":
        mask[:, CFG.visual.width:2 * CFG.visual.width] = True
    return mask


def _close_moments(got: dict, want: dict):
    """Each leaf within MOMENT_RTOL plus MOMENT_ATOL_OF_MAX of its largest
    magnitude; the zero-gradient entries below NOISE_OF_MAX of the tree's
    largest moment on both sides."""
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    top = max(float(np.abs(w).max()) for w in want.values())
    for path, w in want.items():
        g, zero = got[path], _zero_gradient(path, w)
        assert np.abs(g[zero]).max(initial=0) <= NOISE_OF_MAX * top, path
        assert np.abs(w[zero]).max(initial=0) <= NOISE_OF_MAX * top, path
        np.testing.assert_allclose(
            g[~zero], w[~zero], rtol=MOMENT_RTOL,
            atol=MOMENT_ATOL_OF_MAX * float(np.abs(w[~zero]).max(initial=0)), err_msg=path)


def _equal_trees(got: dict, want: dict):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    for path, w in want.items():
        np.testing.assert_array_equal(got[path], w, err_msg=path)


def _every_rank(results, key):
    """rank 0's result of ``key``, after checking every rank holds it."""
    first = results["eight"][0][key]
    for out in results["eight"][1:]:
        assert out[key]["losses"] == first["losses"]
        _equal_trees(out[key]["params"], first["params"])
    return first


# ---- the rules -----------------------------------------------------------------------

@pytest.mark.parametrize("with_visual", [False, True])
def test_rules_equal_tdax(results, with_visual):
    from tdax_torch.models.qwen_vl.convert import params_from_numpy
    tree = results["inp"]["tree_visual" if with_visual else "tree"]
    got = pm.fsdp_sharding_rules(params_from_numpy(tree, "cpu", "float32"), dp=4)
    assert worlds._spec_tuples(got) == results["tdax"][f"rules_{with_visual}"]
    assert got["layers"]["attn_qkv_w"] == pm.P(None, "dp", "tp")
    assert got["wte"] == pm.P("dp") and got["layers"]["ln_1"] == pm.P()


@pytest.mark.parametrize("mesh,dp", [("dp4_tp2", 4), ("dp2_tp4", 2), ("hybrid", 2)])
def test_rules_on_a_mesh_read_its_dp(results, mesh, dp):
    from tdax_torch.models.qwen_vl.convert import params_from_numpy
    want = worlds._spec_tuples(pm.fsdp_sharding_rules(
        params_from_numpy(results["inp"]["tree"], "cpu", "float32"), dp=dp))
    for out in results["eight"]:
        assert out["rules_on_meshes"][mesh] == want
    if dp == 2:
        assert want == results["tdax"]["rules_dp2"]


# ---- stage 11: FSDP ------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_fsdp_step_matches_tdax(results, case):
    got, want = _every_rank(results, case), results["tdax"][case]
    np.testing.assert_allclose(got["losses"][0], want["loss"], rtol=LOSS_RTOL)
    if case in ("images", "sp"):
        _close_moments(got["mu"], want["mu"])
    else:
        _close_trees(got["params"], want["params"])


@pytest.mark.parametrize("case", list(CASES))
def test_params_and_moments_live_sharded(results, case):
    whole = dict(_leaves(results["inp"]["tree"]))["/layers/attn_qkv_w"].size
    for out in results["eight"]:
        assert out[case]["local_qkv"] == {k: whole // SHARE[case] for k in ("params", "mu",
                                                                            "nu")}


def _dp_leaves(rules: dict) -> tuple:
    """(the per-layer leaves whose rule names dp, the others that do)."""
    layer = sum("dp" in spec for spec in rules["layers"].values())
    other = sum("dp" in spec for name, spec in rules.items() if name != "layers")
    return layer, other


def test_fsdp_collectives(results):
    """Per rank, one FSDP step of the 4-layer text model with remat: each
    dp-sharded weight gathered in the forward and again in remat's replay
    (wte and lm_head once), each gradient reduce-scattered once; the
    loss's 2 dp sums, the dp sums of the 35 - 22 leaves that are whole
    over dp, the clip's tp and dp sums (dp=4 tp=2)."""
    out = results["eight"][0]["fsdp"]
    layer, other = _dp_leaves(out["rules"])
    layers = CFG.num_layers
    assert (layer, other) == (5, 2)
    sharded = layer * layers + other
    assert out["by_axis"]["dp.all_gather"] == 2 * layer * layers + other
    assert out["by_axis"]["dp.reduce_scatter"] == sharded
    assert out["by_axis"]["dp.all_reduce"] == 2 + (35 - sharded) + 1
    for r in results["eight"]:
        assert r["fsdp"]["by_axis"] == out["by_axis"]


# ---- accumulation and the loop -------------------------------------------------------

def test_train_loop_resumes_bitwise_with_fsdp(results):
    whole = dict(_leaves(results["inp"]["tree"]))["/layers/attn_qkv_w"].size
    for out in results["eight"]:
        loop = out["loop"]
        assert loop["count"] == loop["resumed_count"] == 4
        assert loop["resumed_losses"] == loop["full_losses"][2:]
        assert loop["local_qkv"] == [whole // 8] * 2
        _equal_trees(loop["resumed"], loop["full"])
    loop = results["eight"][0]["loop"]
    _equal_trees(loop["saved_params"], loop["full"])  # rank 0 wrote the whole tree


# ---- stage 12: the hybrid mesh -------------------------------------------------------

def test_hybrid_mesh_layout(results):
    for rank, out in enumerate(results["eight"]):
        h = out["hybrid_mesh"]
        assert h["axis_names"] == ("dcn", "dp", "tp")
        assert h["shape"] == {"dcn": 2, "dp": 2, "tp": 2}
        assert h["batch_rank"] == rank // 2  # tp innermost, slices of 4 ranks


def test_hybrid_gathers_stay_inside_a_slice(results):
    """Every weight gather runs over dp (the LM head's vocab gather over
    tp); the gradients cross slices by their all_reduce over dcn alone;
    the loss and the whole leaves are summed over (dcn, dp)."""
    out = results["eight"][0]["hybrid"]
    layer, other = _dp_leaves(out["rules"])
    sharded = layer * CFG.num_layers + other
    by_axis = out["by_axis"]
    assert not [k for k in by_axis if k.startswith("dcn") and not k.endswith("all_reduce")]
    assert by_axis["dp.all_gather"] == 2 * layer * CFG.num_layers + other
    assert by_axis["dcn.all_reduce"] == by_axis["dp.reduce_scatter"] == sharded
    assert by_axis["dcn+dp.all_reduce"] == 2 + (35 - sharded)
    assert by_axis["tp.all_gather"] == 1


def test_hybrid_capture_matches_tdax_single_device(results):
    want = results["tdax"]["capture"]
    for out in results["eight"]:
        cap = out["hybrid_capture"]
        assert cap["local_rows"] == 1
        assert cap["acts"].shape == (CFG.num_layers, 4, CFG.hidden_size)
        np.testing.assert_allclose(cap["acts"], want, **CAPTURE_TOL)
        # the batch's one gather spans every slice; the tp sums stay in one
        assert cap["by_axis"]["dcn+dp.all_gather"] == 1
        assert not any(k.startswith("dcn.") for k in cap["by_axis"])


def test_hybrid_mesh_refuses_indivisible(results):
    for out in results["eight"]:
        r = out["refusals"]
        assert r["dcn3"] is not None and "slices" in r["dcn3"]
        assert r["dp4_tp2"] is not None and "devices/slice" in r["dp4_tp2"]


# ---- the world of one ----------------------------------------------------------------

@pytest.mark.parametrize("case", ["fsdp", "hybrid"])
def test_world_of_one_fsdp_bitwise_one_device(results, case):
    one, got = results["one"]["one"], results["one"][case]
    assert got["losses"] == one["losses"]
    _equal_trees(got["params"], one["params"])
    _equal_trees(got["mu"], one["mu"])
    assert got["local_qkv"]["params"] == dict(_leaves(results["inp"]["tree"]))[
        "/layers/attn_qkv_w"].size
