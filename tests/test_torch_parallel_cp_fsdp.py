"""The port's FSDP (ZeRO-3) training step under context parallelism
against tdax's, on the CPU (``make_train_step(cp_mesh=, param_shardings=)``:
tdax's stage-10 ring with its stage-11 parameter layout).

tdax runs its ``make_train_step(cp_mesh=mesh, param_shardings=...)``
(GSPMD places the weight gathers and reduce-scatters the gradients into
the dp-sharded layout) on the conftest's virtual XLA devices: 4 of them
at dp=2 cp=2, all 8 at dp=2 tp=2 cp=2.  The port runs gloo worlds of 4
and 8 ranks (``torch_parallel_worlds.cp_fsdp_world``, spawned once per
test session), each rank passing its dp rows of the whole sequence and
holding its dp share of each large leaf, the same share on both cp
ranks.  Both take the same numpy trees (tdax's tiny f32 init, every bias
and norm moved off 0 and 1; text-only, and with the visual tree) and the
same batches (numpy seeds, T = 64: 32 positions a cp rank, the last 5 of
every row masked), remat on, AdamW at lr 1e-3 with the global-norm clip.
Checks and their tolerances (tests/test_torch_parallel_cp.py's):

  * against tdax's cp + FSDP step, text-only at both meshes, with images
    at both, and with 2 microbatches at dp=2 cp=2: the loss within rtol
    1e-5, AdamW's first moment within 1e-4 relative plus 1e-5 of each
    leaf's largest magnitude (the zero-gradient entries below 1e-6 of the
    largest moment), and, text-only, the updated params within rtol 1e-3
    and atol 1e-5 wherever the gradient is 0 or at least ILL_CONDITIONED
    (below it Adam's first step turns summation-order noise into a
    visible step, as the cp test says);
  * against the port's own plain cp step on the same mesh and batch:
    FSDP moves no value, so the loss, the clip's norm, the first moment
    and the updated params agree within FSDP_TOL (the gradient is summed
    over dp then cp instead of over both at once: f32 rounding only);
  * the clip: its global norm on every rank equals one device's norm of
    the same batch (rtol 1e-5), not cp times its squares;
  * the shards: ``layers/attn_qkv_w`` and its two moments hold 1/dp of the
    whole (1/(dp tp) at tp=2) on every rank, equal on the two cp ranks of
    each (dp, tp) index;
  * the collectives of the text step at dp=2 cp=2 and with 2
    microbatches: each dp-sharded weight gathered over dp in the forward
    and in remat's replay (wte and lm_head once), its gradient
    reduce-scattered over dp and its share all_reduced over cp once a
    microbatch; the ring's 3 (cp + 1) permutes a layer a microbatch (the
    zigzag relayout in and out and cp - 1 rotations, in the forward, in
    remat's replay and in the backward); the loss's
    two and the whole leaves' sums over ("dp", "cp"); the clip's two
    over tp and one over dp; the same counts on every rank, every case;
  * ``train_loop(cp_mesh=, param_shardings=)``: 2 steps, then a resume
    from the checkpoint for the third, bitwise 3 steps straight, its
    checkpoint the whole tree, written by rank 0.
"""

import concurrent.futures
import pickle

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tdax.parallel import fsdp_sharding_rules as j_fsdp_rules
from tdax.parallel import make_mesh as j_make_mesh
from tdax.parallel import make_train_step as j_make_train_step
from tdax.parallel import named_shardings as j_named_shardings
from tdax.parallel import param_sharding_rules as j_rules
from tdax.parallel import shard_params as j_shard_params
from tdax.parallel.mesh import batch_sharding as j_batch_sharding
from tdax.parallel.train import default_optimizer as j_default_optimizer

import torch_parallel_worlds as worlds
from test_torch_parallel_cp import (CFG, ILL_CONDITIONED, JCFG, LOSS_RTOL, PARAM_TOL,
                                    _close_moments, _leaves, _tree)

FSDP_TOL = 1e-6      # the FSDP cp step against the plain cp step
NORM_RTOL = 1e-5     # the clip's norm against one device's
CP = 2
# (the port's world, its case; tdax's mesh (dp, tp, cp), images, microbatches)
CASES = {"text4": (4, "text", (2, 1, 2), False, 1),
         "images4": (4, "images", (2, 1, 2), True, 1),
         "accum4": (4, "accum", (2, 1, 2), False, 2),
         "text8": (8, "text", (2, 2, 2), False, 1),
         "images8": (8, "images", (2, 2, 2), True, 1)}


def _inputs() -> dict:
    rng = np.random.default_rng(41)
    b, t = 4, 32 * CP
    batch = {"input_ids": rng.integers(1, CFG.vocab_size, (b, t)).astype(np.int32),
             "attn_mask": np.ones((b, t), np.int32)}
    batch["attn_mask"][:, t - 5:] = 0
    nq, size = CFG.visual.n_queries, CFG.visual.image_size
    pos = np.full((b, nq), -1, np.int32)
    pos[0::2] = np.arange(2, 2 + nq)  # the span crosses a zigzag half's edge
    images = {"input_ids": rng.integers(1, CFG.vocab_size, (b, t)).astype(np.int32),
              "attn_mask": np.ones((b, t), np.int32), "image_positions": pos,
              "images": rng.normal(size=(b, 3, size, size)).astype(np.float32)}
    images["attn_mask"][1, 50:] = 0
    return {"tree": _tree(17, False), "tree_visual": _tree(18, True), "batch": batch,
            "batch_images": images}


def _tdax_step(tree: dict, batch: dict, shape: tuple, images: bool, accum: int) -> dict:
    """tdax's cp + FSDP step (remat) on the first dp * tp * cp virtual
    devices."""
    dp, tp, cp = shape
    mesh = j_make_mesh(dp=dp, tp=tp, cp=cp, devices=jax.devices()[:dp * tp * cp])
    opt = j_default_optimizer(1e-3)
    p = jax.tree.map(jnp.asarray, tree)
    rules = j_fsdp_rules(p, mesh, base_rules=j_rules(images))
    p = j_shard_params(p, mesh, rules)
    if accum > 1:
        micro = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec(None, "dp"))
        b = {k: jax.device_put(jnp.asarray(v).reshape(accum, -1, *v.shape[1:]), micro)
             for k, v in batch.items()}
    else:
        b = {k: jax.device_put(jnp.asarray(v), j_batch_sharding(mesh)) for k, v in batch.items()}
    step = j_make_train_step(JCFG, opt, with_images=images, remat=True, cp_mesh=mesh,
                             param_shardings=j_named_shardings(mesh, rules), accum_steps=accum)
    p, state, loss = step(p, jax.jit(opt.init)(p), b)
    adam = next(s for s in jax.tree_util.tree_leaves(
        state, is_leaf=lambda node: hasattr(node, "mu")) if hasattr(s, "mu"))
    return {"loss": float(loss), "params": jax.tree.map(np.asarray, p),
            "mu": jax.tree.map(np.asarray, adam.mu)}


def _tdax(inp: dict) -> dict:
    return {case: _tdax_step(inp["tree_visual" if images else "tree"],
                             inp["batch_images" if images else "batch"], shape, images, accum)
            for case, (_, _, shape, images, accum) in CASES.items()}


def _compute(work) -> dict:
    inp = _inputs()
    inp_path = work / "inp.pkl"
    with open(inp_path, "wb") as f:
        pickle.dump(inp, f)
    for name in ("four", "eight"):
        (work / name).mkdir()

    def ranks():
        return {4: worlds.run_world(worlds.cp_fsdp_world, 4, work / "four", str(inp_path),
                                    str(work / "four")),
                8: worlds.run_world(worlds.cp_fsdp_world, 8, work / "eight", str(inp_path),
                                    str(work / "eight"))}

    # the ranks run while tdax compiles: the worlds wait on their processes
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
        port = pool.submit(ranks)
        tdax = _tdax(inp)
        return {"inp": inp, "tdax": tdax, "port": port.result()}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return worlds.once(tmp_path_factory, "torch_parallel_cp_fsdp", _compute)


def _port(results, case: str) -> list:
    world, key = CASES[case][:2]
    return [rank[key] for rank in results["port"][world]]


# ---- against tdax ----------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_cp_fsdp_loss_matches_tdax(results, case):
    for rank in _port(results, case):
        np.testing.assert_allclose(rank["loss"], results["tdax"][case]["loss"], rtol=LOSS_RTOL)


@pytest.mark.parametrize("case", list(CASES))
def test_cp_fsdp_moments_match_tdax(results, case):
    _close_moments(_port(results, case)[0]["mu"], results["tdax"][case]["mu"])


@pytest.mark.parametrize("case", [c for c, spec in CASES.items() if not spec[3]])
def test_cp_fsdp_params_match_tdax(results, case):
    """Every entry whose gradient (10 |mu|, tdax's) is 0 or at least
    ILL_CONDITIONED; the entries between are a handful."""
    got = dict(_leaves(_port(results, case)[0]["params"]))
    want = dict(_leaves(results["tdax"][case]["params"]))
    mu = dict(_leaves(results["tdax"][case]["mu"]))
    assert got.keys() == want.keys()
    skipped = 0
    for path, w in want.items():
        held = (mu[path] == 0) | (10 * np.abs(mu[path]) >= ILL_CONDITIONED)
        skipped += int((~held).sum())
        np.testing.assert_allclose(got[path][held], w[held], err_msg=path, **PARAM_TOL)
    assert skipped <= 1e-3 * sum(w.size for w in want.values())


@pytest.mark.parametrize("case", list(CASES))
def test_every_rank_holds_the_same_tree(results, case):
    ranks = _port(results, case)
    first = dict(_leaves(ranks[0]["params"]))
    for rank in ranks[1:]:
        assert rank["loss"] == ranks[0]["loss"] and rank["norm"] == ranks[0]["norm"]
        for path, leaf in _leaves(rank["params"]):
            np.testing.assert_array_equal(leaf, first[path], err_msg=path)


# ---- against the port's plain cp step and one device -----------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_fsdp_moves_no_value(results, case):
    """The FSDP cp step equals the plain cp step on the same mesh within
    FSDP_TOL: the loss and the norm relative, the first moment absolute,
    the params absolute wherever the gradient is 0 or at least
    ILL_CONDITIONED (the plain step's first moment says where)."""
    world, key = CASES[case][:2]
    for rank in results["port"][world]:
        got, want = rank[key], rank[key + "_plain"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=FSDP_TOL)
        np.testing.assert_allclose(got["norm"], want["norm"], rtol=FSDP_TOL)
        mu = dict(_leaves(want["mu"]))
        for (path, a), (_, b) in zip(_leaves(got["mu"]), _leaves(want["mu"])):
            np.testing.assert_allclose(a, b, rtol=0, atol=FSDP_TOL, err_msg=f"mu{path}")
        for (path, a), (_, b) in zip(_leaves(got["params"]), _leaves(want["params"])):
            held = (mu[path] == 0) | (10 * np.abs(mu[path]) >= ILL_CONDITIONED)
            np.testing.assert_allclose(a[held], b[held], rtol=0, atol=FSDP_TOL,
                                       err_msg=f"params{path}")


@pytest.mark.parametrize("case", list(CASES))
def test_clip_norm_is_one_devices(results, case):
    key = CASES[case][1]
    want = results["port"][4][0]["one_device_norm"][key]
    assert want > 1.0  # the clip acts: the norm scales every update
    for rank in _port(results, case):
        np.testing.assert_allclose(rank["norm"], want, rtol=NORM_RTOL)


# ---- the layout and the collectives ----------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_shards_are_one_dp_share_equal_on_the_cp_ranks(results, case):
    world, key = CASES[case][:2]
    dp, tp, _ = CASES[case][2]
    leaf = "/layers/attn_qkv_w"
    tree = results["inp"]["tree_visual" if CASES[case][3] else "tree"]
    whole = dict(_leaves(tree))[leaf].size
    by_place = {}
    for rank in results["port"][world]:
        local = rank[key]["local_qkv"]
        assert {name: a.size for name, a in local.items()} == {
            name: whole // (dp * tp) for name in ("params", "mu", "nu")}
        place = (rank["ranks"]["dp"], rank["ranks"]["tp"])
        by_place.setdefault(place, []).append(local)
    assert len(by_place) == dp * tp
    for shares in by_place.values():
        assert len(shares) == CP
        for name in ("params", "mu", "nu"):
            np.testing.assert_array_equal(shares[1][name], shares[0][name], err_msg=name)


def _dp_leaves(rules: dict) -> tuple:
    """(the per-layer leaves whose rule names dp, the others that do)."""
    layer = sum("dp" in spec for spec in rules["layers"].values())
    other = sum("dp" in spec for name, spec in rules.items() if name != "layers")
    return layer, other


@pytest.mark.parametrize("case,micro", [("text4", 1), ("accum4", 2)])
def test_cp_fsdp_collectives(results, case, micro):
    """Per rank, one step of the 4-layer text model at dp=2 cp=2 with remat
    (35 trainable leaves)."""
    out = _port(results, case)[0]
    layer, other = _dp_leaves(out["rules"])
    assert (layer, other) == (5, 2)
    layers = CFG.num_layers
    sharded = layer * layers + other
    assert out["by_axis"] == {
        "dp.all_gather": micro * (2 * layer * layers + other),
        "dp.reduce_scatter": micro * sharded,
        "cp.all_reduce": micro * sharded,
        "cp.ppermute": micro * 3 * (CP + 1) * layers,
        "dp+cp.all_reduce": 2 + (35 - sharded),
        "tp.all_reduce": 2,
        "dp.all_reduce": 1}


@pytest.mark.parametrize("case", list(CASES))
def test_every_rank_runs_the_same_collectives(results, case):
    ranks = _port(results, case)
    for rank in ranks[1:]:
        assert rank["by_axis"] == ranks[0]["by_axis"]
    assert ranks[0]["by_axis"]["cp.all_reduce"] == ranks[0]["by_axis"]["dp.reduce_scatter"]


# ---- the loop --------------------------------------------------------------------------

def test_train_loop_resumes_bitwise(results):
    whole = dict(_leaves(results["inp"]["tree"]))["/layers/attn_qkv_w"].size
    for rank in results["port"][4]:
        loop = rank["loop"]
        assert loop["count"] == loop["resumed_count"] == 3
        assert loop["resumed_losses"] == loop["full_losses"][2:]
        assert loop["local_qkv"] == [whole // 2] * 2
        for (path, a), (_, b) in zip(_leaves(loop["resumed"]), _leaves(loop["full"])):
            np.testing.assert_array_equal(a, b, err_msg=path)
        for (path, a), (_, b) in zip(_leaves(loop["saved_params"]), _leaves(loop["full"])):
            np.testing.assert_array_equal(a, b, err_msg=path)
        assert loop["files"] == ["crash.npz", "full.npz"]
