"""The port's context-parallel training step against tdax's, on the CPU
(tdax's dry-run stage 10, ``__graft_entry__.py:401-443``).

tdax runs its ``make_train_step(cp_mesh=...)`` (ring attention under
GSPMD) on the conftest's 8 virtual XLA devices and its plain step on one
device; the port runs a gloo world of 8 ranks
(``torch_parallel_worlds.cp_world``, spawned once per test session), each
rank passing its dp rows of the whole sequence, the model keeping its cp
chunk from the first block to the loss.  Both take the same numpy tree
(tdax's tiny f32 init, every bias and norm moved off 0 and 1) and the
same batches (numpy seeds); AdamW at lr 1e-3 with the global-norm clip.
Checks and their tolerances (tests/test_parallel.py:405-451):

  * stage 10's recipe (dp=2 cp=4, remat, T = 32 cp = 128, the last 5
    positions of every row masked) and dp=2 tp=2 cp=2 (heads over tp
    inside the ring) against tdax's cp step on the same mesh and against
    its plain step: the loss within rtol 1e-5, AdamW's first moment (a
    tenth of the clipped gradient) within 1e-4 relative plus 1e-5 of
    each leaf's largest magnitude, the updated params within rtol 1e-3
    and atol 1e-5 wherever the gradient is 0 or at least ILL_CONDITIONED
    (10 times Adam's eps).  Below it Adam's first step, lr g / (|g| + eps),
    turns the gradient's summation-order noise into a visible step: one
    entry of mlp_proj_w here has |g| ~ 3e-9, where the ring's order and
    tdax's differ by 5e-10 (1e-7 of the leaf's largest gradient) and
    move the param by up to 4e-5; its gradient is held by the moment;
  * ``accum_steps = 2`` at dp=2 cp=4 against tdax's one-device step with
    the same two microbatches, as above;
  * with images (the visual tower whole on every rank, outside the ring)
    against tdax's cp step with images and its one-device images step:
    the loss as above, AdamW's first moment within 1e-4 relative plus
    1e-5 of each leaf's largest magnitude (tests/test_torch_parallel_train.py's
    images tolerance), the zero-gradient entries below 1e-6 of the
    largest moment;
  * the collectives of stage 10's step: cp permutes (15 a layer: the
    zigzag relayout in and out and 3 rotations, forward, remat's replay
    and backward), the loss's two and every leaf's gradient all_reduce
    over ("dp", "cp"), the clip's one over tp;
  * ``train_loop(cp_mesh=)`` stopped after its first checkpoint and
    resumed: bitwise the uninterrupted run, its checkpoint the whole
    tree, written by rank 0;
  * the refusals: ``sp_mesh`` with ``cp_mesh``, a mesh with no "cp"
    axis and ``param_shardings`` over another mesh than ``cp_mesh``
    (ValueError; FSDP under cp itself runs in
    tests/test_torch_parallel_cp_fsdp.py), a sequence the cp axis does
    not divide (ValueError: tdax pads or replicates, a rank here holds
    its chunk only), the capture under a seq axis (NotImplementedError).
"""

import concurrent.futures
import pickle

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tdax.models.qwen_vl import QwenVLConfig as JConfig
from tdax.models.qwen_vl import init_params as j_init_params
from tdax.parallel import make_mesh as j_make_mesh
from tdax.parallel import make_train_step as j_make_train_step
from tdax.parallel import param_sharding_rules as j_rules
from tdax.parallel import shard_params as j_shard_params
from tdax.parallel.mesh import batch_sharding as j_batch_sharding
from tdax.parallel.train import default_optimizer as j_default_optimizer

import torch

import torch_parallel_worlds as worlds
from tdax_torch.models.qwen_vl import QwenVLConfig

CFG = QwenVLConfig.tiny(dtype="float32")
JCFG = JConfig.tiny(dtype="float32")
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=1e-3, atol=1e-5)         # tests/test_parallel.py:441-444
MOMENT_RTOL, MOMENT_ATOL_OF_MAX = 1e-4, 1e-5
NOISE_OF_MAX = 1e-6
ILL_CONDITIONED = 10 * 1e-8     # |g| below 10 Adam eps: the first step's update is noise-bound


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
    rng = np.random.default_rng(21)
    b, t = 4, 32 * 4  # stage 10: 2 rows a dp rank, T = 32 cp
    batch = {"input_ids": rng.integers(1, CFG.vocab_size, (b, t)).astype(np.int32),
             "attn_mask": np.ones((b, t), np.int32)}
    batch["attn_mask"][:, t - 5:] = 0
    nq, size = CFG.visual.n_queries, CFG.visual.image_size
    t_img = 32
    pos = np.full((b, nq), -1, np.int32)
    pos[0::2] = np.arange(2, 2 + nq)  # the span crosses the cp chunks' edges
    images = {"input_ids": rng.integers(1, CFG.vocab_size, (b, t_img)).astype(np.int32),
              "attn_mask": np.ones((b, t_img), np.int32), "image_positions": pos,
              "images": rng.normal(size=(b, 3, size, size)).astype(np.float32)}
    images["attn_mask"][1, 25:] = 0
    return {"tree": _tree(15, False), "tree_visual": _tree(16, True), "batch": batch,
            "batch_images": images}


def _tdax(inp: dict) -> dict:
    """tdax's cp steps (dp=2 cp=4 with remat, dp=2 tp=2 cp=2, and with
    images), its plain steps on one device (the batch whole, in two
    microbatches, and with images)."""
    opt = j_default_optimizer(1e-3)

    def step(tree, batch, mesh=None, **kw):
        p = jax.tree.map(jnp.asarray, tree)
        b = {k: jnp.asarray(v) for k, v in batch.items()}
        if mesh is not None:
            p = j_shard_params(p, mesh, j_rules(with_visual="visual" in tree))
            b = {k: jax.device_put(v, j_batch_sharding(mesh)) for k, v in b.items()}
            kw["cp_mesh"] = mesh
        p, state, loss = j_make_train_step(JCFG, opt, **kw)(p, opt.init(p), b)
        adam = next(s for s in jax.tree_util.tree_leaves(
            state, is_leaf=lambda node: hasattr(node, "mu")) if hasattr(s, "mu"))
        return {"loss": float(loss), "params": jax.tree.map(np.asarray, p),
                "mu": jax.tree.map(np.asarray, adam.mu)}

    cp4, tp2 = j_make_mesh(dp=2, tp=1, cp=4), j_make_mesh(dp=2, tp=2, cp=2)
    tree, batch, images = inp["tree"], inp["batch"], inp["batch_images"]
    micro = {k: v.reshape(2, v.shape[0] // 2, *v.shape[1:]) for k, v in batch.items()}
    return {"stage10": step(tree, batch, cp4, remat=True), "tp": step(tree, batch, tp2),
            "plain": step(tree, batch), "accum_plain": step(tree, micro, accum_steps=2),
            "images": step(inp["tree_visual"], images, cp4, with_images=True),
            "images_plain": step(inp["tree_visual"], images, with_images=True)}


def _compute(work) -> dict:
    inp = _inputs()
    inp_path = work / "inp.pkl"
    with open(inp_path, "wb") as f:
        pickle.dump(inp, f)
    (work / "eight").mkdir()
    # the ranks run while tdax compiles: the world waits on its processes
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
        eight = pool.submit(worlds.run_world, worlds.cp_world, 8, work / "eight",
                            str(inp_path), str(work / "eight"))
        tdax = _tdax(inp)
        return {"inp": inp, "tdax": tdax, "eight": eight.result()}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return worlds.once(tmp_path_factory, "torch_parallel_cp", _compute)


def _leaves(tree, path=""):
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            yield from _leaves(leaf, f"{path}/{name}")
        else:
            yield f"{path}/{name}", np.asarray(leaf)


def _zero_gradient(path: str, leaf: np.ndarray) -> np.ndarray:
    """The entries whose gradient is zero in exact arithmetic: the
    resampler's key bias and the key third of the ViT's qkv bias."""
    mask = np.zeros(leaf.shape, bool)
    if path == "/visual/resampler/attn_k_b":
        mask[...] = True
    elif path == "/visual/blocks/attn_qkv_b":
        mask[:, CFG.visual.width:2 * CFG.visual.width] = True
    return mask


def _close_moments(got: dict, want: dict):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    top = max(float(np.abs(w).max()) for w in want.values())
    for path, w in want.items():
        g, zero = got[path], _zero_gradient(path, w)
        assert np.abs(g[zero]).max(initial=0) <= NOISE_OF_MAX * top, path
        assert np.abs(w[zero]).max(initial=0) <= NOISE_OF_MAX * top, path
        tol = MOMENT_RTOL * np.abs(w[~zero]) + MOMENT_ATOL_OF_MAX * np.abs(w).max()
        assert (np.abs(g[~zero] - w[~zero]) <= tol).all(), path


# (the port's run, tdax's run)
CASES = [("stage10", "stage10"), ("stage10", "plain"), ("tp", "tp"), ("tp", "plain"),
         ("accum", "accum_plain")]


@pytest.mark.parametrize("run,ref", CASES)
def test_cp_step_loss_matches_tdax(results, run, ref):
    for rank in results["eight"]:
        np.testing.assert_allclose(rank[run]["losses"][0], results["tdax"][ref]["loss"],
                                   rtol=LOSS_RTOL)


@pytest.mark.parametrize("run,ref", CASES)
def test_cp_step_params_match_tdax(results, run, ref):
    """Every entry whose gradient (10 |mu|, tdax's) is 0 (a token the
    batch lacks: no step but the weight decay) or at least
    ILL_CONDITIONED; the entries between are a handful."""
    got = dict(_leaves(results["eight"][0][run]["params"]))
    want = dict(_leaves(results["tdax"][ref]["params"]))
    mu = dict(_leaves(results["tdax"][ref]["mu"]))
    assert got.keys() == want.keys()
    skipped = 0
    for path, w in want.items():
        held = (mu[path] == 0) | (10 * np.abs(mu[path]) >= ILL_CONDITIONED)
        skipped += int((~held).sum())
        np.testing.assert_allclose(got[path][held], w[held], err_msg=path, **PARAM_TOL)
    assert skipped <= 1e-3 * sum(w.size for w in want.values())


@pytest.mark.parametrize("run,ref", CASES)
def test_cp_step_moments_match_tdax(results, run, ref):
    _close_moments(results["eight"][0][run]["mu"], results["tdax"][ref]["mu"])


@pytest.mark.parametrize("ref", ["images", "images_plain"])
def test_cp_images_step_matches_tdax(results, ref):
    got, want = results["eight"][0]["images"], results["tdax"][ref]
    np.testing.assert_allclose(got["losses"][0], want["loss"], rtol=LOSS_RTOL)
    _close_moments(got["mu"], want["mu"])


def test_every_rank_holds_the_same_tree(results):
    first = dict(_leaves(results["eight"][0]["stage10"]["params"]))
    for rank in results["eight"][1:]:
        for path, leaf in _leaves(rank["stage10"]["params"]):
            np.testing.assert_array_equal(leaf, first[path], err_msg=path)


def test_stage10_collectives(results):
    layers, leaves = CFG.num_layers, 35  # the text-only tree's trainable leaves
    for rank in results["eight"]:
        assert rank["stage10"]["by_axis"] == {"cp.ppermute": 15 * layers,
                                              "dp+cp.all_reduce": 2 + leaves,
                                              "tp.all_reduce": 1}


def test_train_loop_resumes_bitwise(results):
    for rank in results["eight"]:
        loop = rank["loop"]
        assert loop["count"] == loop["resumed_count"] == 2
        assert loop["resumed_losses"] == loop["full_losses"][1:]
        for (path, a), (_, b) in zip(_leaves(loop["resumed"]), _leaves(loop["full"])):
            np.testing.assert_array_equal(a, b, err_msg=path)
        for (path, a), (_, b) in zip(_leaves(loop["saved_params"]), _leaves(loop["full"])):
            np.testing.assert_array_equal(a, b, err_msg=path)
        assert loop["files"] == ["crash.npz", "full.npz"]


# ---- refusals, before any collective --------------------------------------------------

class _Grid:
    """A mesh's shape and this rank's place: all the checks read."""

    def __init__(self, **shape):
        self.shape = shape

    def local_rank(self, axis):
        return 0


def test_cp_mesh_refusals():
    from tdax_torch.models.qwen_vl.model import init_params
    from tdax_torch.parallel import default_optimizer, make_train_step
    from tdax_torch.parallel import mesh as pm
    cp = _Grid(dp=1, tp=1, cp=2)
    opt = default_optimizer()
    with pytest.raises(ValueError, match="mutually exclusive"):
        make_train_step(CFG, opt, sp_mesh=cp, cp_mesh=cp, device="cpu")
    with pytest.raises(ValueError, match="no 'cp'"):
        make_train_step(CFG, opt, cp_mesh=_Grid(dp=2, tp=4), device="cpu")
    rules = pm.fsdp_sharding_rules(init_params(CFG, "cpu", with_visual=False), 1)
    other = _Grid(dp=1, tp=1, cp=2)
    with pytest.raises(ValueError, match="cp_mesh and param_shardings name two meshes"):
        make_train_step(CFG, opt, cp_mesh=cp, param_shardings=pm.named_shardings(other, rules),
                        device="cpu")


def test_a_sequence_the_cp_axis_does_not_divide_is_refused():
    from tdax_torch.models.qwen_vl.model import forward, init_params
    from tdax_torch.ops.flash_attention import flash_sharding
    params = init_params(CFG, "cpu", with_visual=False)
    with flash_sharding(_Grid(dp=1, tp=1, cp=4), "dp", "tp", seq_axis="cp"), \
            pytest.raises(ValueError, match="30 positions do not divide over the 4 ranks"):
        forward(params, CFG, torch.ones(1, 30, dtype=torch.long))


def test_capture_under_a_seq_axis_is_refused():
    from tdax_torch.models.qwen_vl.model import extract_layer_activations, init_params
    from tdax_torch.ops.flash_attention import flash_sharding
    params = init_params(CFG, "cpu", with_visual=False)
    ids = torch.ones(1, 8, dtype=torch.long)
    with flash_sharding(_Grid(dp=1, tp=1, cp=2), "dp", "tp", seq_axis="cp"), \
            torch.inference_mode(), pytest.raises(NotImplementedError, match="seq axis"):
        extract_layer_activations(params, CFG, ids, torch.ones_like(ids),
                                  torch.zeros(1, dtype=torch.long))
