"""The port's dp x tp training step and sequence parallelism against
tdax's, on the CPU (tdax's dry-run stages 4 and 8).

tdax runs its sharded ``jit`` on the conftest's 8 virtual XLA devices;
the port runs a gloo world of 8 ranks at dp=2 tp=4 and a world of one
(``torch_parallel_worlds``), each spawned once per test session.  Both
take the same numpy tree (tdax's tiny f32 init, text-only unless named,
every bias and norm moved off 0 and 1 so that a gradient missing a
rank's share would show) and the same batches (numpy seeds); AdamW at
lr 1e-3 with the global-norm clip.  Checks and their tolerances:

  * one step at dp=2 tp=4 against tdax's sharded step: the loss within
    rtol 1e-5, the updated params within rtol 1e-3 and atol 1e-5 (tdax's
    own tolerance for its sequence-parallel step: Adam's m / sqrt(v)
    turns a gradient's summation-order noise near zero into a visible
    step); with images (the ViT's column sites, its 2 heads whole at tp
    4) against tdax's one-device step, AdamW's first moment (a tenth of
    the clipped gradient) within 1e-4 relative plus 1e-5 of each leaf's
    largest magnitude, since there the params' step amplifies one
    decoder weight's near-zero gradient (|g| ~ 1e-8, Adam's eps) past
    1e-3 relative; the key biases' moments, zero in exact arithmetic,
    below 1e-6 of the largest moment on both sides;
  * the loss falls by 10% over 8 steps on a fixed batch
    (tests/test_parallel.py:59-78);
  * the sequence-parallel step (remat on) against the plain step, masks
    differing between the dp ranks: the loss within tdax's rtol 1e-6
    and the params within the tolerance above; against tdax's
    sequence-parallel step likewise; its collectives counted, remat's
    replay included;
  * ``lm_loss`` over the mesh: the token-weighted mean over every dp
    rank's tokens, within rtol 1e-5 of tdax's one-device ``lm_loss``;
  * ``accum_steps = 2`` over the mesh against the full-batch step over
    it: the loss within rtol 1e-6, AdamW's first moment within 1e-4
    relative plus 1e-5 of each leaf's largest magnitude
    (tests/test_torch_train_step.py's accumulation tolerance);
  * ``train_loop`` over the mesh stopped after its first checkpoint and
    resumed: bitwise the uninterrupted run, its checkpoint the whole
    tree;
  * a world of one (dp=1 tp=1, plain and sequence-parallel): bitwise the
    step without a process group.
"""

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
from tdax.parallel.train import lm_loss as j_lm_loss

import torch_parallel_worlds as worlds
from tdax_torch.models.qwen_vl import QwenVLConfig

CFG = QwenVLConfig.tiny(dtype="float32")
JCFG = JConfig.tiny(dtype="float32")
LOSS_RTOL = 1e-5                          # against tdax's sharded step
SP_LOSS_RTOL = 1e-6                       # tdax's sequence-parallel test
PARAM_TOL = dict(rtol=1e-3, atol=1e-5)    # tdax's sequence-parallel test
MOMENT_RTOL, MOMENT_ATOL_OF_MAX = 1e-4, 1e-5   # tests/test_torch_train_step.py
NOISE_OF_MAX = 1e-6   # a zero gradient's rounding noise, of the largest moment
N_STEPS = 8


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
    rng = np.random.default_rng(2)
    b, t = 4, 16
    batch = {"input_ids": rng.integers(1, 64, (b, t)).astype(np.int32),  # learnable
             "attn_mask": np.ones((b, t), np.int32)}
    t_sp = 32
    sp = {"input_ids": rng.integers(1, CFG.vocab_size, (b, t_sp)).astype(np.int32),
          "attn_mask": np.ones((b, t_sp), np.int32)}
    sp["attn_mask"][2:, 20:] = 0   # dp rank 1's rows: fewer real tokens than rank 0's
    sp["attn_mask"][3, 9:] = 0
    nq, size = CFG.visual.n_queries, CFG.visual.image_size
    pos = np.full((b, nq), -1, np.int32)
    pos[0::2] = np.arange(2, 2 + nq)
    images = {"input_ids": rng.integers(1, CFG.vocab_size, (b, t_sp)).astype(np.int32),
              "attn_mask": np.ones((b, t_sp), np.int32), "image_positions": pos,
              "images": rng.normal(size=(b, 3, size, size)).astype(np.float32)}
    images["attn_mask"][1, 25:] = 0
    accum = {"input_ids": rng.integers(1, 64, (b, t)).astype(np.int32),
             "attn_mask": np.ones((b, t), np.int32)}
    accum["attn_mask"][:, 12:] = np.arange(b)[:, None] % 2  # ragged microbatches
    return {"tree": _tree(15, False), "tree_visual": _tree(16, True), "batch": batch,
            "batch_sp": sp, "batch_images": images, "batch_accum": accum}


def _tdax(inp: dict) -> dict:
    """tdax's sharded steps at dp=2 tp=4, its one-device images step and
    its one-device lm_loss."""
    mesh = j_make_mesh(dp=2, tp=4)
    bs = j_batch_sharding(mesh)

    def step(tree, batch, sharded=True, **kw):
        p = jax.tree.map(jnp.asarray, tree)
        b = {k: jnp.asarray(v) for k, v in batch.items()}
        if sharded:
            p = j_shard_params(p, mesh, j_rules(with_visual="visual" in tree))
            b = {k: jax.device_put(v, bs) for k, v in b.items()}
        opt = j_default_optimizer(1e-3)
        p, state, loss = j_make_train_step(JCFG, opt, **kw)(p, opt.init(p), b)
        adam = next(s for s in jax.tree_util.tree_leaves(
            state, is_leaf=lambda node: hasattr(node, "mu")) if hasattr(s, "mu"))
        return {"loss": float(loss), "params": jax.tree.map(np.asarray, p),
                "mu": jax.tree.map(np.asarray, adam.mu)}

    sp = inp["batch_sp"]
    return {"step": step(inp["tree"], inp["batch"]),
            "plain_sp_batch": step(inp["tree"], sp),
            "sp": step(inp["tree"], sp, sp_mesh=mesh, remat=True),
            "images": step(inp["tree_visual"], inp["batch_images"], sharded=False,
                           with_images=True),
            "lm_loss": float(j_lm_loss(jax.tree.map(jnp.asarray, inp["tree"]), JCFG,
                                       jnp.asarray(sp["input_ids"]),
                                       jnp.asarray(sp["attn_mask"])))}


def _compute(work) -> dict:
    inp = _inputs()
    inp_path = work / "inp.pkl"
    with open(inp_path, "wb") as f:
        pickle.dump(inp, f)
    for name in ("eight", "one"):
        (work / name).mkdir()
    eight = worlds.run_world(worlds.train_world, 8, work / "eight", str(inp_path),
                             str(work / "eight"))
    one = worlds.run_world(worlds.one_train_world, 1, work / "one", str(inp_path))[0]
    return {"inp": inp, "tdax": _tdax(inp), "eight": eight, "one": one}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return worlds.once(tmp_path_factory, "torch_parallel_train", _compute)


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
    """True at the entries whose gradient is zero in exact arithmetic
    (softmax does not change when every score of a row moves by one
    constant): the resampler's key bias and the key third of the ViT's
    qkv bias.  Both packages hold rounding noise there."""
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


# ---- stage 4: the dp x tp step -------------------------------------------------------

@pytest.mark.parametrize("case", ["step", "plain_sp_batch", "images"])
def test_step_matches_tdax(results, case):
    got, want = _every_rank(results, case), results["tdax"][case]
    np.testing.assert_allclose(got["losses"][0], want["loss"], rtol=LOSS_RTOL)
    if case == "images":
        _close_moments(got["mu"], want["mu"])
    else:
        _close_trees(got["params"], want["params"])


def test_loss_falls_over_eight_steps(results):
    losses = _every_rank(results, "steps")["losses"]
    print(f"dp=2 tp=4 losses: {np.round(losses, 4).tolist()}")
    assert len(losses) == N_STEPS and np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.9


# ---- stage 8: sequence parallelism ---------------------------------------------------

@pytest.mark.parametrize("ref", ["port_plain", "tdax_sp"])
def test_sequence_parallel_step_matches(results, ref):
    got = _every_rank(results, "sp")
    if ref == "port_plain":
        want = results["eight"][0]["plain_sp_batch"]
        want = {"loss": want["losses"][0], "params": want["params"]}
    else:
        want = results["tdax"]["sp"]
    np.testing.assert_allclose(got["losses"][0], want["loss"], rtol=SP_LOSS_RTOL)
    _close_trees(got["params"], want["params"])


def test_sequence_parallel_collectives(results):
    """Per rank, one step of the 4-layer model with remat: the forward's
    2 sequence gathers and 2 reduce-scatters a layer, each with its
    conjugate in the backward; remat's replay of a block, which stops at
    the last tensor the backward needs (checkpoint's early stop), so it
    replays the 2 gathers and the attention's reduce-scatter, not the
    MLP's; the LM head's sequence and vocab gathers; the norms' gradient
    sums (2 a layer and ln_f); the loss's 2 dp sums; 35 leaves' dp
    gradient sums and the clip's tp sum.  Every rank counts the same.
    Under gloo a reduce-scatter is an all_reduce of the whole tensor."""
    layers = CFG.num_layers
    want = {"gloo.all_gather": 2 * layers + 2 + 4 * layers + 1,
            "gloo.reduce_scatter": 2 * layers + 1 + 3 * layers,
            "gloo.all_reduce": 2 + 1 + 2 * layers + 3 + 8 * layers + 1}
    for out in results["eight"]:
        assert out["sp"]["collectives"] == want
    plain = {"gloo.all_gather": 1,
             "gloo.all_reduce": 2 * layers + 2 + 2 * layers + 1 + 3 + 8 * layers + 1}
    assert results["eight"][0]["plain_sp_batch"]["collectives"] == plain


def test_lm_loss_is_the_global_token_mean(results):
    for out in results["eight"]:
        np.testing.assert_allclose(out["lm_loss"], results["tdax"]["lm_loss"], rtol=LOSS_RTOL)


# ---- accumulation and the loop -------------------------------------------------------

def test_accum_steps_equal_the_full_batch_over_the_mesh(results):
    got, want = results["eight"][0]["accum"], results["eight"][0]["full_batch"]
    np.testing.assert_allclose(got["losses"][0], want["losses"][0], rtol=1e-6)
    _close_moments(got["mu"], want["mu"])


def test_train_loop_resumes_bitwise_over_the_mesh(results):
    for out in results["eight"]:
        loop = out["loop"]
        assert loop["count"] == loop["resumed_count"] == 4
        assert loop["resumed_losses"] == loop["full_losses"][2:]
        _equal_trees(loop["resumed"], loop["full"])
    loop = results["eight"][0]["loop"]
    _equal_trees(loop["saved_params"], loop["full"])  # rank 0 wrote the whole tree


# ---- the world of one ----------------------------------------------------------------

@pytest.mark.parametrize("case", ["plain", "sp"])
def test_world_of_one_trains_bitwise_one_device(results, case):
    one, got = results["one"]["one"], results["one"][case]
    assert got["losses"] == one["losses"]
    _equal_trees(got["params"], one["params"])
    _equal_trees(got["mu"], one["mu"])


def test_world_of_one_lm_loss_and_collectives(results):
    one = results["one"]
    assert one["lm_loss"] == one["one"]["lm_loss"]
    # the loss's two dp sums, 35 leaves' dp sums and the clip's tp sum
    assert one["plain"]["collectives"] == {"gloo.all_reduce": 2 + 35 + 1}


# ---- arguments refused before any collective -----------------------------------------

class _Grid:
    """A mesh's shape and this rank's place: all the checks read."""
    shape = {"dp": 1, "tp": 4}

    def local_rank(self, axis):
        return 0


def test_sp_mesh_and_cp_mesh_are_refused_as_in_tdax():
    """Both shard the sequence (tdax's ValueError); a cp_mesh must have a
    "cp" axis (this dp x tp grid has none)."""
    from tdax_torch.parallel import default_optimizer, make_train_step
    with pytest.raises(ValueError, match="mutually exclusive"):
        make_train_step(CFG, default_optimizer(), sp_mesh=_Grid(), cp_mesh=_Grid(), device="cpu")
    with pytest.raises(ValueError, match="no 'cp'"):
        make_train_step(CFG, default_optimizer(), cp_mesh=_Grid(), device="cpu")


def test_sequence_parallelism_needs_tp_to_divide_the_sequence():
    import torch
    from tdax_torch.models.qwen_vl.tp import seq_scatter, tp_input
    with pytest.raises(ValueError, match="30 positions do not divide over the 4 ranks"):
        seq_scatter(torch.zeros(2, 30, 8), (_Grid(), "tp"))
    with pytest.raises(NotImplementedError, match="tp to divide the heads"):
        tp_input(torch.zeros(2, 8, 8), False, (_Grid(), "tp"))
