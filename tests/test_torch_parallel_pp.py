"""The port's pipeline parallelism against tdax's, on the CPU (tdax's
dry-run stage 9, ``__graft_entry__.py:363-399``; tests/test_parallel.py's
pipeline tests).

tdax runs ``pipeline_forward``, ``pipeline_1f1b_grads`` and
``make_train_step_pp`` on the conftest's 8 virtual XLA devices and its
plain forward and step on one device; the port runs a gloo world of 8
ranks (``torch_parallel_worlds.pp_world``, spawned once per test
session), each rank its stage (``shard_params_pp``) and its dp rows.
Both take the same numpy trees (tdax's tiny f32 init, every bias and
norm moved off 0 and 1) and the same batches (numpy seeds; T = 24, the
last 4 positions of every row masked, as tests/test_parallel.py:161-175);
AdamW at lr 1e-3 with the global-norm clip.  Checks and their tolerances:

  * ``_schedule_1f1b``'s tables equal tdax's for every (S, M) of
    tests/test_parallel.py:248 (no world);
  * ``pipeline_forward`` at dp=2 pp=4 with 2 microbatches against the
    port's one-device forward within rtol 1e-5, atol 1e-6; with 4
    microbatches and remat within rtol 2e-5, atol 1e-5
    (tests/test_parallel.py:189, :215); with images likewise at 2.
    Against tdax's pipeline_forward and its one-device forward, all three
    within rtol 2e-5, atol 1e-5: tdax's reduction-order tolerance
    (:213-215), since XLA and PyTorch sum the products in other orders
    (~4e-6 at logits of ~4, where tdax's own pipeline and plain forward
    agree bitwise);
  * ``make_train_step_pp`` (1F1B) at dp=2 pp=4 with 2 microbatches, with
    4 and remat, and at dp=4 pp=2, and the GPipe schedule (with and
    without a visual subtree) against tdax's step on the same mesh and
    schedule and against its plain step: the loss within rtol 1e-5,
    AdamW's first moment within 1e-4 relative plus 1e-5 of each leaf's
    largest magnitude, the updated tree (``unshard_params_pp``) within
    rtol 1e-3, atol 1e-5 wherever the gradient is 0 or at least
    ILL_CONDITIONED (tests/test_torch_parallel_cp.py has why);
  * ``pipeline_1f1b_grads`` against tdax's: ce within rtol 1e-5, then
    dlayers, dhead and dx on the ranks that hold them, divided by the
    token count, within rtol 1e-4, atol 1e-6 (tests/test_parallel.py:299-304);
  * a bf16 1F1B step: finite, its loss within rtol 2e-2 of tdax's plain
    bf16 step's (tests/test_parallel.py:315-345);
  * the collectives of a step, the placement of the stage trees, the
    chain permute and its backward, and the refusals.
"""

import concurrent.futures
import pickle

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from tdax.models.qwen_vl import QwenVLConfig as JConfig
from tdax.models.qwen_vl import forward as j_forward
from tdax.models.qwen_vl import init_params as j_init_params
from tdax.models.qwen_vl.model import embed_inputs as j_embed_inputs
from tdax.parallel import make_pp_mesh as j_make_pp_mesh
from tdax.parallel import make_train_step as j_make_train_step
from tdax.parallel import make_train_step_pp as j_make_train_step_pp
from tdax.parallel import pipeline_1f1b_grads as j_pipeline_1f1b_grads
from tdax.parallel import pipeline_forward as j_pipeline_forward
from tdax.parallel import shard_params_pp as j_shard_params_pp
from tdax.parallel.pipeline import _schedule_1f1b as j_schedule_1f1b
from tdax.parallel.train import default_optimizer as j_default_optimizer

import torch

import torch_parallel_worlds as worlds
from tdax_torch.models.qwen_vl import QwenVLConfig

CFG = QwenVLConfig.tiny(dtype="float32")
JCFG = JConfig.tiny(dtype="float32")
LOSS_RTOL = 1e-5
FWD_TOL = dict(rtol=1e-5, atol=1e-6)           # tests/test_parallel.py:189
FWD_MB1_TOL = dict(rtol=2e-5, atol=1e-5)       # tests/test_parallel.py:215
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)          # tests/test_parallel.py:299-304
BF16_LOSS_RTOL = 2e-2                          # tests/test_parallel.py:337
PARAM_TOL = dict(rtol=1e-3, atol=1e-5)
MOMENT_RTOL, MOMENT_ATOL_OF_MAX = 1e-4, 1e-5
ILL_CONDITIONED = 10 * 1e-8     # |g| below 10 Adam eps: the first step's update is noise-bound
SCHEDULES = [(2, 2), (4, 2), (4, 4), (4, 8), (4, 16), (8, 4), (3, 5)]  # test_parallel.py:248


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


def _batch(seed: int, b: int, t: int = 24) -> dict:
    rng = np.random.default_rng(seed)
    mask = np.ones((b, t), np.int32)
    mask[:, t - 4:] = 0  # the ragged tail of tests/test_parallel.py:168
    return {"input_ids": rng.integers(1, CFG.vocab_size, (b, t)).astype(np.int32),
            "attn_mask": mask}


def _inputs() -> dict:
    images = _batch(12, 8)
    nq, size = CFG.visual.n_queries, CFG.visual.image_size
    pos = np.full((8, nq), -1, np.int32)
    pos[0::2] = np.arange(2, 2 + nq)
    images["image_positions"] = pos
    images["images"] = np.random.default_rng(13).normal(
        size=(8, 3, size, size)).astype(np.float32)
    return {"tree": _tree(9, False), "tree_visual": _tree(10, True), "batch8": _batch(9, 8),
            "batch16": _batch(21, 16), "batch_images": images}


def _adam_mu(state):
    return next(s for s in jax.tree_util.tree_leaves(
        state, is_leaf=lambda node: hasattr(node, "mu")) if hasattr(s, "mu")).mu


def _tdax(inp: dict, pool) -> dict:
    """tdax's pipeline calls on the 8 virtual devices and its one-device
    forward and steps, run in ``pool``'s threads."""
    opt = j_default_optimizer(1e-3)
    meshes = {"pp4": j_make_pp_mesh(pp=4, dp=2), "pp2": j_make_pp_mesh(pp=2, dp=4)}

    def put(batch, mesh):
        b = {k: jnp.asarray(v) for k, v in batch.items()}
        if mesh is None:
            return b
        return {k: jax.device_put(v, NamedSharding(mesh, P("dp"))) for k, v in b.items()}

    def params(tree, mesh=None, dtype=jnp.float32):
        p = jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)
        return p if mesh is None else j_shard_params_pp(p, mesh)

    def fwd(tree, batch, mesh=None, **kw):
        b = put(batch, mesh)
        if mesh is None:
            run = jax.jit(lambda p, b: j_forward(p, JCFG, b["input_ids"], b["attn_mask"],
                                                 b.get("images"), b.get("image_positions")))
        else:
            run = jax.jit(lambda p, b: j_pipeline_forward(
                p, JCFG, b["input_ids"], b["attn_mask"], mesh, images=b.get("images"),
                image_positions=b.get("image_positions"), **kw))
        return np.asarray(run(params(tree, mesh), b))

    def step(tree, batch, mesh=None, dtype=jnp.float32, **kw):
        p, b = params(tree, mesh, dtype), put(batch, mesh)
        cfg = JConfig.tiny(dtype="bfloat16") if dtype == jnp.bfloat16 else JCFG
        make = j_make_train_step(cfg, opt) if mesh is None else j_make_train_step_pp(
            cfg, opt, mesh, **kw)
        p, state, loss = make(p, opt.init(p), b)
        return {"loss": float(loss), "params": jax.tree.map(np.asarray, p),
                "mu": jax.tree.map(np.asarray, _adam_mu(state))}

    def grads(tree, batch):
        mesh = meshes["pp4"]
        p, b = params(tree, mesh), put(batch, mesh)
        x = j_embed_inputs(params(tree), JCFG, jnp.asarray(batch["input_ids"]), None, None)
        run = jax.jit(lambda p, x, b: j_pipeline_1f1b_grads(
            p["layers"], {"ln_f": p["ln_f"], "lm_head": p["lm_head"]}, x, b["input_ids"],
            b["attn_mask"], JCFG, mesh, n_micro=4, remat=True))
        ce, dl, dh, dx = run(p, jax.device_put(x, NamedSharding(mesh, P("dp"))), b)
        return {"ce": float(ce), "dlayers": jax.tree.map(np.asarray, dl),
                "dhead": jax.tree.map(np.asarray, dh), "dx": np.asarray(dx)}

    tree, tree_v = inp["tree"], inp["tree_visual"]
    b8, b16, bi = inp["batch8"], inp["batch16"], inp["batch_images"]
    pp4, pp2 = meshes["pp4"], meshes["pp2"]
    calls = {  # name: (function, positional arguments, keywords)
        "fwd_m2": (fwd, (tree, b8, pp4), dict(n_micro=2)),
        "fwd_m2_plain": (fwd, (tree, b8), {}),
        "fwd_m4_remat": (fwd, (tree, b16, pp4), dict(n_micro=4, remat=True)),
        "fwd_m4_plain": (fwd, (tree, b16), {}),
        "fwd_images": (fwd, (tree_v, bi, pp4), dict(n_micro=2)),
        "fwd_images_plain": (fwd, (tree_v, bi), {}),
        "step_m2": (step, (tree, b8, pp4), dict(n_micro=2)),
        "step_m4_remat": (step, (tree, b16, pp4), dict(n_micro=4, remat=True)),
        "step_dp4_pp2": (step, (tree, b16, pp2), dict(n_micro=2)),
        "gpipe": (step, (tree, b16, pp4), dict(n_micro=4, schedule="gpipe")),
        "gpipe_visual": (step, (tree_v, b8, pp4), dict(n_micro=2, schedule="gpipe")),
        "plain8": (step, (tree, b8), {}),
        "plain16": (step, (tree, b16), {}),
        "plain_bf16": (step, (tree, b8), dict(dtype=jnp.bfloat16)),
        "grads": (grads, (tree, b16), {}),
    }
    futures = {name: pool.submit(fn, *args, **kw) for name, (fn, args, kw) in calls.items()}
    return {name: f.result() for name, f in futures.items()}


def _compute(work) -> dict:
    inp = _inputs()
    inp_path = work / "inp.pkl"
    with open(inp_path, "wb") as f:
        pickle.dump(inp, f)
    (work / "eight").mkdir()
    # the ranks run while tdax compiles: the world waits on its processes
    with concurrent.futures.ThreadPoolExecutor(max_workers=4) as pool:
        eight = pool.submit(worlds.run_world, worlds.pp_world, 8, work / "eight",
                            str(inp_path))
        tdax = _tdax(inp, pool)
        return {"inp": inp, "tdax": tdax, "eight": eight.result()}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return worlds.once(tmp_path_factory, "torch_parallel_pp", _compute)


def _leaves(tree, path=""):
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            yield from _leaves(leaf, f"{path}/{name}")
        else:
            yield f"{path}/{name}", np.asarray(leaf)


def _close_moments(got: dict, want: dict):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    top = max(float(np.abs(w).max()) for w in want.values())
    for path, w in want.items():
        tol = MOMENT_RTOL * np.abs(w) + MOMENT_ATOL_OF_MAX * np.abs(w).max()
        assert (np.abs(got[path] - w) <= tol).all(), path
    assert top > 0


def _close_params(got: dict, want: dict, mu: dict):
    """Every entry whose gradient (10 |mu|, tdax's) is 0 (a token the batch
    lacks: no step but the weight decay) or at least ILL_CONDITIONED; the
    entries between are a handful."""
    got, want, mu = dict(_leaves(got)), dict(_leaves(want)), dict(_leaves(mu))
    assert got.keys() == want.keys()
    skipped = 0
    for path, w in want.items():
        held = (mu[path] == 0) | (10 * np.abs(mu[path]) >= ILL_CONDITIONED)
        skipped += int((~held).sum())
        np.testing.assert_allclose(got[path][held], w[held], err_msg=path, **PARAM_TOL)
    assert skipped <= 1e-3 * sum(w.size for w in want.values())


# ---- the schedule, no world -----------------------------------------------------------

@pytest.mark.parametrize("S,M", SCHEDULES)
def test_schedule_1f1b_tables_equal_tdax(S, M):
    from tdax_torch.parallel.pipeline import _schedule_1f1b
    got, want = _schedule_1f1b(S, M), j_schedule_1f1b(S, M)
    assert got.keys() == want.keys()
    for key, w in want.items():
        if isinstance(w, np.ndarray):
            assert got[key].dtype == w.dtype, key
            np.testing.assert_array_equal(got[key], w, err_msg=key)
        else:
            assert got[key] == w, key


@pytest.mark.parametrize("S,M", SCHEDULES)
def test_gpipe_table_is_fill_drain(S, M):
    """Every stage runs M forwards, then M backwards, saving all M inputs;
    each send leaves in the slot its payload was computed."""
    from tdax_torch.parallel.pipeline import _schedule_gpipe
    g = _schedule_gpipe(S, M)
    assert g["n_slots"] == 2 * (M + S - 1) and g["b_in"] == M
    for s in range(S):
        fw, bw = np.flatnonzero(g["fw_do"][:, s]), np.flatnonzero(g["bw_do"][:, s])
        assert len(fw) == len(bw) == M and fw.max() < bw.min()
        np.testing.assert_array_equal(g["fw_mb"][fw, s], np.arange(M))
        np.testing.assert_array_equal(g["bw_mb"][bw, s], np.arange(M))
    np.testing.assert_array_equal(g["sh_do"][:, :S - 1], g["fw_do"][:, :S - 1])
    np.testing.assert_array_equal(g["sg_do"][:, 1:], g["bw_do"][:, 1:])


# ---- the forward ----------------------------------------------------------------------

FORWARDS = [("fwd_m2", FWD_TOL), ("fwd_m4_remat", FWD_MB1_TOL), ("fwd_images", FWD_TOL)]


@pytest.mark.parametrize("name,tol", FORWARDS)
def test_pipeline_forward_matches_one_device(results, name, tol):
    """The pipeline claim, tdax's tolerance: the port's pipeline against
    the port's one-device forward of the same batch."""
    for rank in results["eight"]:
        np.testing.assert_allclose(rank[name]["pipeline"], rank[name]["one_device"], **tol)


@pytest.mark.parametrize("name", [name for name, _ in FORWARDS])
@pytest.mark.parametrize("ref", ["pipeline", "plain"])
def test_pipeline_forward_matches_tdax(results, name, ref):
    """Against tdax's pipeline_forward and its one-device forward (equal to
    each other here): XLA and PyTorch sum the products in other orders,
    ~4e-6 at logits of ~4, so tdax's reduction-order tolerance holds."""
    want = results["tdax"][name if ref == "pipeline" else name.replace("_remat", "") + "_plain"]
    for rank in results["eight"]:
        np.testing.assert_allclose(rank[name]["pipeline"], want, **FWD_MB1_TOL)


# ---- the train step -------------------------------------------------------------------

# (the port's run, tdax's run)
STEPS = [("step_m2", "step_m2"), ("step_m2", "plain8"), ("step_m4_remat", "step_m4_remat"),
         ("step_m4_remat", "plain16"), ("step_dp4_pp2", "step_dp4_pp2"),
         ("step_dp4_pp2", "plain16"), ("gpipe", "gpipe"), ("gpipe", "plain16"),
         ("gpipe_visual", "gpipe_visual")]


@pytest.mark.parametrize("run,ref", STEPS)
def test_pp_step_loss_matches_tdax(results, run, ref):
    for rank in results["eight"]:
        np.testing.assert_allclose(rank[run]["loss"], results["tdax"][ref]["loss"],
                                   rtol=LOSS_RTOL)


@pytest.mark.parametrize("run,ref", STEPS)
def test_pp_step_params_match_tdax(results, run, ref):
    want = results["tdax"][ref]
    for rank in results["eight"][:4]:
        _close_params(rank[run]["params"], want["params"], want["mu"])


@pytest.mark.parametrize("run,ref", STEPS)
def test_pp_step_moments_match_tdax(results, run, ref):
    _close_moments(results["eight"][0][run]["mu"], results["tdax"][ref]["mu"])


def test_every_rank_unshards_the_same_tree(results):
    first = dict(_leaves(results["eight"][0]["step_m4_remat"]["params"]))
    for rank in results["eight"][1:]:
        for path, leaf in _leaves(rank["step_m4_remat"]["params"]):
            np.testing.assert_array_equal(leaf, first[path], err_msg=path)


def test_bf16_step_is_finite_and_near_tdax(results):
    want = results["tdax"]["plain_bf16"]["loss"]
    for rank in results["eight"]:
        got = rank["bf16"]["loss"]
        assert np.isfinite(got)
        np.testing.assert_allclose(got, want, rtol=BF16_LOSS_RTOL)


# ---- pipeline_1f1b_grads --------------------------------------------------------------

def test_1f1b_grads_match_tdax(results):
    ranks, want = results["eight"], results["tdax"]["grads"]
    mask = results["inp"]["batch16"]["attn_mask"]
    n = float(np.sum(mask[:, 1:] > 0))
    for rank in ranks:
        np.testing.assert_allclose(rank["grads"]["ce"], want["ce"], rtol=LOSS_RTOL)
    by_stage = sorted((r for r in ranks if r["dp"] == 0), key=lambda r: r["stage"])
    for name, w in want["dlayers"].items():
        got = np.concatenate([r["grads"]["dlayers"][name] for r in by_stage])
        np.testing.assert_allclose(got / n, w / n, err_msg=name, **GRAD_TOL)
    for r in ranks:
        last, first = r["stage"] == 3, r["stage"] == 0
        assert (r["grads"]["dhead"] is not None) == last
        assert (r["grads"]["dx"] is not None) == first
        if last:
            for name, w in want["dhead"].items():
                np.testing.assert_allclose(r["grads"]["dhead"][name] / n, w / n, err_msg=name,
                                           **GRAD_TOL)
        if first:
            rows = slice(8 * r["dp"], 8 * (r["dp"] + 1))
            np.testing.assert_allclose(r["grads"]["dx"] / n, want["dx"][rows] / n, **GRAD_TOL)


# ---- placement, collectives, the chain ------------------------------------------------

def test_stages_hold_only_what_they_read(results):
    """The departure by design: wte on the first stage, ln_f and lm_head
    on the last, each stage its L / pp layers; unshard_params_pp gives the
    whole tree back, bitwise."""
    per = CFG.num_layers // 4
    for rank in results["eight"]:
        layout = rank["step_m2"]["layout"]
        want = {"layers": (per, CFG.hidden_size)}
        if rank["stage"] == 0:
            want["wte"] = None
        if rank["stage"] == 3:
            want.update(ln_f=None, lm_head=None)
        assert layout == want
        got = dict(_leaves(rank["roundtrip"]))
        tree = dict(_leaves(results["inp"]["tree_visual"]))
        assert got.keys() == tree.keys()
        for path, leaf in tree.items():
            np.testing.assert_array_equal(got[path], leaf, err_msg=path)


def test_step_collectives(results):
    """A 1F1B step at dp=2 pp=4 with M = 2: each stage's sends (M
    activations, M gradients, fewer at the ends: 2M(S - 1) over a pp
    group), the loss's and the clip's all_reduce over pp, and over dp the
    token count, the loss, every gradient of the stage (8 stacked layer
    leaves, ln_f and lm_head on the last, wte on the first)."""
    m = 2
    for rank in results["eight"]:
        s = rank["stage"]
        sends = m * ((s < 3) + (s > 0))
        dp = 2 + 8 + 2 * (s == 3) + (s == 0)
        assert rank["step_m2"]["by_axis"] == {"pp.ppermute": sends, "pp.all_reduce": 2,
                                              "dp.all_reduce": dp}
    assert sum(r["step_m2"]["by_axis"]["pp.ppermute"] for r in results["eight"]) == \
        2 * 2 * m * (4 - 1)


def test_chain_permute_and_its_backward(results):
    for rank in results["eight"]:
        s, d = rank["stage"], rank["dp"]
        chain = rank["chain"]
        y_want = 0.0 if s == 0 else float(d * 4 + s)  # the rank before: d*4 + s - 1, plus 1
        np.testing.assert_array_equal(chain["y"], np.full((2, 3), y_want, np.float32))
        g_want = 0.0 if s == 3 else 10.0 * (s + 2)  # the next stage's weight
        np.testing.assert_array_equal(chain["grad"], np.full((2, 3), g_want, np.float32))
        assert chain["by_axis"] == {"pp.ppermute": 2}


# ---- refusals, before any collective --------------------------------------------------

class _Grid:
    """A mesh's shape and this rank's place: all the checks read."""

    def __init__(self, **shape):
        self.shape = shape

    def local_rank(self, axis):
        return 0


def test_pp_refusals():
    from tdax_torch.models.qwen_vl.model import init_params
    from tdax_torch.parallel import default_optimizer, make_train_step_pp, pipeline_forward
    from tdax_torch.parallel import shard_params_pp
    opt = default_optimizer()
    with pytest.raises(ValueError, match="unknown pipeline schedule 'zb'"):
        make_train_step_pp(CFG, opt, _Grid(dp=1, pp=2), 2, schedule="zb")
    with pytest.raises(ValueError, match="num_layers=4 not divisible by pp=3"):
        make_train_step_pp(CFG, opt, _Grid(dp=1, pp=3), 2)
    params = init_params(CFG, "cpu", with_visual=False)
    with pytest.raises(ValueError, match="num_layers=4 not divisible by pp=8"):
        shard_params_pp(params, _Grid(dp=1, pp=8))
    ids = torch.ones(6, 8, dtype=torch.long)
    with pytest.raises(ValueError, match="per-dp batch 6 not divisible by n_micro=4"):
        pipeline_forward(params, CFG, ids, None, _Grid(dp=1, pp=1), 4)
    step = make_train_step_pp(CFG, opt, _Grid(dp=1, pp=1), 4)
    with pytest.raises(ValueError, match="per-dp batch 6 not divisible by n_micro=4"):
        step(params, opt.init(params), {"input_ids": ids, "attn_mask": torch.ones_like(ids)})


def test_1f1b_refuses_a_visual_subtree():
    from tdax_torch.models.qwen_vl.model import init_params
    from tdax_torch.parallel import default_optimizer, make_train_step_pp
    params = init_params(CFG, "cpu")
    opt = default_optimizer()
    step = make_train_step_pp(CFG, opt, _Grid(dp=1, pp=1), 1)
    ids = torch.ones(2, 8, dtype=torch.long)
    with pytest.raises(ValueError, match="trains wte, layers, ln_f and lm_head.*'visual'"):
        step(params, opt.init(params), {"input_ids": ids, "attn_mask": torch.ones_like(ids)})


@pytest.mark.parametrize("perm", [[(0, 1), (0, 2)], [(0, 2), (1, 2)], [(0, 4)]])
def test_a_permutation_naming_a_rank_twice_is_refused(perm):
    from tdax_torch.parallel import mesh as pm
    with pytest.raises(ValueError, match="not a permutation of mesh axis 'pp'"):
        pm.ppermute(torch.zeros(2), _Grid(dp=1, pp=4), "pp", perm)
