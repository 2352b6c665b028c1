"""The port's multi-device serving against tdax's, on the CPU.

tdax runs its sharded ``jit`` on the conftest's 8 virtual XLA devices;
the port runs a world of 8 gloo ranks (one process each) and a world of
one (``torch_parallel_worlds``).  Both take the same numpy trees (the
tiny f32 config, seed 0 for the capture and seed 3 for generation as
tdax's dryrun, biases and norms moved off 0 and 1 so that a bias added
on every tp rank would show) and the same inputs (numpy, seed 0).  The
stages are those of ``__graft_entry__.py``'s multi-device dry run:

  1. the capture at dp=2 tp=4 (the tiny ViT's 2 heads run replicated)
     against tdax's single device and tdax's dp=2 tp=4 ``jit``;
  7. dp=4 tp=2 with the port's plain flash per shard against tdax's
     interpret-mode kernel under ``flash_sharding``;
  6. dp=2 tp=4 generation: greedy tokens equal to tdax's, the int8-cache
     decode logits within tdax's 2e-3 / 5e-3;
  5. dp=8 extraction (a ragged tail), crashed after its first checkpoint
     and resumed: equal to the uninterrupted run within tdax's 1e-5 /
     1e-6, and to tdax's within the single-device capture's 1e-4.

Stages 1 and 7 use tdax's 2e-3 / 5e-3: the row-parallel sums add the tp
partials in another order.  A world of one (dp=1, tp=1) is bitwise the
single-device path.  Every world runs once per test session
(``torch_parallel_worlds.once``), and each check is a case over its
results.
"""

import os
import pickle

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tdax.config import DatasetConfig as JDatasetConfig
from tdax.config import ExtractConfig as JExtractConfig
from tdax.data import generate_dataset as j_generate_dataset
from tdax.models.qwen_vl import QwenVLConfig as JConfig
from tdax.models.qwen_vl import init_params as j_init_params
from tdax.models.qwen_vl.generate import _decode_step as j_decode_step
from tdax.models.qwen_vl.generate import generate as j_generate
from tdax.models.qwen_vl.generate import prefill as j_prefill
from tdax.models.qwen_vl.model import extract_layer_activations as j_capture
from tdax.ops.flash_attention import flash_sharding as j_flash_sharding
from tdax.parallel import make_mesh as j_make_mesh
from tdax.parallel import param_sharding_rules as j_rules
from tdax.parallel import shard_params as j_shard_params
from tdax.parallel.mesh import batch_sharding as j_batch_sharding
from tdax.pipeline.extract import extract_activations as j_extract_activations

import torch_parallel_worlds as worlds
from tdax_torch.models.qwen_vl import QwenVLConfig
from tdax_torch.models.qwen_vl.convert import params_from_numpy
from tdax_torch.models.qwen_vl.model import extract_layer_activations, forward
from tdax_torch.models.qwen_vl.quantize import quantize_weight
from tdax_torch.ops import flash_attention as fa
from tdax_torch.parallel import mesh as pm

CFG = QwenVLConfig.tiny(dtype="float32")
JCFG = JConfig.tiny(dtype="float32")
MESH_TOL = dict(rtol=2e-3, atol=5e-3)      # tdax's stages 1, 6 and 7
RESUME_TOL = dict(rtol=1e-5, atol=1e-6)    # tdax's stage 5
CAPTURE_TOL = dict(rtol=1e-4, atol=1e-4)   # the single-device capture's (test_torch_extract)
N_EXTRACT, N_ONE = 20, 10                  # ragged tails at batch 8 and batch 4
NEW_TOKENS = 6


def _tree(seed: int, with_visual: bool) -> dict:
    """tdax's tiny f32 init as numpy, every bias and norm moved off its
    init value by N(0, 0.1)."""
    tree = jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(seed), JCFG,
                                                  with_visual=with_visual))
    rng = np.random.default_rng(seed + 10)

    def move(path, leaf):
        name = path[-1].key
        if name.endswith("_b") or name.startswith("ln_"):
            return leaf + rng.normal(0, 0.1, leaf.shape).astype(np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(move, tree)


def _inputs() -> dict:
    """The dry run's stage-1 capture inputs (b = 4, t = 64) and its
    stage-6 prompts (b = 4, t = 16), from numpy seed 0."""
    rng = np.random.default_rng(0)
    b, t, nq, s = 4, 64, CFG.visual.n_queries, CFG.visual.image_size
    capture = {"ids": rng.integers(1, CFG.vocab_size, (b, t)).astype(np.int32),
               "mask": np.ones((b, t), np.int32), "last": np.full(b, t - 1, np.int32),
               "images": rng.normal(size=(b, 3, s, s)).astype(np.float32),
               "img_pos": np.tile(np.arange(2, 2 + nq, dtype=np.int32), (b, 1))}
    gen = {"ids": rng.integers(1, CFG.vocab_size, (b, 16)).astype(np.int32),
           "mask": np.ones((b, 16), np.int32), "new": NEW_TOKENS}
    return {"capture": capture, "gen": gen}


def _tdax(inp: dict, params: dict, params_g: dict, metadata: list, work) -> dict:
    """tdax's single-device and sharded results on the 8 virtual devices."""
    c = {k: jnp.asarray(v) for k, v in inp["capture"].items()}
    args = (c["ids"], c["mask"], c["last"], c["images"], c["img_pos"])
    jp = jax.tree.map(jnp.asarray, params)
    out = {"single": np.asarray(j_capture(jp, JCFG, *args))}

    def sharded(dp, tp, **ctx):
        mesh = j_make_mesh(dp=dp, tp=tp)
        bs = j_batch_sharding(mesh)
        p = j_shard_params(jp, mesh, j_rules(with_visual=True))
        run = jax.jit(lambda p, *a: j_capture(p, JCFG, *a))
        if not ctx:
            return np.asarray(run(p, *(jax.device_put(a, bs) for a in args)))
        os.environ["TDAX_FLASH_INTERPRET"] = "1"
        try:
            with j_flash_sharding(mesh, **ctx):
                return np.asarray(run(p, *(jax.device_put(a, bs) for a in args)))
        finally:
            del os.environ["TDAX_FLASH_INTERPRET"]

    out["dp2_tp4"] = sharded(2, 4)
    out["dp4_tp2_flash"] = sharded(4, 2, batch_axis="dp", head_axis="tp")

    g = inp["gen"]
    ids, mask = jnp.asarray(g["ids"]), jnp.asarray(g["mask"])
    jg = jax.tree.map(jnp.asarray, params_g)
    out["tokens"] = np.asarray(j_generate(jg, JCFG, ids, mask, max_new_tokens=NEW_TOKENS))
    mesh = j_make_mesh(dp=2, tp=4)
    bs = j_batch_sharding(mesh)
    jg_s = j_shard_params(jg, mesh, j_rules(with_visual=False))
    out["tokens_dp2_tp4"] = np.asarray(j_generate(jg_s, JCFG, jax.device_put(ids, bs),
                                                  jax.device_put(mask, bs),
                                                  max_new_tokens=NEW_TOKENS))
    lengths = jnp.full((ids.shape[0],), ids.shape[1], jnp.int32)
    t_max = ids.shape[1] + 1
    _, ks, vs = j_prefill(jg, JCFG, ids, mask, t_max=t_max, kv_int8=True)
    out["int8_logits"] = np.asarray(j_decode_step(jg, JCFG, ids[:, -1], lengths, ks, vs)[0])
    _, ks, vs = jax.jit(lambda p, i, m: j_prefill(p, JCFG, i, m, t_max=t_max, kv_int8=True))(
        jg_s, jax.device_put(ids, bs), jax.device_put(mask, bs))
    out["int8_logits_dp2_tp4"] = np.asarray(jax.jit(
        lambda p, t, l, ks, vs: j_decode_step(p, JCFG, t, l, ks, vs)[0])(
        jg_s, jax.device_put(ids[:, -1], bs), jax.device_put(lengths, bs), ks, vs))

    res = j_extract_activations(metadata, str(work / "tdax.pt"), JCFG,
                                JExtractConfig(model_dir=None, batch_size=8, save_interval=8),
                                params=jp, verbose=False)
    out["extract"] = np.stack([[res[m["id"]]["activations"][f"layer_{i}"] for m in metadata]
                               for i in range(JCFG.num_layers)])
    return out


def _compute(work) -> dict:
    params, params_g = _tree(0, True), _tree(3, False)
    metadata = j_generate_dataset(JDatasetConfig(data_dir=str(work / "data")))
    inp = {**_inputs(), "params": params, "params_g": params_g}
    serve_in, one_in = work / "serve_in.pkl", work / "one_in.pkl"
    with open(serve_in, "wb") as f:
        pickle.dump({**inp, "metadata": metadata[:N_EXTRACT]}, f)
    with open(one_in, "wb") as f:
        pickle.dump({**inp, "metadata": metadata[:N_ONE]}, f)
    for name in ("serve", "one"):
        (work / name).mkdir()
    serve = worlds.run_world(worlds.serve_world, 8, work / "serve", str(serve_in),
                             str(work / "serve"))
    one = worlds.run_world(worlds.one_world, 1, work / "one", str(one_in), str(work / "one"))[0]
    tp = params_from_numpy(params, "cpu", "float32")
    with torch.inference_mode():
        port_single = extract_layer_activations(
            tp, CFG, *worlds._capture_inputs(inp)).numpy()
    return {"tdax": _tdax(inp, params, params_g, metadata[:N_EXTRACT], work),
            "serve": serve, "one": one, "port_single": port_single}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return worlds.once(tmp_path_factory, "torch_parallel_serve", _compute)


def _report(label, got, want):
    err = np.abs(got - want)
    print(f"{label}: max abs err {err.max():.3e}, max rel err "
          f"{(err / np.maximum(np.abs(want), 1e-30)).max():.3e}")


# ---- the mesh and the rules ----------------------------------------------

@pytest.mark.parametrize("case,want", [
    ("dp2_tp4", {"dp": 2, "tp": 4}), ("tp2", {"dp": 4, "tp": 2}), ("default", {"dp": 8, "tp": 1})])
def test_make_mesh_shapes(results, case, want):
    for rank, out in enumerate(results["serve"]):
        got = out["meshes"][case]
        assert got["shape"] == want
        assert (got["dp_rank"], got["tp_rank"]) == divmod(rank, want["tp"])  # tp innermost


@pytest.mark.parametrize("case,want", [("value_error", "ValueError: dp*tp*cp = 3*2*1 != 8")])
def test_make_mesh_errors(results, case, want):
    assert all(out["meshes"][case].startswith(want) for out in results["serve"])


def test_make_mesh_cp_innermost(results):
    """make_mesh(dp=2, tp=2, cp=2): tdax's ("dp", "tp", "cp") with cp
    innermost, rank (d * tp + t) * cp + c, and the (dp, cp) group of the
    rank's tp index in (dp, cp) order."""
    for rank, out in enumerate(results["serve"]):
        got = out["meshes"]["cp"]
        assert got["axis_names"] == ("dp", "tp", "cp")
        assert got["shape"] == {"dp": 2, "tp": 2, "cp": 2}
        d, t, c = got["ranks"]
        assert (d * 2 + t) * 2 + c == rank
        assert got["dp_cp_group"] == [(dd * 2 + t) * 2 + cc for dd in range(2) for cc in range(2)]


def _leaves(tree, path=()):
    for key, leaf in tree.items():
        if isinstance(leaf, dict):
            yield from _leaves(leaf, path + (key,))
        else:
            yield path + (key,), leaf


@pytest.mark.parametrize("with_visual", [True, False])
def test_param_sharding_rules_match_tdax(with_visual):
    want = dict(_leaves(j_rules(with_visual)))
    got = dict(_leaves(pm.param_sharding_rules(with_visual)))
    assert list(got) == list(want)
    for path, spec in want.items():
        assert tuple(got[path]) == tuple(spec), path


def test_parallel_exports_tdax_names():
    import tdax.parallel as jpar
    import tdax_torch.parallel as par
    for name in ("make_mesh", "param_sharding_rules", "shard_params", "fsdp_sharding_rules",
                 "named_shardings", "make_hybrid_mesh", "hybrid_batch_sharding"):
        assert name in jpar.__all__ and name in par.__all__
        assert getattr(par, name) is getattr(pm, name)
    from tdax_torch.parallel import pipeline
    assert "make_pp_mesh" in par.__all__ and par.make_pp_mesh is pipeline.make_pp_mesh
    with pytest.raises(AttributeError):
        par.nope  # a name tdax does not export


class _Grid:
    """shard_params' view of a mesh: the tp size and this rank's index."""

    def __init__(self, tp: int, rank: int):
        self.shape, self.rank = {"dp": 1, "tp": tp}, rank

    def local_rank(self, axis):
        return self.rank if axis == "tp" else 0


def _reassemble(parts: list, path: tuple, dim: int) -> torch.Tensor:
    """The tp ranks' slices of a leaf back in the rules' layout: a fused
    qkv leaf per third (each rank holds its heads of q, of k and of v)."""
    if path in pm._FUSED_QKV:
        thirds = [p.chunk(3, dim=dim) for p in parts]
        return torch.cat([torch.cat([t[i] for t in thirds], dim=dim) for i in range(3)], dim=dim)
    return torch.cat(parts, dim=dim)


@pytest.mark.parametrize("tp", [2, 4])
def test_shard_params_reassembles_tdax_leaves(tp):
    tree = _tree(0, True)
    full = params_from_numpy(tree, "cpu", "float32")
    locals_ = [pm.shard_params(full, _Grid(tp, r), cfg=CFG) for r in range(tp)]
    specs = dict(_leaves(pm.param_sharding_rules(True)))
    replicated_sites = []
    for path, leaf in _leaves(full):
        parts = [dict(_leaves(loc))[path] for loc in locals_]
        spec = specs[path]
        if "tp" not in spec:
            assert all(p is leaf for p in parts), path
            continue
        dim = spec.index("tp")
        if parts[0].shape == leaf.shape:  # a site whose heads tp does not divide
            replicated_sites.append(path)
            assert all(torch.equal(p, leaf) for p in parts), path
            continue
        assert parts[0].shape[dim] * tp == leaf.shape[dim], path
        np.testing.assert_array_equal(_reassemble(parts, path, dim).numpy(),
                                      dict(_leaves(tree))[path], err_msg=str(path))
    # the tiny ViT has 2 heads: its attention runs replicated at tp = 4 only
    vit_attn = [("visual", "blocks", k) for k in ("attn_qkv_w", "attn_qkv_b", "attn_proj_w")]
    assert sorted(replicated_sites) == sorted(vit_attn if tp == 4 else [])


def test_shard_params_qkv_split_by_heads():
    """Rank r's q, k and v columns are heads r*nh/tp .. of each third."""
    full = params_from_numpy(_tree(0, True), "cpu", "float32")
    w = full["layers"]["attn_qkv_w"]
    h = CFG.hidden_size
    local = pm.shard_params(full, _Grid(2, 1), cfg=CFG)["layers"]["attn_qkv_w"]
    half = h // 2
    for third in range(3):
        torch.testing.assert_close(local[..., third * half:(third + 1) * half],
                                   w[..., third * h + half:(third + 1) * h], rtol=0, atol=0)


def test_shard_params_refuses_int8_under_tp():
    full = params_from_numpy(_tree(0, False), "cpu", "float32")
    full["layers"]["mlp_w1"] = quantize_weight(full["layers"]["mlp_w1"])
    with pytest.raises(NotImplementedError, match="int8"):
        pm.shard_params(full, _Grid(2, 0), cfg=CFG)


def test_sharded_weights_need_the_tp_context():
    """A tp-sharded tree outside flash_sharding(head_axis=...) raises, and
    so do int8 weights under tp, in training too (tp training itself runs:
    tests/test_torch_parallel_train.py)."""
    local = pm.shard_params(params_from_numpy(_tree(0, False), "cpu", "float32"),
                            _Grid(2, 0), cfg=CFG)
    ids = torch.randint(1, CFG.vocab_size, (1, 8))
    with torch.inference_mode(), pytest.raises(RuntimeError, match="flash_sharding"):
        forward(local, CFG, ids)
    local["layers"]["attn_qkv_w"].requires_grad_()
    local["layers"]["attn_proj_w"] = quantize_weight(local["layers"]["attn_proj_w"])
    with fa.flash_sharding(_Grid(2, 0), "dp", "tp"), \
            pytest.raises(NotImplementedError, match="int8 weights under tp"):
        forward(local, CFG, ids)


def test_flash_sharding_seq_axis_is_accepted_and_scoped():
    """Context parallelism: flash_sharding(seq_axis=) is pushed and popped
    like the other axes, and without_seq_axis drops it for the calls
    inside (the visual tower's attention)."""
    with fa.flash_sharding("mesh", batch_axis="dp", head_axis="tp", seq_axis="cp"):
        assert fa.current_flash_sharding() == ("mesh", "dp", "tp", "cp")
        with fa.without_seq_axis():
            assert fa.current_flash_sharding() == ("mesh", "dp", "tp", None)
        assert fa.current_flash_sharding() == ("mesh", "dp", "tp", "cp")
    assert fa.current_flash_sharding() is None


@pytest.mark.parametrize("call,exc,match", [
    (lambda: pm.make_mesh(), RuntimeError, "init_distributed"),
    (lambda: pm.init_distributed("cpu"), RuntimeError, "torchrun"),
    (lambda: pm.init_distributed("cpu", rank=0), ValueError, "store_path")])
def test_process_group_errors(monkeypatch, call, exc, match):
    for name in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(exc, match=match):
        call()


# ---- stage 1 and stage 7: the capture -----------------------------------

@pytest.mark.parametrize("ref", ["single", "dp2_tp4"])
def test_stage1_capture_dp2_tp4_matches_tdax(results, ref):
    got = results["serve"][0]["stage1"]["acts"]
    want = results["tdax"][ref]
    assert got.shape == (CFG.num_layers, 4, CFG.hidden_size) and np.isfinite(got).all()
    _report(f"stage 1 vs tdax {ref}", got, want)
    np.testing.assert_allclose(got, want, **MESH_TOL)


@pytest.mark.parametrize("ref", ["dp4_tp2_flash", "single"])
def test_stage7_flash_per_shard_matches_tdax(results, ref):
    got = results["serve"][0]["stage7"]["acts"]
    want = results["tdax"][ref]
    _report(f"stage 7 vs tdax {ref}", got, want)
    np.testing.assert_allclose(got, want, **MESH_TOL)


@pytest.mark.parametrize("stage", ["stage1", "stage7"])
def test_sharded_capture_matches_port_single_device(results, stage):
    np.testing.assert_allclose(results["serve"][0][stage]["acts"], results["port_single"],
                               **CAPTURE_TOL)


@pytest.mark.parametrize("stage,tp,heads", [
    # ViT blocks (2 heads), the resampler (4), the decoder layers (4)
    ("stage1", 4, [2, 2, 1, 1, 1, 1, 1]),   # ViT replicated: 2 heads do not divide over 4
    ("stage7", 2, [1, 1, 2, 2, 2, 2, 2])])
def test_attention_runs_per_shard(results, stage, tp, heads):
    for out in results["serve"]:
        rec = out[stage]
        assert [h for _, h in rec["heads"]] == heads
        assert rec["local_rows"] == 4 // (8 // tp)
        np.testing.assert_array_equal(rec["acts"], results["serve"][0][stage]["acts"])


# ---- stage 6: generation ------------------------------------------------

@pytest.mark.parametrize("ref", ["tokens", "tokens_dp2_tp4"])
def test_stage6_greedy_tokens_equal_tdax(results, ref):
    got = results["serve"][0]["stage6"]["tokens"]
    assert got.shape == (4, NEW_TOKENS)
    np.testing.assert_array_equal(got, results["tdax"][ref])


@pytest.mark.parametrize("ref", ["int8_logits", "int8_logits_dp2_tp4"])
def test_stage6_int8_cache_decode_logits(results, ref):
    got = results["serve"][0]["stage6"]["int8_logits"]
    assert got.shape == (4, CFG.vocab_size)
    _report(f"stage 6 int8-cache logits vs tdax {ref}", got, results["tdax"][ref])
    np.testing.assert_allclose(got, results["tdax"][ref], **MESH_TOL)


def test_stage6_caches_hold_local_heads(results):
    for out in results["serve"]:
        g = out["stage6"]
        assert g["cache_shape"] == (CFG.num_layers, 2, 17, CFG.num_heads // 4, CFG.head_dim)
        assert g["scale_shape"] == g["cache_shape"][:-1]


def test_stage6_sampled_token_agrees_across_tp(results):
    """Each rank samples with its own generator; the tp group's first
    rank's draw is broadcast, so a tp group feeds one token."""
    by_dp = {}
    for out in results["serve"]:
        g = out["stage6"]
        by_dp.setdefault(g["dp_rank"], []).append(g["sampled_local"])
    assert len(by_dp) == 2
    for group in by_dp.values():
        assert len(group) == 4 and all(np.array_equal(s, group[0]) for s in group)
    assert results["serve"][0]["collectives"]["gloo.broadcast"] > 0


# ---- stage 5: dp extraction with crash and resume ------------------------

def test_stage5_resume_equals_uninterrupted(results):
    ext = results["serve"][0]["stage5"]
    assert ext["full"].shape == (CFG.num_layers, N_EXTRACT, CFG.hidden_size)
    np.testing.assert_allclose(ext["resumed"], ext["full"], **RESUME_TOL)
    print("stage 5 resumed bitwise equal:", np.array_equal(ext["resumed"], ext["full"]))
    assert not ext["tmp_left"]
    assert ext["files"] == ["full.npz", "full.pt", "res.npz", "res.pt"]


def test_stage5_extraction_matches_tdax(results):
    got = results["serve"][0]["stage5"]["full"]
    _report("stage 5 vs tdax", got, results["tdax"]["extract"])
    np.testing.assert_allclose(got, results["tdax"]["extract"], **CAPTURE_TOL)


def test_every_rank_returns_the_whole_result(results):
    for out in results["serve"][1:]:
        for stage in ("full", "resumed"):
            np.testing.assert_array_equal(out["stage5"][stage],
                                          results["serve"][0]["stage5"][stage])
        np.testing.assert_array_equal(out["stage6"]["tokens"],
                                      results["serve"][0]["stage6"]["tokens"])


# ---- the world of one ---------------------------------------------------

@pytest.mark.parametrize("single,grouped", [("single", "grouped"),
                                            ("single_extract", "grouped_extract")])
def test_world_of_one_is_bitwise_single_device(results, single, grouped):
    one = results["one"]
    assert one[single].shape[:2] == (CFG.num_layers, 4 if single == "single" else N_ONE)
    np.testing.assert_array_equal(one[grouped], one[single])


def test_world_of_one_gathers_through_the_group(results):
    # the capture's gather and one per extraction batch (10 rows at batch 4)
    assert results["one"]["collectives"] == {"gloo.all_gather": 1 + 3}
