"""The rank side of tests/test_torch_parallel_serve.py: gloo worlds of CPU
processes running the port's multi-device serving.

Every rank imports this module (spawned processes import the function
they run by name), so it imports the port and never ``jax`` or
``tdax``.  ``run_world`` starts the ranks with
``torch.multiprocessing.start_processes(start_method="spawn")``, each
joining the process group through a ``FileStore`` in the world's
directory with one torch thread, and returns each rank's result; a
rank's exception fails the call, and so does the world outliving its
timeout.  ``once`` runs a computation once per test session and shares
its result between pytest-xdist's workers.
"""

from __future__ import annotations

import fcntl
import os
import pickle
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from tdax_torch.config import ExtractConfig
from tdax_torch.models.qwen_vl.config import QwenVLConfig
from tdax_torch.models.qwen_vl.convert import params_from_numpy
from tdax_torch.models.qwen_vl.generate import _decode_step, generate, prefill
from tdax_torch.models.qwen_vl.model import extract_layer_activations
from tdax_torch.ops import flash_attention as fa
from tdax_torch.ops.flash_attention import flash_sharding
from tdax_torch.parallel import mesh as pm
from tdax_torch.pipeline.extract import extract_activations

CFG = QwenVLConfig.tiny(dtype="float32")


def once(tmp_path_factory, name: str, compute):
    """``compute(directory)``'s result, computed by the first pytest worker
    that asks and read back by the others (a lock file in the session's
    shared temporary root); a failure is recorded and raised in each."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    result_path = root / f"{name}.pkl"
    with open(root / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not result_path.exists():
            work = root / name
            work.mkdir(exist_ok=True)
            try:
                result = {"ok": compute(work)}
            except Exception:
                result = {"error": traceback.format_exc()}
            with open(result_path, "wb") as f:
                pickle.dump(result, f)
        with open(result_path, "rb") as f:
            result = pickle.load(f)
    if "error" in result:
        raise RuntimeError(f"{name} failed:\n{result['error']}")
    return result["ok"]


def _entry(rank: int, fn, world: int, work: str, args: tuple) -> None:
    torch.set_num_threads(1)
    out = fn(rank, world, str(Path(work) / "store"), *args)
    torch.save(out, Path(work) / f"rank{rank}.pt")


def run_world(fn, world: int, work: Path, *args, timeout_s: float = 300.0) -> list:
    """``fn(rank, world, store_path, *args)`` on ``world`` spawned
    processes; returns their results in rank order."""
    ctx = torch.multiprocessing.start_processes(
        _entry, args=(fn, world, str(work), args), nprocs=world, join=False,
        start_method="spawn")
    deadline = time.monotonic() + timeout_s
    while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            raise TimeoutError(f"world of {world} ranks still running after {timeout_s} s")
    return [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _join(rank: int, world: int, store_path: str) -> None:
    pm.init_distributed("cpu", rank=rank, world_size=world, store_path=store_path)


def _t(a: np.ndarray, long: bool = False) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.long() if long else t


def _capture_inputs(inp: dict) -> tuple:
    c = inp["capture"]
    return (_t(c["ids"], True), _t(c["mask"]), _t(c["last"], True), _t(c["images"]),
            _t(c["img_pos"], True))


class _Heads:
    """The head counts of the attention calls made while it is active:
    ``flash_attention_plain`` (what ``mha`` runs on CPU tensors) wrapped
    to note each call's (query rows, heads)."""

    def __enter__(self):
        self.calls, self.orig = [], fa.flash_attention_plain

        def noted(q, *args, **kw):
            self.calls.append((q.shape[1], q.shape[2]))
            return self.orig(q, *args, **kw)

        fa.flash_attention_plain = noted
        return self

    def __exit__(self, *exc):
        fa.flash_attention_plain = self.orig


def _sharded_capture(params, inputs, dp: int, tp: int) -> dict:
    """extract_layer_activations at dp x tp: each rank its dp rows and tp
    shard; the capture gathered back over dp."""
    mesh = pm.make_mesh(dp=dp, tp=tp)
    local = pm.shard_params(params, mesh, cfg=CFG)
    rows = [pm.split_batch(x, mesh) for x in inputs]
    with torch.inference_mode(), flash_sharding(mesh, "dp", "tp"), _Heads() as heads:
        acts = extract_layer_activations(local, CFG, *rows)
    return {"acts": pm.gather_batch(acts, mesh, dim=1).numpy(), "heads": heads.calls,
            "local_rows": rows[0].shape[0]}


def _meshes() -> dict:
    """make_mesh's shapes and this rank's place in each, and its errors."""
    out = {}
    for label, kw in (("dp2_tp4", dict(dp=2, tp=4)), ("tp2", dict(tp=2)), ("default", {})):
        mesh = pm.make_mesh(**kw)
        out[label] = {"shape": mesh.shape, "dp_rank": mesh.local_rank("dp"),
                      "tp_rank": mesh.local_rank("tp")}
    try:
        pm.make_mesh(dp=3, tp=2)
        out["value_error"] = "no error"
    except ValueError as e:
        out["value_error"] = f"{type(e).__name__}: {e}"
    mesh = pm.make_mesh(dp=2, tp=2, cp=2)
    group = mesh.group(("dp", "cp"))
    out["cp"] = {"axis_names": mesh.axis_names, "shape": mesh.shape,
                 "ranks": tuple(mesh.local_rank(a) for a in ("dp", "tp", "cp")),
                 "dp_cp_group": [dist.get_global_rank(group, i) for i in range(group.size())]}
    return out


def _generation(params_g, gen: dict, dp: int, tp: int, rank: int) -> dict:
    """dp x tp generate (greedy, and sampled with a per-rank generator),
    and the int8-cache prefill + one decode step's logits, gathered."""
    mesh = pm.make_mesh(dp=dp, tp=tp)
    local = pm.shard_params(params_g, mesh, cfg=CFG)
    ids, mask = (pm.split_batch(_t(gen["ids"], True), mesh), pm.split_batch(_t(gen["mask"]), mesh))
    with torch.inference_mode(), flash_sharding(mesh, "dp", "tp"):
        toks = generate(local, CFG, ids, mask, max_new_tokens=gen["new"])
        sampled = generate(local, CFG, ids, mask, max_new_tokens=gen["new"], temperature=1.0,
                           generator=torch.Generator().manual_seed(100 + rank))
        t_max = ids.shape[1] + 1
        _, ks, vs = prefill(local, CFG, ids, mask, t_max=t_max, kv_int8=True)
        lengths = torch.full((ids.shape[0],), ids.shape[1], dtype=torch.long)
        logits, _, _ = _decode_step(local, CFG, ids[:, -1], lengths, ks, vs)
    return {"tokens": pm.gather_batch(toks, mesh).numpy(),
            "sampled_local": sampled.numpy(), "tp_rank": mesh.local_rank("tp"),
            "dp_rank": mesh.local_rank("dp"), "cache_shape": tuple(ks["q"].shape),
            "scale_shape": tuple(ks["s"].shape),
            "int8_logits": pm.gather_batch(logits, mesh).numpy()}


def _extraction(params, metadata: list, work: Path, bs: int) -> dict:
    """dp=world extraction uninterrupted, and crashed after its first
    checkpoint then resumed (tdax's stage 5), at batch ``bs``."""
    ecfg = ExtractConfig(model_dir=None, batch_size=bs, save_interval=bs)

    def run(meta, name):
        with torch.inference_mode():
            res = extract_activations(meta, str(work / name), CFG, ecfg, params=params,
                                      device="cpu", verbose=False)
        return np.stack([res[m["id"]]["activations"][f"layer_{i}"]
                         for i in range(CFG.num_layers) for m in meta]
                        ).reshape(CFG.num_layers, len(meta), -1)

    full = run(metadata, "full.pt")
    run(metadata[:bs], "res.pt")
    if dist.get_rank() == 0:  # the crash: only the checkpoint remains
        os.replace(work / "res.npz", work / "res.pt.tmp.npz")
        os.remove(work / "res.pt")
    dist.barrier()
    resumed = run(metadata, "res.pt")
    dist.barrier()
    return {"full": full, "resumed": resumed,
            "tmp_left": (work / "res.pt.tmp.npz").exists(),
            "files": sorted(p.name for p in work.iterdir() if p.suffix in (".pt", ".npz"))}


def serve_world(rank: int, world: int, store_path: str, inp_path: str, work: str) -> dict:
    """The 8-rank world: meshes, stage 1 (dp=2 tp=4 capture), stage 7
    (dp=4 tp=2, the plain flash per shard), stage 6 (dp=2 tp=4
    generation), stage 5 (dp=8 extraction with crash and resume)."""
    _join(rank, world, store_path)
    try:
        with open(inp_path, "rb") as f:
            inp = pickle.load(f)
        params = params_from_numpy(inp["params"], "cpu", "float32")
        params_g = params_from_numpy(inp["params_g"], "cpu", "float32")
        inputs = _capture_inputs(inp)
        work = Path(work) / "extract"
        if rank == 0:
            work.mkdir()
        dist.barrier()
        return {"meshes": _meshes(),
                "stage1": _sharded_capture(params, inputs, dp=2, tp=4),
                "stage7": _sharded_capture(params, inputs, dp=4, tp=2),
                "stage6": _generation(params_g, inp["gen"], dp=2, tp=4, rank=rank),
                "stage5": _extraction(params, inp["metadata"], work, bs=world),
                "collectives": dict(pm.COLLECTIVES)}
    finally:
        pm.shutdown()


def one_world(rank: int, world: int, store_path: str, inp_path: str, work: str) -> dict:
    """The world of one: the capture and the extraction without a process
    group, then the same inside one (dp=1, tp=1), in the same process."""
    with open(inp_path, "rb") as f:
        inp = pickle.load(f)
    params = params_from_numpy(inp["params"], "cpu", "float32")
    inputs = _capture_inputs(inp)
    work = Path(work)
    ecfg = ExtractConfig(model_dir=None, batch_size=4, save_interval=4)

    def extraction(name):
        with torch.inference_mode():
            res = extract_activations(inp["metadata"], str(work / name), CFG, ecfg,
                                      params=params, device="cpu", verbose=False)
        return np.stack([[res[m["id"]]["activations"][f"layer_{i}"] for m in inp["metadata"]]
                         for i in range(CFG.num_layers)])

    with torch.inference_mode():
        single = extract_layer_activations(params, CFG, *inputs).numpy()
    single_extract = extraction("single.pt")
    _join(rank, world, store_path)
    try:
        grouped = _sharded_capture(params, inputs, dp=1, tp=1)["acts"]
        grouped_extract = extraction("grouped.pt")
        return {"single": single, "grouped": grouped, "single_extract": single_extract,
                "grouped_extract": grouped_extract, "collectives": dict(pm.COLLECTIVES)}
    finally:
        pm.shutdown()


# ---- the sweep and scale stages (tests/test_torch_parallel_scale.py) -------

def _dgms(out: dict) -> list:
    return [np.asarray(g) for g in out["dgms"]]


def _stage3(inp: dict, mesh) -> dict:
    """tdax's dry-run stage 3 on the mesh: kNN both metrics, the local
    squared-distance block, rips_at_scale and the sparse extraction."""
    from tdax_torch.parallel.sharded_ops import sharded_knn, sharded_pairwise_sq_euclidean
    from tdax_torch.pipeline.scale import rips_at_scale, rips_at_scale_sparse
    x = _t(inp["x"])
    out = {f"knn_{m}": sharded_knn(x, inp["k"], mesh, metric=m) for m in ("euclidean", "cosine")}
    out["sq_block"] = sharded_pairwise_sq_euclidean(x, mesh).numpy()
    out["rips"] = _dgms(rips_at_scale(x, maxdim=1, mesh=mesh))
    sp = rips_at_scale_sparse(x, maxdim=1, target_degree=12, fused_max=0,
                              block_rows=x.shape[0], mesh=mesh)
    out["sparse"] = {"n_edges": sp["n_edges"], "dgms": _dgms(sp)}
    return out


def _edges(inp: dict, mesh) -> dict:
    """sharded_edge_extract on a cloud the axis pads, at each threshold."""
    from tdax_torch.parallel.sharded_ops import sharded_edge_extract
    x = _t(inp["x_pad"])
    return {name: sharded_edge_extract(x, t, inp["budget"], mesh, chunk=inp["chunk"])
            for name, t in inp["thresholds"].items()}


class _Init:
    """tdax's spectral inits in place of the port's while active: the
    stack's per-layer inits (this rank's share of them) and the shared
    fit's (tests/test_torch_sweep.py injects them so in one process)."""

    def __init__(self, per_layer: np.ndarray, shared: np.ndarray, r0: int):
        self.per_layer, self.shared, self.r0 = per_layer, shared, r0

    def __enter__(self):
        import tdax_torch.ops.umap.umap as tu
        self.tu, self.orig = tu, tu.spectral_init

        def fake(w, n_components, random_state):
            if w.dim() == 2:
                return _t(self.shared)
            return _t(self.per_layer[self.r0:self.r0 + w.shape[0]])

        tu.spectral_init = fake
        return self

    def __exit__(self, *exc):
        self.tu.spectral_init = self.orig


def _stage2(inp: dict, rank: int) -> dict:
    """tdax's dry-run stage 2: both batched UMAP modes over the layer axis,
    from the port's init and from tdax's, and a stack the world does not
    divide."""
    from tdax_torch.config import UMAPConfig
    from tdax_torch.ops.umap.umap import fit_transform_batched, shared_transform_batched
    ucfg = UMAPConfig(**inp["umap"])
    clouds = inp["clouds"]
    out = {}
    for name, fn in (("fit", fit_transform_batched), ("shared", shared_transform_batched)):
        out[name] = fn(clouds, ucfg, device="cpu")
        per = len(clouds) // dist.get_world_size()
        with _Init(inp["tdax_init"], inp["tdax_init_shared"], rank * per):
            out[f"{name}_tdax_init"] = fn(clouds, ucfg, device="cpu")
    before = dict(pm.COLLECTIVES)
    out["undivided"] = fit_transform_batched(inp["undivided"], ucfg, device="cpu")
    out["undivided_gathers"] = pm.COLLECTIVES.get("gloo.all_gather", 0) - before.get(
        "gloo.all_gather", 0)
    return out


def scale_world(rank: int, world: int, store_path: str, inp_path: str) -> dict:
    """The 8-rank world: stage 3 at dp=2 tp=4, the edge extraction
    padded at dp=8, stage 2 one layer a rank."""
    _join(rank, world, store_path)
    try:
        with open(inp_path, "rb") as f:
            inp = pickle.load(f)
        mesh = pm.make_mesh(dp=2, tp=4)
        return {"dp_rank": mesh.local_rank("dp"), "stage3": _stage3(inp, mesh),
                "edges": _edges(inp, pm.make_mesh(dp=8)), "stage2": _stage2(inp, rank),
                "collectives": dict(pm.COLLECTIVES)}
    finally:
        pm.shutdown()


class _Writes:
    """The file writes of run_tda_sweep's module while active: each call
    of its wipe, directory, .npy and JSON writers, noted by name."""

    def __enter__(self):
        import tdax_torch.pipeline.tda_sweep as ts
        self.ts, self.calls = ts, []
        self.orig = {name: getattr(ts, name) for name in ("dump_json", "ensure_dir")}
        self.orig_np, self.orig_rm = ts.np.save, ts.shutil.rmtree
        for name, fn in self.orig.items():
            setattr(ts, name, self._noted(name, fn))
        ts.np.save = self._noted("np.save", self.orig_np)
        ts.shutil.rmtree = self._noted("rmtree", self.orig_rm)
        return self

    def _noted(self, name, fn):
        def noted(*args, **kw):
            self.calls.append(name)
            return fn(*args, **kw)
        return noted

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.ts, name, fn)
        self.ts.np.save, self.ts.shutil.rmtree = self.orig_np, self.orig_rm


def _sweep(inp: dict, out_dir: str) -> dict:
    from tdax_torch.config import SweepConfig, UMAPConfig
    from tdax_torch.data.io import load_activations
    from tdax_torch.pipeline import run_tda_sweep
    cfg = SweepConfig(n_layers=inp["n_layers"], output_dir=out_dir,
                      umap=UMAPConfig(n_epochs=inp["n_epochs"]), save_diagrams=False)
    with _Writes() as writes:
        res = run_tda_sweep(load_activations(inp["npz"]), inp["metadata_path"], cfg,
                            verbose=True, device="cpu")
    return {"stats": res["stats"], "peak_layer": res["peak_layer"],
            "clouds_3d": res["clouds_3d"], "writes": writes.calls}


def sweep_world(rank: int, world: int, store_path: str, inp_path: str, out_dir: str) -> dict:
    """The 4-rank world: run_tda_sweep of the tiny capture, each rank its
    layers, into one output directory."""
    _join(rank, world, store_path)
    try:
        with open(inp_path, "rb") as f:
            inp = pickle.load(f)
        return {**_sweep(inp, out_dir), "collectives": dict(pm.COLLECTIVES)}
    finally:
        pm.shutdown()


def one_scale_world(rank: int, world: int, store_path: str, inp_path: str,
                    work: str) -> dict:
    """The world of one: the sweep, both UMAP modes, the dense matrix and
    the sparse extraction without a process group, then in one."""
    from tdax_torch.config import UMAPConfig
    from tdax_torch.ops.umap.umap import fit_transform_batched, shared_transform_batched
    from tdax_torch.pipeline.scale import (_expansion_rows, distance_matrix,
                                           rips_at_scale_sparse)
    with open(inp_path, "rb") as f:
        inp = pickle.load(f)
    x = _t(inp["x"])
    ucfg = UMAPConfig(**inp["umap"])

    def run(mesh):
        sp = rips_at_scale_sparse(x, maxdim=1, target_degree=12, fused_max=0,
                                  block_rows=x.shape[0], mesh=mesh, device="cpu")
        return {"sweep": _sweep(inp, str(Path(work) / ("grouped" if mesh else "single"))),
                "fit": fit_transform_batched(inp["clouds"], ucfg, device="cpu"),
                "shared": shared_transform_batched(inp["clouds"], ucfg, device="cpu"),
                "sparse": {"n_edges": sp["n_edges"], "dgms": _dgms(sp)}}

    single = run(None)
    sq = (x * x).sum(1)
    d = _expansion_rows(x, x, sq, sq)
    single["dense"] = ((d + d.T) * 0.5).numpy()
    _join(rank, world, store_path)
    try:
        mesh = pm.make_mesh()
        grouped = run(mesh)
        grouped["dense"] = distance_matrix(x, mesh=mesh).numpy()
        return {"single": single, "grouped": grouped, "collectives": dict(pm.COLLECTIVES)}
    finally:
        pm.shutdown()


# ---- the edge-list UMAP's mesh variants (tests/test_torch_parallel_umap.py) -----------

def _draws(arrays: list):
    return lambda epoch: arrays[epoch]


def umap_calls(inp: dict, mesh) -> dict:
    """Every mesh variant of sparse_path on the test's inputs: the kNN
    (both metrics, both clouds, self and cross), the edge layout from the
    port's draws and from tdax's, the fixed-tail layout, embed_sparse and
    transform_sparse.  Every call is collective."""
    from tdax_torch.ops.umap import sparse_path as ts
    out = {}
    train = _t(inp["train"])
    for name, x in inp["clouds"].items():
        for metric in ("euclidean", "cosine"):
            out[f"knn_{name}_{metric}"] = [t.numpy() for t in ts.knn_blocked(
                _t(x), inp["k"], metric, mesh=mesh)]
            out[f"cross_{name}_{metric}"] = [t.numpy() for t in ts.knn_blocked_cross(
                _t(x), train, inp["k"], metric, mesh=mesh)]
    for name, lay in inp["layouts"].items():
        neg = _draws(lay["draws"]) if "draws" in lay else None
        out[f"layout_{name}"] = ts.optimize_layout_edges_sharded(
            _t(lay["init"]), _t(lay["head"], True), _t(lay["tail"], True), _t(lay["wgt"]),
            lay["n"], lay["epochs"], 2, *inp["ab"], mesh, _negatives=neg).numpy()
    for name, ft in inp["fixed_tail"].items():
        out[f"fixed_tail_{name}"] = ts.optimize_layout_edges_fixed_tail_sharded(
            _t(ft["init"]), _t(ft["train_emb"]), _t(ft["head"], True), _t(ft["tail"], True),
            _t(ft["wgt"]), ft["epochs"], 3, *inp["ab"], mesh, initial_alpha=0.25).numpy()
    e = inp["embed"]
    out["embed"] = ts.embed_sparse(e["x"], *e["args"], device="cpu", mesh=mesh)
    out["transform"] = ts.transform_sparse(e["x_new"], _t(e["x"]), e["train_emb"],
                                           *e["transform_args"], mesh=mesh)
    return out


def umap_world(rank: int, world: int, store_path: str, inp_path: str) -> dict:
    """A world of ``world`` ranks at dp=world: embed_sparse and
    transform_sparse on one device first (in this process, before the
    group), then every mesh variant."""
    from tdax_torch.ops.umap import sparse_path as ts
    with open(inp_path, "rb") as f:
        inp = pickle.load(f)
    e = inp["embed"]
    single = {"embed": ts.embed_sparse(e["x"], *e["args"], device="cpu"),
              "transform": ts.transform_sparse(e["x_new"], _t(e["x"]), e["train_emb"],
                                               *e["transform_args"])}
    _join(rank, world, store_path)
    try:
        return {**umap_calls(inp, pm.make_mesh(dp=world)), "single": single,
                "collectives": dict(pm.COLLECTIVES)}
    finally:
        pm.shutdown()


# ---- dp x tp training and sequence parallelism (tests/test_torch_parallel_train.py) ---

def _batch_rows(batch: dict, mesh, accum: int = 1) -> dict:
    """This rank's dp rows of a numpy batch as tensors; with ``accum`` the
    rows split into that many microbatches along a new leading axis."""
    out = {}
    for key, v in batch.items():
        t = pm.split_batch(_t(v, long=key in ("input_ids", "image_positions")), mesh)
        out[key] = t.reshape(accum, t.shape[0] // accum, *t.shape[1:]) if accum > 1 else t
    return out


def _trained(tree: dict, batch: dict, mesh, n_steps: int = 1, accum: int = 1,
             **step_kw) -> dict:
    """``n_steps`` steps of make_train_step over ``mesh`` from ``tree``
    (lr 1e-3), inside flash_sharding: each step's loss, the whole tree and
    AdamW's first moment after them, and the steps' collectives."""
    from tdax_torch.models.qwen_vl.convert import params_to_numpy
    from tdax_torch.parallel import train as tr
    params = pm.shard_params(params_from_numpy(tree, "cpu", "float32"), mesh, cfg=CFG)
    opt = tr.default_optimizer(1e-3)
    state = opt.init(params)
    step = tr.make_train_step(CFG, opt, accum_steps=accum, device="cpu", **step_kw)
    rows = _batch_rows(batch, mesh, accum)
    losses = []
    pm.COLLECTIVES.clear()
    with flash_sharding(mesh, "dp", "tp"):
        for _ in range(n_steps):
            _, state, loss = step(params, state, rows)
            losses.append(float(loss))
    counts = dict(pm.COLLECTIVES)
    return {"losses": losses, "collectives": counts,
            "params": params_to_numpy(pm.unshard_params(params, mesh, CFG)),
            "mu": params_to_numpy(pm.unshard_params(state.mu, mesh, CFG))}


def _lm_loss(tree: dict, batch: dict, mesh) -> float:
    from tdax_torch.parallel.train import lm_loss
    params = pm.shard_params(params_from_numpy(tree, "cpu", "float32"), mesh, cfg=CFG)
    rows = _batch_rows(batch, mesh)
    with torch.no_grad(), flash_sharding(mesh, "dp", "tp"):
        return float(lm_loss(params, CFG, rows["input_ids"], rows["attn_mask"]))


def _loop(tree: dict, batch: dict, mesh, work: Path) -> dict:
    """train_loop over the mesh, 4 steps with a checkpoint every 2:
    uninterrupted, and stopped after 2 then resumed from its checkpoint."""
    from tdax_torch.models.qwen_vl.convert import params_to_numpy
    from tdax_torch.parallel import train as tr
    from tdax_torch.utils.checkpoint import load_params
    rows = _batch_rows(batch, mesh)

    def run(name, n_steps):
        params = pm.shard_params(params_from_numpy(tree, "cpu", "float32"), mesh, cfg=CFG)
        with flash_sharding(mesh, "dp", "tp"):
            params, state, losses = tr.train_loop(
                params, CFG, lambda i: rows, n_steps, tr.default_optimizer(1e-3),
                checkpoint_path=str(work / name), checkpoint_every=2, log_every=0,
                device="cpu")
            whole = params_to_numpy(pm.unshard_params(params, mesh, CFG))
        return whole, losses, state.count

    full, full_losses, count = run("full", 4)
    run("crash", 2)
    resumed, resumed_losses, resumed_count = run("crash", 4)
    saved = load_params(str(work / "full"))["p"]  # the whole tree rank 0 wrote
    return {"full": full, "full_losses": full_losses, "count": count, "resumed": resumed,
            "resumed_losses": resumed_losses, "resumed_count": resumed_count,
            "saved_params": params_to_numpy(saved)}


def train_world(rank: int, world: int, store_path: str, inp_path: str, work: str) -> dict:
    """The 8-rank world at dp=2 tp=4: one step against tdax's (text and
    with images), eight steps, the sequence-parallel step against the
    plain one, accumulation, lm_loss and train_loop with resume."""
    _join(rank, world, store_path)
    try:
        with open(inp_path, "rb") as f:
            inp = pickle.load(f)
        mesh = pm.make_mesh(dp=2, tp=4)
        work = Path(work)
        tree, batch, sp = inp["tree"], inp["batch"], inp["batch_sp"]
        out = {"step": _trained(tree, batch, mesh),
               "steps": _trained(tree, batch, mesh, n_steps=8),
               "plain_sp_batch": _trained(tree, sp, mesh),
               "sp": _trained(tree, sp, mesh, sp_mesh=mesh, remat=True),
               "images": _trained(inp["tree_visual"], inp["batch_images"], mesh,
                                  with_images=True),
               "accum": _trained(tree, inp["batch_accum"], mesh, accum=2),
               "full_batch": _trained(tree, inp["batch_accum"], mesh),
               "lm_loss": _lm_loss(tree, sp, mesh)}
        if rank == 0:
            (work / "loop").mkdir()
        dist.barrier()
        out["loop"] = _loop(tree, batch, mesh, work / "loop")
        return out
    finally:
        pm.shutdown()


def one_train_world(rank: int, world: int, store_path: str, inp_path: str) -> dict:
    """The world of one: the plain step and lm_loss without a process
    group (one device), then the plain and the sequence-parallel step and
    lm_loss in a group of one at dp=1 tp=1, in the same process."""
    from tdax_torch.models.qwen_vl.convert import params_to_numpy
    from tdax_torch.parallel import train as tr
    with open(inp_path, "rb") as f:
        inp = pickle.load(f)
    tree, sp = inp["tree"], inp["batch_sp"]
    batch = {k: _t(v, long=k == "input_ids") for k, v in sp.items()}
    params = params_from_numpy(tree, "cpu", "float32")
    opt = tr.default_optimizer(1e-3)
    state = opt.init(params)
    _, state, loss = tr.make_train_step(CFG, opt, device="cpu")(params, state, batch)
    with torch.no_grad():
        value = float(tr.lm_loss(params_from_numpy(tree, "cpu", "float32"), CFG,
                                 batch["input_ids"], batch["attn_mask"]))
    one = {"losses": [float(loss)], "params": params_to_numpy(params),
           "mu": params_to_numpy(state.mu), "lm_loss": value}
    _join(rank, world, store_path)
    try:
        mesh = pm.make_mesh(dp=1, tp=1)
        return {"one": one, "plain": _trained(tree, sp, mesh),
                "sp": _trained(tree, sp, mesh, sp_mesh=mesh), "lm_loss": _lm_loss(tree, sp, mesh)}
    finally:
        pm.shutdown()


# ---- FSDP and the hybrid mesh (tests/test_torch_parallel_fsdp.py) --------------------

def _micro_rows(batch: dict, mesh, accum: int = 1) -> dict:
    """This rank's rows of a numpy batch over the mesh's batch axis; with
    ``accum`` the whole batch is first cut into that many microbatches
    along a new leading axis, each split over the batch axis (tdax's
    [accum, b / accum, ...] batch sharded P(None, "dp"))."""
    out = {}
    for key, v in batch.items():
        t = _t(v, long=key in ("input_ids", "image_positions"))
        if accum == 1:
            out[key] = pm.split_batch(t, mesh)
        else:
            micro = t.reshape(accum, t.shape[0] // accum, *t.shape[1:])
            out[key] = torch.stack([pm.split_batch(m, mesh) for m in micro])
    return out


def _spec_tuples(rules: dict) -> dict:
    return {k: _spec_tuples(v) if isinstance(v, dict) else tuple(v) for k, v in rules.items()}


def _fsdp_trained(tree: dict, batch: dict, mesh, n_steps: int = 1, accum: int = 1,
                  **step_kw) -> dict:
    """``n_steps`` FSDP steps (remat on, lr 1e-3) over ``mesh`` from
    ``tree`` sharded under ``fsdp_sharding_rules(tree, mesh)``, the step
    taking its mesh from ``param_shardings`` (no flash_sharding context):
    each step's loss, the whole tree and AdamW's first moment after them,
    the local sizes of ``layers/attn_qkv_w`` and its moments, and the
    steps' collectives by backend and by axis."""
    from tdax_torch.models.qwen_vl.convert import params_to_numpy
    from tdax_torch.parallel import train as tr
    whole = params_from_numpy(tree, "cpu", "float32")
    rules = pm.fsdp_sharding_rules(whole, mesh)
    params = pm.shard_params(whole, mesh, rules, cfg=CFG)
    opt = tr.default_optimizer(1e-3)
    state = opt.init(params)
    step = tr.make_train_step(CFG, opt, remat=True, param_shardings=pm.named_shardings(
        mesh, rules), accum_steps=accum, device="cpu", **step_kw)
    rows = _micro_rows(batch, mesh, accum)
    losses = []
    pm.COLLECTIVES.clear()
    pm.COLLECTIVES_BY_AXIS.clear()
    for _ in range(n_steps):
        _, state, loss = step(params, state, rows)
        losses.append(float(loss))
    local = {name: tree_["layers"]["attn_qkv_w"].numel()
             for name, tree_ in (("params", params), ("mu", state.mu), ("nu", state.nu))}
    return {"losses": losses, "collectives": dict(pm.COLLECTIVES),
            "by_axis": dict(pm.COLLECTIVES_BY_AXIS), "local_qkv": local,
            "rules": _spec_tuples(rules),
            "params": params_to_numpy(pm.unshard_params(params, mesh, CFG, rules)),
            "mu": params_to_numpy(pm.unshard_params(state.mu, mesh, CFG, rules))}


def _fsdp_loop(tree: dict, batch: dict, mesh, work: Path) -> dict:
    """train_loop(param_shardings=) over the mesh, 4 steps with a
    checkpoint every 2: uninterrupted, and stopped after 2 then resumed."""
    from tdax_torch.models.qwen_vl.convert import params_to_numpy
    from tdax_torch.parallel import train as tr
    from tdax_torch.utils.checkpoint import load_params
    rows = _micro_rows(batch, mesh)

    def run(name, n_steps):
        whole = params_from_numpy(tree, "cpu", "float32")
        rules = pm.fsdp_sharding_rules(whole, mesh)
        params = pm.shard_params(whole, mesh, rules, cfg=CFG)
        params, state, losses = tr.train_loop(
            params, CFG, lambda i: rows, n_steps, tr.default_optimizer(1e-3),
            checkpoint_path=str(work / name), checkpoint_every=2, log_every=0, remat=True,
            param_shardings=pm.named_shardings(mesh, rules), device="cpu")
        return (params_to_numpy(pm.unshard_params(params, mesh, CFG, rules)), losses,
                state.count, params["layers"]["attn_qkv_w"].numel())

    full, full_losses, count, local = run("full", 4)
    run("crash", 2)
    resumed, resumed_losses, resumed_count, resumed_local = run("crash", 4)
    saved = load_params(str(work / "full"))["p"]  # the whole tree rank 0 wrote
    return {"full": full, "full_losses": full_losses, "count": count, "resumed": resumed,
            "resumed_losses": resumed_losses, "resumed_count": resumed_count,
            "local_qkv": [local, resumed_local], "saved_params": params_to_numpy(saved)}


def _refusals() -> dict:
    """make_hybrid_mesh's errors for layouts the ranks do not fit."""
    out = {}
    for label, kw in (("dcn3", dict(dcn=3)), ("dp4_tp2", dict(dcn=2, dp=4, tp=2))):
        try:
            pm.make_hybrid_mesh(**kw)
            out[label] = None
        except ValueError as e:
            out[label] = str(e)
    return out


def fsdp_world(rank: int, world: int, store_path: str, inp_path: str, work: str) -> dict:
    """The 8-rank world: the FSDP rules on a mesh, the FSDP step at dp=4
    tp=2 (text, with images, with sp_mesh), accumulation at dp=2 tp=4,
    train_loop with resume, and the hybrid mesh at dcn=2 dp=2 tp=2 (its
    step and its capture) with its refusals."""
    _join(rank, world, store_path)
    try:
        with open(inp_path, "rb") as f:
            inp = pickle.load(f)
        work = Path(work)
        tree = inp["tree"]
        whole = params_from_numpy(tree, "cpu", "float32")
        dp4 = pm.make_mesh(dp=4, tp=2)
        dp2 = pm.make_mesh(dp=2, tp=4)
        hybrid = pm.make_hybrid_mesh(dcn=2, dp=2, tp=2)
        out = {"rules_on_meshes": {
            label: _spec_tuples(pm.fsdp_sharding_rules(whole, mesh))
            for label, mesh in (("dp4_tp2", dp4), ("dp2_tp4", dp2), ("hybrid", hybrid))},
            "hybrid_mesh": {"axis_names": hybrid.axis_names, "shape": hybrid.shape,
                            "batch_rank": hybrid.local_rank(hybrid.batch_axis)},
            "refusals": _refusals()}
        out["fsdp"] = _fsdp_trained(tree, inp["batch"], dp4)
        out["images"] = _fsdp_trained(inp["tree_visual"], inp["batch_images"], dp4,
                                      with_images=True)
        out["sp"] = _fsdp_trained(tree, inp["batch_sp"], dp4, sp_mesh=dp4)
        out["accum"] = _fsdp_trained(tree, inp["batch_accum"], dp2, accum=2)
        out["hybrid"] = _fsdp_trained(tree, inp["batch_hybrid"], hybrid)
        capture = pm.shard_params(params_from_numpy(inp["tree_capture"], "cpu", "float32"),
                                  hybrid, cfg=CFG)
        rows = [pm.split_batch(x, hybrid) for x in _capture_inputs(inp)]
        pm.COLLECTIVES_BY_AXIS.clear()
        with torch.inference_mode(), flash_sharding(hybrid, hybrid.batch_axis, "tp"):
            acts = extract_layer_activations(capture, CFG, *rows)
        out["hybrid_capture"] = {"acts": pm.gather_batch(acts, hybrid, dim=1).numpy(),
                                 "local_rows": rows[0].shape[0],
                                 "by_axis": dict(pm.COLLECTIVES_BY_AXIS)}
        if rank == 0:
            (work / "loop").mkdir()
        dist.barrier()
        out["loop"] = _fsdp_loop(tree, inp["batch"], dp4, work / "loop")
        return out
    finally:
        pm.shutdown()


def one_fsdp_world(rank: int, world: int, store_path: str, inp_path: str) -> dict:
    """The world of one: the step without a process group (remat on),
    then the FSDP step at dp=1 tp=1 and on a hybrid mesh of one, in the
    same process."""
    from tdax_torch.models.qwen_vl.convert import params_to_numpy
    from tdax_torch.parallel import train as tr
    with open(inp_path, "rb") as f:
        inp = pickle.load(f)
    tree, batch = inp["tree"], inp["batch_sp"]
    params = params_from_numpy(tree, "cpu", "float32")
    opt = tr.default_optimizer(1e-3)
    state = opt.init(params)
    rows = {k: _t(v, long=k == "input_ids") for k, v in batch.items()}
    _, state, loss = tr.make_train_step(CFG, opt, remat=True, device="cpu")(params, state, rows)
    one = {"losses": [float(loss)], "params": params_to_numpy(params),
           "mu": params_to_numpy(state.mu)}
    _join(rank, world, store_path)
    try:
        return {"one": one, "fsdp": _fsdp_trained(tree, batch, pm.make_mesh(dp=1, tp=1)),
                "hybrid": _fsdp_trained(tree, batch, pm.make_hybrid_mesh(dcn=1))}
    finally:
        pm.shutdown()


# ---- context parallelism: the ring (tests/test_torch_ring_attention.py) ----------------

def _ring_case(mesh, case: dict) -> dict:
    """The ring on this rank's block of a case (its dp rows, cp chunk and
    tp heads), under flash_sharding(seq_axis="cp"): its output and the
    gradients of sum(sin(o) * valid) for q, k and v, with the block's
    slices, and the ring's collectives by axis."""
    import os
    q, k, v, kv = (_t(case[n]) for n in ("q", "k", "v", "kv"))
    b, t, nh, _ = q.shape
    dp, tp, cp = (mesh.shape.get(a, 1) for a in ("dp", "tp", "cp"))
    d, h, c = (mesh.local_rank(a) if a in mesh.shape else 0 for a in ("dp", "tp", "cp"))
    sl = (slice(d * b // dp, (d + 1) * b // dp), slice(c * t // cp, (c + 1) * t // cp),
          slice(h * nh // tp, (h + 1) * nh // tp))
    loc = [x[sl].clone().requires_grad_() for x in (q, k, v)]
    kv_loc = kv[sl[0], sl[1]]
    if case.get("no_zigzag"):
        os.environ["TDAX_NO_ZIGZAG"] = "1"
    pm.COLLECTIVES_BY_AXIS.clear()
    try:
        with flash_sharding(mesh, "dp", "tp", seq_axis="cp"):
            o = fa.mha(*loc, fa.AttnSpec(kv_valid=kv_loc, causal=case["causal"]))
        (torch.sin(o) * kv_loc[:, :, None, None]).sum().backward()
    finally:
        os.environ.pop("TDAX_NO_ZIGZAG", None)
    return {"slices": sl, "o": o.detach().numpy(), "grads": [x.grad.numpy() for x in loc],
            "by_axis": dict(pm.COLLECTIVES_BY_AXIS)}


def _relayout(mesh) -> dict:
    """to_zigzag of the positions 0 .. T-1 (T = 8 cp, as [2, T, 1, 1]) on
    this rank's contiguous chunk, and from_zigzag of the result."""
    from tdax_torch.ops import ring_attention as ring
    cp, c = mesh.shape["cp"], mesh.local_rank("cp")
    x = torch.arange(8 * cp, dtype=torch.float32)[None, :, None, None].expand(2, -1, 1, 1)
    mine = x[:, c * 8:(c + 1) * 8].contiguous()
    (z,) = ring._to_zigzag([mine], mesh, "cp")
    return {"zigzag": z[0, :, 0, 0].numpy(), "back": ring._from_zigzag(z, mesh, "cp").numpy(),
            "mine": mine.numpy(), "cp_rank": c}


def ring_world(rank: int, world: int, store_path: str, inp_path: str) -> dict:
    """The 8-rank world: every ring case of the test on its mesh (dp=2
    cp=4 or dp=2 tp=2 cp=2), and the zigzag relayout's round trip."""
    _join(rank, world, store_path)
    try:
        with open(inp_path, "rb") as f:
            inp = pickle.load(f)
        meshes = {"dp2_cp4": pm.make_mesh(dp=2, tp=1, cp=4),
                  "dp2_tp2_cp2": pm.make_mesh(dp=2, tp=2, cp=2)}
        return {"cases": {name: _ring_case(meshes[case["mesh"]], case)
                          for name, case in inp["cases"].items()},
                "relayout": _relayout(meshes["dp2_cp4"])}
    finally:
        pm.shutdown()


# ---- context parallelism: the training step (tests/test_torch_parallel_cp.py) ---------

def _cp_trained(tree: dict, batch: dict, mesh, n_steps: int = 1, accum: int = 1,
                **step_kw) -> dict:
    """``n_steps`` steps of make_train_step(cp_mesh=mesh) from ``tree`` (lr
    1e-3), each rank passing its dp rows of the whole sequence (of each
    microbatch with ``accum``): each step's loss, the whole tree and AdamW's
    first moment after them, and the steps' collectives by axis."""
    from tdax_torch.models.qwen_vl.convert import params_to_numpy
    from tdax_torch.parallel import train as tr
    params = pm.shard_params(params_from_numpy(tree, "cpu", "float32"), mesh, cfg=CFG)
    opt = tr.default_optimizer(1e-3)
    state = opt.init(params)
    step = tr.make_train_step(CFG, opt, cp_mesh=mesh, accum_steps=accum, device="cpu", **step_kw)
    rows = _micro_rows(batch, mesh, accum)
    losses = []
    pm.COLLECTIVES_BY_AXIS.clear()
    for _ in range(n_steps):
        _, state, loss = step(params, state, rows)
        losses.append(float(loss))
    return {"losses": losses, "by_axis": dict(pm.COLLECTIVES_BY_AXIS),
            "params": params_to_numpy(pm.unshard_params(params, mesh, CFG)),
            "mu": params_to_numpy(pm.unshard_params(state.mu, mesh, CFG))}


def _cp_loop(tree: dict, batch: dict, mesh, work: Path) -> dict:
    """train_loop(cp_mesh=) with remat, 2 steps with a checkpoint after
    each: uninterrupted, and stopped after 1 then resumed."""
    from tdax_torch.models.qwen_vl.convert import params_to_numpy
    from tdax_torch.parallel import train as tr
    from tdax_torch.utils.checkpoint import load_params
    rows = _micro_rows(batch, mesh)

    def run(name, n_steps):
        params = pm.shard_params(params_from_numpy(tree, "cpu", "float32"), mesh, cfg=CFG)
        params, state, losses = tr.train_loop(
            params, CFG, lambda i: rows, n_steps, tr.default_optimizer(1e-3),
            checkpoint_path=str(work / name), checkpoint_every=1, log_every=0, remat=True,
            cp_mesh=mesh, device="cpu")
        return params_to_numpy(pm.unshard_params(params, mesh, CFG)), losses, state.count

    full, full_losses, count = run("full", 2)
    run("crash", 1)
    resumed, resumed_losses, resumed_count = run("crash", 2)
    saved = load_params(str(work / "full"))["p"]  # the whole tree rank 0 wrote
    return {"full": full, "full_losses": full_losses, "count": count, "resumed": resumed,
            "resumed_losses": resumed_losses, "resumed_count": resumed_count,
            "saved_params": params_to_numpy(saved),
            "files": sorted(p.name for p in work.iterdir())}


def cp_world(rank: int, world: int, store_path: str, inp_path: str, work: str) -> dict:
    """The 8-rank world: tdax's stage 10 (dp=2 cp=4, remat), dp=2 tp=2
    cp=2, accumulation and images at dp=2 cp=4, train_loop with resume."""
    _join(rank, world, store_path)
    try:
        with open(inp_path, "rb") as f:
            inp = pickle.load(f)
        cp4 = pm.make_mesh(dp=2, tp=1, cp=4)
        tp2 = pm.make_mesh(dp=2, tp=2, cp=2)
        tree = inp["tree"]
        out = {"stage10": _cp_trained(tree, inp["batch"], cp4, remat=True),
               "tp": _cp_trained(tree, inp["batch"], tp2),
               "accum": _cp_trained(tree, inp["batch"], cp4, accum=2, remat=True),
               "images": _cp_trained(inp["tree_visual"], inp["batch_images"], cp4,
                                     with_images=True)}
        work = Path(work) / "loop"
        if rank == 0:
            work.mkdir()
        dist.barrier()
        out["loop"] = _cp_loop(tree, inp["batch"], cp4, work)
        return out
    finally:
        pm.shutdown()


# ---- pipeline parallelism (tests/test_torch_parallel_pp.py) ----------------------------

def _pp_forward(tree: dict, batch: dict, mesh, n_micro: int, **kw) -> dict:
    """pipeline_forward on this rank's stage and dp rows, the whole batch's
    logits gathered over dp; and the one-device forward of the whole
    batch on this rank."""
    from tdax_torch.models.qwen_vl.model import forward
    from tdax_torch.parallel import pipeline as pl
    params = params_from_numpy(tree, "cpu", "float32")
    whole = {k: _t(v, long=k in ("input_ids", "image_positions")) for k, v in batch.items()}
    with torch.no_grad():
        one = forward(params, CFG, whole["input_ids"], whole["attn_mask"],
                      whole.get("images"), whole.get("image_positions"))
    rows = _micro_rows(batch, mesh)
    images = {k: rows[k] for k in ("images", "image_positions") if k in rows}
    logits = pl.pipeline_forward(pl.shard_params_pp(params, mesh), CFG, rows["input_ids"],
                                 rows["attn_mask"], mesh, n_micro, **images, **kw)
    return {"pipeline": pm.gather_batch(logits, mesh).numpy(), "one_device": one.numpy()}


def _pp_trained(tree: dict, batch: dict, mesh, n_micro: int, dtype: str = "float32",
                **step_kw) -> dict:
    """One make_train_step_pp step (lr 1e-3) from ``tree`` on this rank's
    stage and dp rows: the loss, the whole tree and AdamW's first moment
    after it (unshard_params_pp), the step's collectives by axis, and the
    stage tree's layout."""
    from tdax_torch.models.qwen_vl.convert import params_to_numpy
    from tdax_torch.parallel import pipeline as pl
    from tdax_torch.parallel import train as tr
    cfg = QwenVLConfig.tiny(dtype=dtype)
    local = pl.shard_params_pp(params_from_numpy(tree, "cpu", dtype), mesh)
    opt = tr.default_optimizer(1e-3)
    state = opt.init(local)
    step = pl.make_train_step_pp(cfg, opt, mesh, n_micro, **step_kw)
    rows = _micro_rows(batch, mesh)
    pm.COLLECTIVES_BY_AXIS.clear()
    _, state, loss = step(local, state, rows)
    by_axis = dict(pm.COLLECTIVES_BY_AXIS)
    return {"loss": float(loss), "by_axis": by_axis,
            "layout": {k: tuple(v["ln_1"].shape) if k == "layers" else None
                       for k, v in local.items()},
            "params": params_to_numpy(pl.unshard_params_pp(local, mesh)),
            "mu": params_to_numpy(pl.unshard_params_pp(state.mu, mesh))}


def _pp_grads(tree: dict, batch: dict, mesh, n_micro: int) -> dict:
    """pipeline_1f1b_grads with remat on this rank's stage: ce and what the
    rank holds of dlayers, dhead and dx."""
    from tdax_torch.models.qwen_vl.model import embed_inputs
    from tdax_torch.parallel import pipeline as pl
    local = pl.shard_params_pp(params_from_numpy(tree, "cpu", "float32"), mesh)
    rows = _micro_rows(batch, mesh)
    first, last = mesh.local_rank("pp") == 0, mesh.local_rank("pp") == mesh.shape["pp"] - 1
    x = embed_inputs(local, CFG, rows["input_ids"], None, None) if first else None
    head = {k: local[k] for k in ("ln_f", "lm_head")} if last else None
    ce, dlayers, dhead, dx = pl.pipeline_1f1b_grads(local["layers"], head, x, rows["input_ids"],
                                                    rows["attn_mask"], CFG, mesh, n_micro,
                                                    remat=True)
    return {"ce": float(ce), "dlayers": {k: v.numpy() for k, v in dlayers.items()},
            "dhead": None if dhead is None else {k: v.numpy() for k, v in dhead.items()},
            "dx": None if dx is None else dx.numpy()}


def _chain(mesh) -> dict:
    """ppermute along the pp chain [(i, i + 1)] with its backward: the
    first stage gets zeros, the last sends nothing and gets a zero
    gradient."""
    s = mesh.local_rank("pp")
    x = torch.full((2, 3), float(dist.get_rank() + 1), requires_grad=True)
    pm.COLLECTIVES_BY_AXIS.clear()
    y = pm.ppermute(x, mesh, "pp", [(i, i + 1) for i in range(mesh.shape["pp"] - 1)])
    (y * 10.0 * (s + 1)).sum().backward()
    return {"y": y.detach().numpy(), "grad": x.grad.numpy(),
            "by_axis": dict(pm.COLLECTIVES_BY_AXIS)}


def pp_world(rank: int, world: int, store_path: str, inp_path: str) -> dict:
    """The 8-rank world: tdax's stage 9 (dp=2 pp=4, 1F1B) and the other
    pipeline cases of the test, on meshes dp=2 pp=4 and dp=4 pp=2."""
    from tdax_torch.models.qwen_vl.convert import params_to_numpy
    from tdax_torch.parallel import pipeline as pl
    _join(rank, world, store_path)
    try:
        with open(inp_path, "rb") as f:
            inp = pickle.load(f)
        pp4, pp2 = pl.make_pp_mesh(pp=4, dp=2), pl.make_pp_mesh(pp=2, dp=4)
        tree, tree_v = inp["tree"], inp["tree_visual"]
        b8, b16, bi = inp["batch8"], inp["batch16"], inp["batch_images"]
        whole = pl.unshard_params_pp(
            pl.shard_params_pp(params_from_numpy(tree_v, "cpu", "float32"), pp4), pp4)
        return {"stage": pp4.local_rank("pp"), "dp": pp4.local_rank("dp"),
                "chain": _chain(pp4),
                "roundtrip": params_to_numpy(whole),
                "fwd_m2": _pp_forward(tree, b8, pp4, 2),
                "fwd_m4_remat": _pp_forward(tree, b16, pp4, 4, remat=True),
                "fwd_images": _pp_forward(tree_v, bi, pp4, 2),
                "step_m2": _pp_trained(tree, b8, pp4, 2),
                "step_m4_remat": _pp_trained(tree, b16, pp4, 4, remat=True),
                "step_dp4_pp2": _pp_trained(tree, b16, pp2, 2),
                "grads": _pp_grads(tree, b16, pp4, 4),
                "gpipe": _pp_trained(tree, b16, pp4, 4, schedule="gpipe"),
                "gpipe_visual": _pp_trained(tree_v, b8, pp4, 2, schedule="gpipe"),
                "bf16": _pp_trained(tree, b8, pp4, 2, dtype="bfloat16")}
    finally:
        pm.shutdown()


# ---- FSDP under context parallelism (tests/test_torch_parallel_cp_fsdp.py) -------------

def _cp_fsdp_step(tree: dict, batch: dict, mesh, fsdp: bool, accum: int = 1,
                  **step_kw) -> dict:
    """One step of make_train_step(cp_mesh=mesh) with remat (lr 1e-3) from
    ``tree``, under FSDP (``param_shardings`` of ``fsdp_sharding_rules`` on
    the mesh) or as the plain cp step; each rank passes its dp rows of the
    whole sequence (of each microbatch with ``accum``).  The loss, the
    clip's global norm, the whole tree and AdamW's first moment after the
    step, this rank's share of layers/attn_qkv_w and of its two moments,
    and the step's collectives by axis."""
    from tdax_torch.models.qwen_vl.convert import params_to_numpy
    from tdax_torch.parallel import train as tr
    whole = params_from_numpy(tree, "cpu", "float32")
    rules = pm.fsdp_sharding_rules(whole, mesh) if fsdp else None
    params = pm.shard_params(whole, mesh, rules, cfg=CFG)
    del whole
    opt = tr.default_optimizer(1e-3)
    state = opt.init(params)
    if fsdp:
        step_kw["param_shardings"] = pm.named_shardings(mesh, rules)
    step = tr.make_train_step(CFG, opt, remat=True, cp_mesh=mesh, accum_steps=accum,
                              device="cpu", **step_kw)
    rows = _micro_rows(batch, mesh, accum)
    pm.COLLECTIVES_BY_AXIS.clear()
    loss, grads = step.loss_and_grads(params, state, rows)
    norm = state.update(grads, **step.shards(state))
    by_axis = dict(pm.COLLECTIVES_BY_AXIS)
    return {"loss": float(loss), "norm": float(norm), "by_axis": by_axis,
            "rules": None if rules is None else _spec_tuples(rules),
            "local_qkv": {name: t["layers"]["attn_qkv_w"].numpy().copy()
                          for name, t in (("params", params), ("mu", state.mu),
                                          ("nu", state.nu))},
            "params": params_to_numpy(pm.unshard_params(params, mesh, CFG, rules)),
            "mu": params_to_numpy(pm.unshard_params(state.mu, mesh, CFG, rules))}


def _one_device_norm(tree: dict, batch: dict, accum: int = 1, **step_kw) -> float:
    """The clip's global norm of one step on one device (no mesh, remat)
    on the whole batch (cut into ``accum`` microbatches)."""
    from tdax_torch.parallel import train as tr
    params = params_from_numpy(tree, "cpu", "float32")
    opt = tr.default_optimizer(1e-3)
    state = opt.init(params)
    step = tr.make_train_step(CFG, opt, remat=True, accum_steps=accum, device="cpu", **step_kw)
    rows = {k: _t(v, long=k in ("input_ids", "image_positions")) for k, v in batch.items()}
    if accum > 1:
        rows = {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:]) for k, v in rows.items()}
    _, grads = step.loss_and_grads(params, state, rows)
    return float(state.update(grads))


def _cp_fsdp_loop(tree: dict, batch: dict, mesh, work: Path) -> dict:
    """train_loop(cp_mesh=, param_shardings=) with remat and a checkpoint
    after every step: 3 steps straight, and 2 steps then a resume from
    the checkpoint for the third."""
    from tdax_torch.models.qwen_vl.convert import params_to_numpy
    from tdax_torch.parallel import train as tr
    from tdax_torch.utils.checkpoint import load_params
    rows = _micro_rows(batch, mesh)

    def run(name, n_steps):
        whole = params_from_numpy(tree, "cpu", "float32")
        rules = pm.fsdp_sharding_rules(whole, mesh)
        params = pm.shard_params(whole, mesh, rules, cfg=CFG)
        params, state, losses = tr.train_loop(
            params, CFG, lambda i: rows, n_steps, tr.default_optimizer(1e-3),
            checkpoint_path=str(work / name), checkpoint_every=1, log_every=0, remat=True,
            cp_mesh=mesh, param_shardings=pm.named_shardings(mesh, rules), device="cpu")
        return (params_to_numpy(pm.unshard_params(params, mesh, CFG, rules)), losses,
                state.count, params["layers"]["attn_qkv_w"].numel())

    full, full_losses, count, local = run("full", 3)
    run("crash", 2)
    resumed, resumed_losses, resumed_count, resumed_local = run("crash", 3)
    saved = load_params(str(work / "full"))["p"]  # the whole tree rank 0 wrote
    return {"full": full, "full_losses": full_losses, "count": count, "resumed": resumed,
            "resumed_losses": resumed_losses, "resumed_count": resumed_count,
            "local_qkv": [local, resumed_local], "saved_params": params_to_numpy(saved),
            "files": sorted(p.name for p in work.iterdir())}


def cp_fsdp_world(rank: int, world: int, store_path: str, inp_path: str, work: str) -> dict:
    """A world of 4 ranks (dp=2 cp=2) or 8 (dp=2 tp=2 cp=2): the FSDP cp
    step and the plain cp step, text-only and with images; at 4 ranks
    also both with 2 microbatches, train_loop with resume, and rank 0's
    one-device norms of the same batches."""
    _join(rank, world, store_path)
    try:
        with open(inp_path, "rb") as f:
            inp = pickle.load(f)
        mesh = pm.make_mesh(dp=2, tp=world // 4, cp=2)
        tree, tree_v = inp["tree"], inp["tree_visual"]
        batch, images = inp["batch"], inp["batch_images"]
        out = {"ranks": {a: mesh.local_rank(a) for a in ("dp", "tp", "cp")}}
        for fsdp, suffix in ((True, ""), (False, "_plain")):
            out["text" + suffix] = _cp_fsdp_step(tree, batch, mesh, fsdp)
            out["images" + suffix] = _cp_fsdp_step(tree_v, images, mesh, fsdp,
                                                   with_images=True)
            if world == 4:
                out["accum" + suffix] = _cp_fsdp_step(tree, batch, mesh, fsdp, accum=2)
        if world == 4:
            if rank == 0:
                out["one_device_norm"] = {
                    "text": _one_device_norm(tree, batch),
                    "images": _one_device_norm(tree_v, images, with_images=True),
                    "accum": _one_device_norm(tree, batch, accum=2)}
            loop = Path(work) / "loop"
            if rank == 0:
                loop.mkdir()
            dist.barrier()
            out["loop"] = _cp_fsdp_loop(tree, batch, mesh, loop)
        return out
    finally:
        pm.shutdown()
