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
    for label, kw, exc in (("value_error", dict(dp=3, tp=2), ValueError),
                           ("cp", dict(dp=4, tp=1, cp=2), NotImplementedError)):
        try:
            pm.make_mesh(**kw)
            out[label] = "no error"
        except exc as e:
            out[label] = f"{type(e).__name__}: {e}"
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
