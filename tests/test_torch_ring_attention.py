"""The port's ring attention (context parallelism) against tdax's, on the CPU.

tdax runs its ring (``tdax/ops/ring_attention.py``, ``shard_map`` over
the conftest's 8 virtual XLA devices) and its one-device ``mha``; the
port runs a gloo world of 8 ranks (``torch_parallel_worlds.ring_world``,
spawned once per test session), each rank holding its block of q, k, v
(its dp rows, its cp chunk and, at dp=2 tp=2 cp=2, its tp heads) under
``flash_sharding(seq_axis="cp")``; the test reassembles the blocks.  Both
take the same numpy inputs (seeds).  Checks and their tolerances
(tests/test_ring_attention.py:53-145):

  * ``FlashAttentionLse`` (CPU: the kernels' plain versions) against
    tdax's ``_build_flash_lse`` in interpret mode, with a loss that reads
    lse too, so its cotangent is not zero: o, lse and the gradients
    within rtol 1e-4 and atol 1e-5;
  * the zigzag tables and the schedule's block counts equal tdax's for
    cp in 2..8; the relayout's round trip on the ranks;
  * every ring case (dp=2 cp=4: causal and dense, padded and not, the
    zigzag and the contiguous ring under ``TDAX_NO_ZIGZAG=1``, an odd
    local chunk; dp=2 tp=2 cp=2: heads split inside the ring) against
    tdax's ring (one case of it through the Pallas kernel in interpret
    mode) and against tdax's one-device ``mha``: the output within 1e-5
    on the rows that see a key (tdax's tests mask the others: every path
    leaves them undefined), the gradients of sum(sin(o) * valid) within
    rtol 1e-4 and atol 1e-5;
  * the ring's collectives: cp permutes only, as many as its schedule.
"""

import os
import pickle

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from tdax.ops import ring_attention as jring
from tdax.ops.flash_attention import AttnSpec as JSpec
from tdax.ops.flash_attention import NEG_INF, _build_flash_lse
from tdax.ops.flash_attention import flash_sharding as j_flash_sharding
from tdax.ops.flash_attention import mha as j_mha

import torch

import torch_parallel_worlds as worlds
from tdax_torch.ops import flash_attention as fa
from tdax_torch.ops import ring_attention as ring

FWD_TOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
# (mesh, causal, padded, T, no_zigzag): B 4, nh 4, hd 32 at dp=2 cp=4 (tdax's
# _qkv); hd 16 at dp=2 tp=2 cp=2 (tdax's test_ring_head_sharded_too)
CASES = {
    "causal": ("dp2_cp4", True, False, 64, False),
    "causal_padded": ("dp2_cp4", True, True, 64, False),
    "dense": ("dp2_cp4", False, False, 64, False),
    "dense_padded": ("dp2_cp4", False, True, 64, False),
    "causal_padded_no_zigzag": ("dp2_cp4", True, True, 64, True),
    "causal_padded_odd_chunk": ("dp2_cp4", True, True, 36, False),
    "tp_causal_padded": ("dp2_tp2_cp2", True, True, 32, False),
    "tp_dense": ("dp2_tp2_cp2", False, False, 32, False),
}
# the ring cases held against tdax's ring through the Pallas kernel
# (TDAX_FLASH_INTERPRET=1) as well
INTERPRET = ("causal_padded",)


def _inputs() -> dict:
    rng = np.random.default_rng(0)
    cases = {}
    for name, (mesh, causal, padded, t, no_zig) in CASES.items():
        hd = 32 if mesh == "dp2_cp4" else 16
        q, k, v = (rng.normal(size=(4, t, 4, hd)).astype(np.float32) for _ in range(3))
        kv = np.ones((4, t), np.int32)
        if padded:
            cp = 4 if mesh == "dp2_cp4" else 2
            kv = (rng.random((4, t)) > 0.2).astype(np.int32)
            kv[1, :t // cp] = 0  # one whole chunk invalid for one row
        cases[name] = {"mesh": mesh, "causal": causal, "no_zigzag": no_zig,
                       "q": q, "k": k, "v": v, "kv": kv}
    return {"cases": cases}


def _j_mesh(name: str) -> Mesh:
    if name == "dp2_cp4":
        return Mesh(np.array(jax.devices()).reshape(2, 4), ("dp", "cp"))
    return Mesh(np.array(jax.devices()).reshape(2, 2, 2), ("dp", "tp", "cp"))


def _tdax_run(case: dict, sharded: bool, interpret: bool = False) -> dict:
    """tdax's output and gradients of sum(sin(o) * valid): its ring under
    flash_sharding(seq_axis="cp") on the case's mesh, or one device."""
    q, k, v = (jnp.asarray(case[n]) for n in ("q", "k", "v"))
    kv = jnp.asarray(case["kv"])
    spec = JSpec(kv_valid=kv, causal=case["causal"])
    w = kv[:, :, None, None]
    mesh = _j_mesh(case["mesh"])
    h_ax = "tp" if "tp" in mesh.axis_names else None

    def loss(q, k, v):
        if sharded:
            with j_flash_sharding(mesh, batch_axis="dp", head_axis=h_ax, seq_axis="cp"):
                o = j_mha(q, k, v, spec)
        else:
            o = j_mha(q, k, v, spec)
        return jnp.sum(jnp.sin(o) * w), o

    env = {"TDAX_NO_ZIGZAG": "1" if case["no_zigzag"] else None,
           "TDAX_FLASH_INTERPRET": "1" if interpret else None}
    saved = {key: os.environ.get(key) for key in env}
    try:
        for key, val in env.items():
            os.environ.pop(key, None) if val is None else os.environ.__setitem__(key, val)
        (_, o), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    finally:
        for key, val in saved.items():
            os.environ.pop(key, None) if val is None else os.environ.__setitem__(key, val)
    return {"o": np.asarray(o), "grads": [np.asarray(g) for g in grads]}


def _compute(work) -> dict:
    inp = _inputs()
    inp_path = work / "inp.pkl"
    with open(inp_path, "wb") as f:
        pickle.dump(inp, f)
    (work / "eight").mkdir()
    ranks = worlds.run_world(worlds.ring_world, 8, work / "eight", str(inp_path))
    tdax = {name: {"ring": _tdax_run(case, True), "one": _tdax_run(case, False)}
            for name, case in inp["cases"].items()}
    for name in INTERPRET:
        tdax[name]["ring_interpret"] = _tdax_run(inp["cases"][name], True, interpret=True)
    return {"inp": inp, "ranks": ranks, "tdax": tdax}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return worlds.once(tmp_path_factory, "torch_ring_attention", _compute)


def _assembled(results, name: str) -> dict:
    """The ranks' blocks of a case put back together."""
    case = results["inp"]["cases"][name]
    o = np.zeros_like(case["q"])
    grads = [np.zeros_like(case["q"]) for _ in range(3)]
    for r in results["ranks"]:
        rec = r["cases"][name]
        o[rec["slices"]] = rec["o"]
        for g, part in zip(grads, rec["grads"]):
            g[rec["slices"]] = part
    return {"o": o, "grads": grads}


def _seen(case: dict) -> np.ndarray:
    """[B, T, 1, 1]: the query rows that see a valid key (tdax's _row_ok)."""
    kv = case["kv"]
    if case["causal"]:
        ok = np.cumsum(kv, axis=1) > 0
    else:
        ok = np.broadcast_to(kv.any(axis=1, keepdims=True), kv.shape)
    return ok[:, :, None, None]


def _refs(name: str):
    return [(name, "ring"), (name, "one")] + [(name, "ring_interpret")] * (name in INTERPRET)


REFS = [ref for name in CASES for ref in _refs(name)]


@pytest.mark.parametrize("name,ref", REFS)
def test_ring_forward_matches_tdax(results, name, ref):
    case = results["inp"]["cases"][name]
    got, want = _assembled(results, name)["o"], results["tdax"][name][ref]["o"]
    assert np.abs((got - want) * _seen(case)).max() < FWD_TOL


@pytest.mark.parametrize("name,ref", REFS)
def test_ring_grads_match_tdax(results, name, ref):
    got, want = _assembled(results, name)["grads"], results["tdax"][name][ref]["grads"]
    for which, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a, b, err_msg=f"d{which}", **GRAD_TOL)


@pytest.mark.parametrize("name", ["causal", "causal_padded_no_zigzag", "dense", "tp_causal_padded"])
def test_ring_collectives_are_its_schedule(results, name):
    """Only cp permutes: the zigzag ring one relayout op in and one out
    and cp - 1 rotations, each way (forward and backward); the contiguous
    ring the rotations alone."""
    case = results["inp"]["cases"][name]
    cp = 4 if case["mesh"] == "dp2_cp4" else 2
    zigzag = case["causal"] and not case["no_zigzag"]
    want = 2 * ((cp - 1) + (2 if zigzag else 0))
    for r in results["ranks"]:
        assert r["cases"][name]["by_axis"] == {"cp.ppermute": want}


def test_zigzag_relayout_round_trip(results):
    """to_zigzag puts halves (j, 2cp-1-j) of the global order on cp rank j;
    from_zigzag gives each rank its contiguous chunk back."""
    cp, hl = 4, 4
    for r in results["ranks"]:
        rec = r["relayout"]
        j = rec["cp_rank"]
        want = np.r_[np.arange(j * hl, (j + 1) * hl), np.arange((2 * cp - 1 - j) * hl,
                                                                (2 * cp - j) * hl)]
        np.testing.assert_array_equal(rec["zigzag"], want.astype(np.float32))
        np.testing.assert_array_equal(rec["back"], rec["mine"])


@pytest.mark.parametrize("cp", range(2, 9))
def test_zigzag_tables_and_blocks_match_tdax(cp):
    got, want = ring._zigzag_tables(cp), jring._zigzag_tables(cp)
    for a, b in zip(got[:4], want[:4]):
        assert a == b
    np.testing.assert_array_equal(got[4], want[4])
    for d in range(cp):
        for s in range(cp):
            assert ring._zigzag_step_blocks(cp, d, s) == jring._zigzag_step_blocks(cp, d, s)
    totals = {sum(ring._zigzag_step_blocks(cp, d, s) for s in range(cp)) for d in range(cp)}
    assert totals == {2 * cp + 1}


@pytest.mark.parametrize("causal,tq,tk", [(True, 40, 40), (False, 24, 40)])
def test_flash_attention_lse_matches_tdax_interpret(causal, tq, tk):
    """(o, lse) and the gradients of a loss that reads both, so lse's
    cotangent folds into delta: the port's FlashAttentionLse (plain
    versions) against tdax's _build_flash_lse through the Pallas kernel in
    interpret mode."""
    rng = np.random.default_rng(7)
    b, nh, hd = 2, 2, 16
    q = rng.normal(size=(b, tq, nh, hd)).astype(np.float32)
    k, v = (rng.normal(size=(b, tk, nh, hd)).astype(np.float32) for _ in range(2))
    valid = rng.random((b, tk)) > 0.3
    valid[:, 0] = True  # every row sees a key (the others are undefined on every path)
    bias = np.where(valid, 0.0, NEG_INF).astype(np.float32)
    wo = rng.normal(size=(b, tq, nh, hd)).astype(np.float32)
    wl = rng.normal(size=(b, nh, tq)).astype(np.float32)

    f = _build_flash_lse(causal, True)

    def j_loss(q, k, v):
        o, lse = f(q, k, v, jnp.asarray(bias))
        lse = lse.reshape(b, nh, -1)[:, :, :tq]
        return jnp.sum(jnp.sin(o) * wo) + jnp.sum(jnp.cos(lse) * wl), (o, lse)

    (_, (jo, jlse)), jg = jax.value_and_grad(j_loss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(x) for x in (q, k, v)))
    tq_, tk_, tv_ = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o, lse = fa.FlashAttentionLse.apply(tq_, tk_, tv_, torch.from_numpy(bias), causal)
    (torch.sin(o) * torch.from_numpy(wo)).sum().add(
        (torch.cos(lse) * torch.from_numpy(wl)).sum()).backward()
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), **GRAD_TOL)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(jlse), **GRAD_TOL)
    for which, got, want in zip("qkv", (tq_, tk_, tv_), jg):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want), err_msg=f"d{which}",
                                   **GRAD_TOL)


def test_mha_under_a_seq_axis_takes_self_attention_only():
    """A rank holds only its chunk, so where tdax warns and attends
    replicated (dimensions that do not divide, cross-attention) the port
    raises ValueError, before any collective."""
    q = torch.zeros(2, 8, 2, 16)
    k = torch.zeros(2, 12, 2, 16)
    with fa.flash_sharding(object(), "dp", None, seq_axis="cp"), \
            pytest.raises(ValueError, match="self-attention on each rank's chunk"):
        fa.mha(q, k, k, fa.AttnSpec())
