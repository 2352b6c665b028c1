"""Port's train step, train loop and checkpoints against tdax's, tiny f32.

Three ``make_train_step`` steps from one numpy tree go through tdax
(``optax`` clip + adamw under ``warmup_cosine_lr(1e-3, 2, 6)``: learning
rates 0, 5e-4, 1e-3) and through the port (``torch.optim.AdamW`` under
the same schedule).  Tolerances: losses 1e-5 relative; params 1e-4
relative plus 3e-5 absolute (Adam divides each moment by the root of the
second, so a gradient that rounds differently near zero moves its
update by more than its own error); moments 1e-4 relative plus 1e-4 of
the leaf's largest magnitude.  Resume from the port's checkpoint is
bitwise, and tdax's ``load_params`` reads the port's files.
"""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tdax.models.qwen_vl import QwenVLConfig as JConfig
from tdax.models.qwen_vl import init_params as j_init_params
from tdax.parallel.train import default_optimizer as j_default_optimizer
from tdax.parallel.train import make_train_step as j_make_train_step
from tdax.parallel.train import warmup_cosine_lr as j_warmup_cosine_lr
from tdax.utils.checkpoint import _savez_packed
from tdax.utils.checkpoint import load_params as j_load_params

from tdax_torch.models.qwen_vl import QwenVLConfig
from tdax_torch.models.qwen_vl.convert import params_from_numpy, params_to_numpy
from tdax_torch.parallel import (default_optimizer, make_train_step, train_loop,
                                 warmup_cosine_lr)
from tdax_torch.utils import log
from tdax_torch.utils.checkpoint import load_params, save_params

CFG = QwenVLConfig.tiny(dtype="float32")
JCFG = JConfig.tiny(dtype="float32")
PARAM_TOL = dict(rtol=1e-4, atol=3e-5)


def _noisy(tree, rng):
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            out[name] = _noisy(leaf, rng)
            continue
        leaf = np.array(leaf, dtype=np.float32)
        if name.startswith("ln") or name.endswith("_b"):
            leaf = leaf + rng.normal(0, 0.1, leaf.shape).astype(np.float32)
        out[name] = leaf
    return out


def _tree(with_visual, seed=5):
    t = jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(seed), JCFG,
                                               with_visual=with_visual))
    return _noisy(t, np.random.default_rng(seed))


def _batch(seed, b=2, t=24, images=False):
    rng = np.random.default_rng(seed)
    batch = {"input_ids": rng.integers(1, 64, (b, t)).astype(np.int32),
             "attn_mask": np.ones((b, t), np.int32)}
    batch["attn_mask"][b - 1, t - 5:] = 0
    if images:
        nq, size = CFG.visual.n_queries, CFG.visual.image_size
        pos = np.full((b, nq), -1, np.int32)
        pos[0] = np.arange(2, 2 + nq)
        batch["image_positions"] = pos
        batch["images"] = rng.normal(size=(b, 3, size, size)).astype(np.float32)
    return batch


def _to_torch(batch):
    return {k: torch.from_numpy(v).long() if k in ("input_ids", "image_positions")
            else torch.from_numpy(v) for k, v in batch.items()}


def _close(got, want, rtol, atol_of_max=None, atol=0.0, path=""):
    assert set(got) == set(want), path
    for name in want:
        if isinstance(want[name], dict):
            _close(got[name], want[name], rtol, atol_of_max, atol, f"{path}/{name}")
            continue
        w = np.asarray(want[name])
        limit = atol if atol_of_max is None else atol_of_max * float(np.abs(w).max())
        np.testing.assert_allclose(got[name], w, rtol=rtol, atol=limit,
                                   err_msg=f"{path}/{name}")


def _pop_key_biases(tree, cfg):
    """Take the key biases out of a visual tree: the resampler's attn_k_b
    and the key third of the ViT's attn_qkv_b.  Softmax does not change
    when every score of a row moves by one constant, so their gradient is
    zero in exact arithmetic and rounding noise in both packages, which
    Adam turns into steps of up to lr: they are compared on their own,
    params within 2e-3 (the three steps' learning rates sum to 1.5e-3),
    moments within the noise's size."""
    vis = tree["visual"]
    w = cfg.visual.width
    qkv_b = vis["blocks"]["attn_qkv_b"]
    out = [vis["resampler"].pop("attn_k_b"), qkv_b[:, w:2 * w].copy()]
    vis["blocks"]["attn_qkv_b"] = np.concatenate([qkv_b[:, :w], qkv_b[:, 2 * w:]], axis=1)
    return out


@pytest.mark.parametrize("case", ["text", "visual_tree", "images"])
def test_three_steps_match_tdax(case):
    """text: a text-only tree; visual_tree: a tree with the visual tower
    that a text-only step does not touch (AdamW must decay those leaves
    as optax does); images: with_images=True through the ViT and the
    resampler backward."""
    with_visual, with_images = case != "text", case == "images"
    tree = _tree(with_visual)
    batches = [_batch(10 + i, images=with_images) for i in range(3)]

    j_opt = j_default_optimizer(j_warmup_cosine_lr(1e-3, 2, 6))
    jp = jax.tree.map(jnp.asarray, tree)
    j_state = j_opt.init(jp)
    j_step = j_make_train_step(JCFG, j_opt, with_images=with_images)
    j_losses = []
    for b in batches:
        jp, j_state, loss = j_step(jp, j_state, jax.tree.map(jnp.asarray, b))
        j_losses.append(float(loss))

    opt = default_optimizer(warmup_cosine_lr(1e-3, 2, 6))
    params = params_from_numpy(tree, "cpu", "float32")
    state = opt.init(params)
    step = make_train_step(CFG, opt, with_images=with_images, device="cpu")
    losses = []
    for b in batches:
        params, state, loss = step(params, state, _to_torch(b))
        losses.append(float(loss))

    np.testing.assert_allclose(losses, j_losses, rtol=1e-5)
    assert state.count == 3 and int(j_state[1][0].count) == 3
    adam = j_state[1][0]
    pairs = [(params_to_numpy(params), jax.tree.map(np.asarray, jp), PARAM_TOL, 2e-3),
             (params_to_numpy(state.mu), jax.tree.map(np.asarray, adam.mu),
              dict(rtol=1e-4, atol_of_max=1e-4), 1e-6),
             (params_to_numpy(state.nu), jax.tree.map(np.asarray, adam.nu),
              dict(rtol=1e-4, atol_of_max=1e-4), 1e-9)]
    for got, want, tol, noise_atol in pairs:
        if with_images:
            for g, w in zip(_pop_key_biases(got, CFG), _pop_key_biases(want, CFG)):
                np.testing.assert_allclose(g, w, rtol=0, atol=noise_atol)
        _close(got, want, **tol)
    if case == "visual_tree":
        assert float(np.abs(params_to_numpy(state.nu)["visual"]["proj"]).max()) == 0.0
        moved = params_to_numpy(params)["visual"]["proj"] - tree["visual"]["proj"]
        assert np.abs(moved).max() > 0  # decayed


def test_accum_steps_equal_the_full_batch():
    """accum_steps=4 over 4 microbatches of 2 rows (different numbers of
    real tokens each) gives the full batch's loss and gradient: the
    moments after one step agree."""
    tree = _tree(False, seed=6)
    full = _batch(20, b=8, t=16)
    full["attn_mask"][:, 12:] = np.arange(8)[:, None] % 2  # ragged microbatches
    micro = {k: v.reshape(4, 2, *v.shape[1:]) for k, v in full.items()}
    results = []
    for accum, batch in ((1, full), (4, micro)):
        opt = default_optimizer(1e-3)
        params = params_from_numpy(tree, "cpu", "float32")
        state = opt.init(params)
        step = make_train_step(CFG, opt, accum_steps=accum, device="cpu")
        _, state, loss = step(params, state, _to_torch(batch))
        results.append((float(loss), params_to_numpy(state.mu)))
    np.testing.assert_allclose(results[1][0], results[0][0], rtol=1e-6)
    _close(results[1][1], results[0][1], 1e-4, 1e-5)
    bad = {k: v[:3] for k, v in _to_torch(micro).items()}
    with pytest.raises(ValueError, match="accum_steps=4"):
        step(state.params, state, bad)


def test_bf16_step_keeps_bf16_params_and_moments():
    tree = _tree(False, seed=7)
    params = params_from_numpy(tree, "cpu", "bfloat16")
    opt = default_optimizer(1e-3)
    state = opt.init(params)
    step = make_train_step(CFG, opt, device="cpu")
    _, _, loss = step(params, state, _to_torch(_batch(30)))
    assert np.isfinite(float(loss))
    for tree_ in (params, state.mu, state.nu):
        assert tree_["layers"]["mlp_w1"].dtype == torch.bfloat16
    assert float(state.mu["layers"]["mlp_w1"].abs().max()) > 0


def test_step_refuses_an_opt_state_of_another_tree():
    tree = _tree(False, seed=8)
    opt = default_optimizer()
    state = opt.init(params_from_numpy(tree, "cpu", "float32"))
    step = make_train_step(CFG, opt, device="cpu")
    with pytest.raises(ValueError, match="another params tree"):
        step(params_from_numpy(tree, "cpu", "float32"), state, _to_torch(_batch(1)))


def _loop_batches():
    fixed = [_to_torch(_batch(40 + i, t=12)) for i in range(6)]
    return lambda i: fixed[i]


def test_resume_from_checkpoint_is_bitwise(tmp_path):
    """train_loop stopped after its checkpoint at step 4 and resumed to 6
    lands on exactly the uninterrupted run's params, moments and losses."""
    tree = _tree(False, seed=9)

    def run(n_steps, **kw):
        return train_loop(params_from_numpy(tree, "cpu", "float32"), CFG, _loop_batches(),
                          n_steps, optimizer=default_optimizer(warmup_cosine_lr(1e-3, 2, 6)),
                          device="cpu", **kw)

    straight, s_state, losses = run(6)
    assert len(losses) == 6 and np.isfinite(losses).all()
    ck = str(tmp_path / "train_ck")
    at4, _, first = run(4, checkpoint_path=ck, checkpoint_every=4)
    assert first == losses[:4]
    resumed, r_state, rest = run(6, checkpoint_path=ck, checkpoint_every=100)
    assert rest == losses[4:]
    assert r_state.count == s_state.count == 6
    for a, b in ((straight, resumed), (s_state.mu, r_state.mu), (s_state.nu, r_state.nu)):
        for name, x in params_to_numpy(a)["layers"].items():
            np.testing.assert_array_equal(x, params_to_numpy(b)["layers"][name])
        np.testing.assert_array_equal(params_to_numpy(a)["wte"], params_to_numpy(b)["wte"])
    # tdax reads the params of the port's training state
    j_tree = j_load_params(ck)
    assert int(j_tree["step"]) == 4
    np.testing.assert_array_equal(j_tree["p"]["lm_head"], params_to_numpy(at4)["lm_head"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tdax_load_params_reads_the_ports_params(tmp_path, dtype):
    params = params_from_numpy(_tree(True, seed=11), "cpu", dtype)
    path = str(tmp_path / "params")
    save_params(path, params)
    got = j_load_params(path)
    want = params_to_numpy(params)
    assert str(got["layers"]["mlp_w1"].dtype) == dtype
    _close(jax.tree.map(lambda x: np.asarray(x, np.float32), got), want, 0.0, atol=0.0)
    back = load_params(path)
    for name in ("wte", "lm_head"):
        assert torch.equal(back[name], params[name])
    assert torch.equal(back["visual"]["blocks"]["mlp_fc_w"],
                       params["visual"]["blocks"]["mlp_fc_w"])
    # and the port reads the file as tdax writes it (its .npz branch)
    flat = {"layers/mlp_w1": got["layers"]["mlp_w1"], "ln_f": got["ln_f"]}
    _savez_packed(str(tmp_path / "tdax.npz"), flat)
    from_tdax = load_params(str(tmp_path / "tdax"))
    assert torch.equal(from_tdax["layers"]["mlp_w1"], params["layers"]["mlp_w1"])
    assert torch.equal(from_tdax["ln_f"], params["ln_f"])


def test_train_loop_logs_train_windows(tmp_path):
    log_path = tmp_path / "events.jsonl"
    log.configure(str(log_path))
    try:
        train_loop(params_from_numpy(_tree(False, seed=12), "cpu", "float32"), CFG,
                   _loop_batches(), 4, log_every=2, device="cpu")
    finally:
        log.configure(None)
    events = [json.loads(line) for line in log_path.read_text().splitlines()]
    assert [e["step"] for e in events] == [2, 4]
    assert all(e["event"] == "train_window" and np.isfinite(e["loss"]) for e in events)
