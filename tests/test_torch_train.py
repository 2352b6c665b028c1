"""Port's training loss and gradients against tdax's on the tiny f32 config.

One numpy tree (tdax's random init with noise on norms and biases) goes
to both packages; the port's copy comes from ``params_from_numpy``.  The
port's gradients are per-layer (its trainable leaves are views of each
stacked weight) and are stacked back into tdax's layout to compare.
Tolerances: the loss at 1e-5 relative, every gradient leaf at rtol 1e-4
plus 1e-4 of the leaf's largest magnitude (f32 on both sides, summed in
different orders; the embedding's gradient sums the whole network's and
cancels most; tdax once through its Pallas kernels in interpret mode,
TDAX_FLASH_INTERPRET=1, once through its einsum path); the schedule at
1e-6 relative.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tdax.models.qwen_vl import QwenVLConfig as JConfig
from tdax.models.qwen_vl import init_params as j_init_params
from tdax.parallel.train import lm_loss as j_lm_loss
from tdax.parallel.train import masked_ce_parts as j_masked_ce_parts
from tdax.parallel.train import warmup_cosine_lr as j_warmup_cosine_lr

from tdax_torch.models.qwen_vl import QwenVLConfig
from tdax_torch.models.qwen_vl.convert import params_from_numpy, params_to_numpy
from tdax_torch.parallel.train import (default_optimizer, lm_loss, masked_ce_parts,
                                       warmup_cosine_lr)

CFG = QwenVLConfig.tiny(dtype="float32")
JCFG = JConfig.tiny(dtype="float32")
GRAD_TOL = dict(rtol=1e-4, atol_of_max=1e-4)


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


@pytest.fixture(scope="module")
def tree():
    t = jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(4), JCFG, with_visual=False))
    return _noisy(t, np.random.default_rng(0))


def _batch(seed=1, b=2, t=12):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, CFG.vocab_size, (b, t)).astype(np.int32)
    mask = np.ones((b, t), np.int32)
    mask[1, t - 4:] = 0
    return ids, mask


def _port_grads(tree, ids, mask, remat=False):
    params = params_from_numpy(tree, "cpu", "float32")
    state = default_optimizer().init(params)
    loss = lm_loss(state.tree, CFG, torch.from_numpy(ids).long(), torch.from_numpy(mask),
                   remat=remat)
    grads = torch.autograd.grad(loss, state.leaves)
    return float(loss.detach()), params_to_numpy(state.stack(grads))


def _assert_trees_close(got, want, rtol, atol_of_max):
    assert set(got) == set(want)
    for name in want:
        if isinstance(want[name], dict):
            _assert_trees_close(got[name], want[name], rtol, atol_of_max)
        else:
            w = np.asarray(want[name])
            np.testing.assert_allclose(got[name], w, rtol=rtol, err_msg=name,
                                       atol=atol_of_max * float(np.abs(w).max()))


def test_masked_ce_parts_matches_tdax():
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(3, 9, 50)).astype(np.float32) * 3
    ids = rng.integers(0, 50, (3, 9)).astype(np.int32)
    mask = (rng.random((3, 9)) > 0.3).astype(np.int32)
    ce, n = masked_ce_parts(torch.from_numpy(logits), torch.from_numpy(ids).long(),
                            torch.from_numpy(mask))
    j_ce, j_n = j_masked_ce_parts(jnp.asarray(logits), jnp.asarray(ids), jnp.asarray(mask))
    np.testing.assert_allclose(float(ce), float(j_ce), rtol=1e-6)
    assert float(n) == float(j_n) == mask[:, 1:].sum()


@pytest.fixture(params=["interpret", "einsum"])
def tdax_flash(request, monkeypatch):
    """tdax through its Pallas kernels (interpret mode) or its einsum path."""
    if request.param == "interpret":
        monkeypatch.setenv("TDAX_FLASH_INTERPRET", "1")
    else:
        monkeypatch.delenv("TDAX_FLASH_INTERPRET", raising=False)
    return request.param


def test_loss_and_every_gradient_match_tdax(tree, tdax_flash):
    ids, mask = _batch()
    loss, grads = _port_grads(tree, ids, mask)
    j_loss, j_grads = jax.value_and_grad(lambda p: j_lm_loss(
        p, JCFG, jnp.asarray(ids), jnp.asarray(mask)))(jax.tree.map(jnp.asarray, tree))
    np.testing.assert_allclose(loss, float(j_loss), rtol=1e-5)
    _assert_trees_close(grads, jax.tree.map(np.asarray, j_grads), **GRAD_TOL)


def test_remat_gradients_equal_the_plain_ones(tree):
    """Full-block checkpointing replays the same operations: the same
    gradients (tdax's test_remat_grads_match_plain tolerance)."""
    ids, mask = _batch(3)
    loss, plain = _port_grads(tree, ids, mask)
    loss_r, remat = _port_grads(tree, ids, mask, remat=True)
    assert loss == loss_r
    _assert_trees_close(remat, plain, rtol=1e-5, atol_of_max=1e-6)


@pytest.mark.parametrize("peak,warmup,total", [(1e-3, 2, 6), (1e-4, 2, 8), (3e-4, 5, 50)])
def test_warmup_cosine_lr_equals_optax(peak, warmup, total):
    mine, ref = warmup_cosine_lr(peak, warmup, total), j_warmup_cosine_lr(peak, warmup, total)
    assert mine(0) == 0.0
    for count in range(total + 3):
        np.testing.assert_allclose(mine(count), float(ref(count)), rtol=1e-6, atol=0,
                                   err_msg=f"count {count}")
