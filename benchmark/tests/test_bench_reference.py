"""The f32 reference agrees with the port's plain CPU path at the tiny
size (capture, int8 capture, loss and gradient, three AdamW steps), and
a lower precision put in the program's place fails at least one of the
same tolerances."""


import pytest
import torch

from benchmark import work
from benchmark.inputs import CaptureInputs, TokenBatches
from benchmark.reference import numerics
from benchmark.reference.qwen_vl import Model
from benchmark.reference.train import TrainReference
from benchmark.jobs import TINY
from benchmark.weights import Weights

CFG = {**TINY, "dtype": "float32", "weights": "float32"}
MD = work.model(CFG)
# f32 both sides: the same products summed in other orders
TOL = 1e-5


def _port_cfg():
    from benchmark.jobs import qwen_config
    return qwen_config(CFG)


def _capture_inputs(seed=4):
    inp = CaptureInputs({"batch_size": 8, "pad_multiple": 64, "render_size": 200, "pool_batches": 1},
                        MD.image_size, MD.n_queries, MD.vocab, seed)
    return [torch.from_numpy(a.copy()) for a in inp.batch(0)]


def _rel(a, b):
    return float(((a - b).norm(dim=-1) / b.norm(dim=-1)).max())


def _port_capture(params, batch):
    from tdax_torch.models.qwen_vl.model import extract_layer_activations
    with torch.inference_mode():
        return extract_layer_activations(params, _port_cfg(), *batch).float()


def test_capture_agrees_and_int8_does_not():
    params = Weights(MD, 4, "cpu", torch.float32).build()
    batch = _capture_inputs()
    ref = Model(params, MD, numerics.Exact()).capture(*batch)
    assert _rel(_port_capture(params, batch), ref) < TOL
    lower = Model(params, MD, numerics.PerChannel(8)).capture(*batch)
    assert _rel(lower, ref) > 10 * TOL


@pytest.mark.parametrize("control", [numerics.PerChannel(4), numerics.Fp8()])
def test_int8_capture_agrees_and_lower_does_not(control):
    from tdax_torch.models.qwen_vl.quantize import quantize_params
    params = Weights(MD, 5, "cpu", torch.float32).build()
    batch = _capture_inputs(5)
    ref = Model(params, MD, numerics.PerChannel(8)).capture(*batch)
    assert _rel(_port_capture(quantize_params(params), batch), ref) < TOL
    assert _rel(Model(params, MD, control).capture(*batch), ref) > 10 * TOL


def _batches(seed=6):
    return TokenBatches({"batch_size": 4, "seq_len": 64, "masked_tail": 8, "pool_batches": 3},
                        MD.vocab, seed, "cpu")


def test_loss_and_gradient_agree():
    from tdax_torch.parallel import default_optimizer, make_train_step
    params = Weights(MD, 6, "cpu", torch.float32, with_visual=False).build()
    b = _batches().batch(0)
    ref = TrainReference(params, MD, numerics.Exact(), 1e-3)
    ref_loss = ref.step(b["input_ids"], b["attn_mask"])
    opt = default_optimizer(1e-3)
    state = opt.init(params)
    step = make_train_step(_port_cfg(), opt, remat=True, device="cpu")
    loss, grads = step.loss_and_grads(params, state, b)
    assert abs(float(loss) - ref_loss) < TOL * abs(ref_loss)
    got = {("%s/%s" % (p, i)) if i is not None else p: g
           for g, (p, i) in zip(grads, state.names)}
    for name, g in got.items():
        want = ref.history[0][0][name].float()  # the reference keeps it in bf16
        assert float((g - want).norm()) <= 2 ** -8 * float(want.norm()) + 1e-12, name
        assert float(g.norm()) == pytest.approx(ref.grad_norms[0][name], rel=1e-4, abs=1e-9)


def _three_steps(numerics_obj, seed=7, lr=3e-3):
    from tdax_torch.parallel import default_optimizer, make_train_step
    from benchmark.jobs.train import Job
    pool = _batches(seed)
    p0 = Weights(MD, seed, "cpu", torch.float32, with_visual=False).build()
    ref = TrainReference(p0, MD, numerics_obj, lr)
    for s in range(3):
        b = pool.batch(s)
        ref.step(b["input_ids"], b["attn_mask"])
    want = {"losses": ref.losses, "first_update": ref.first_update_norms(),
            "change": ref.change_norms()}
    params = Weights(MD, seed, "cpu", torch.float32, with_visual=False).build()
    opt = default_optimizer(lr)
    state = opt.init(params)
    step = make_train_step(_port_cfg(), opt, remat=True, device="cpu")
    losses = []
    for s in range(3):
        params, state, loss = step(params, state, pool.batch(s))
        losses.append(float(loss))
    change = {}
    for leaf, (p, i) in zip(state.leaves, state.names):
        name = p if i is None else f"{p}/{i}"
        start = p0[p] if "/" not in p else p0["layers"][p.split("/")[1]][i]
        change[name] = float((leaf.detach() - start).norm())
    return want, {"losses": losses, "change": change}, Job.compare


def test_adamw_three_steps_agree_and_fp8_does_not():
    want, got, compare = _three_steps(numerics.Exact())
    got["first_update"] = want["first_update"]
    gaps = compare(got, want)
    assert gaps["loss_gap"] < 1e-4 and gaps["change_gap"] < 1e-2, gaps
    fp8, _, _ = _three_steps(numerics.Fp8())
    control = compare(fp8, want)
    assert control["loss_gap"] > 1e-4 or control["first_update_gap"] > 1e-2, control


def test_weights_have_the_ports_layout():
    """The benchmark's tree has ``init_params``' names, shapes and
    constants, so the program takes it as its own."""
    from tdax_torch.models.qwen_vl.model import init_params
    ours = Weights(MD, 1, "cpu", torch.float32).build()
    ports = init_params(_port_cfg(), "cpu", 1)

    def walk(a, b, path=""):
        assert set(a) == set(b), path
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k], f"{path}/{k}")
                continue
            assert a[k].shape == b[k].shape, f"{path}/{k}"
            if k.startswith("ln") or k.endswith("_b"):
                assert torch.equal(a[k], b[k]), f"{path}/{k}"
            if k in ("q_pos", "kv_pos"):
                assert torch.allclose(a[k], b[k], atol=1e-6), f"{path}/{k}"

    walk(ours, ports)
    w = Weights(MD, 1, "cpu", torch.float32, with_visual=False)
    tree = w.build()
    for path in ("layers/mlp_w1", "layers/ln_1", "ln_f", "wte"):
        node = tree
        for part in path.split("/"):
            node = node[part]
        assert torch.equal(w.initial(path), node), path
