"""The visual tower's elementwise kernels against their plain versions, on
the card: ``vit_ln_rows`` and ``vit_bias_epilogue`` at the capture's
shapes and at ragged ones, the refusal of rows that are not whole 16-byte
vectors, their gradients through the autograd Functions, and a tiny
capture's launch counts.

Marked ``cuda``: these skip where no card is present.  This file imports
neither ``jax`` nor ``tdax``, so on the machine with the card it runs
without the JAX conftest:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_vit_elementwise_cuda.py

Tolerances: the bias and residual forms round as the plain version does,
operation for operation: bitwise.  The LayerNorm rounds as the plain
version does and sums each row in the order of PyTorch's CUDA reduce:
bitwise too.  The GELU computes PyTorch's formula with the same tanhf:
within one unit in the last place (ulp) of the type.
"""

import pytest
import torch

from tdax_torch.ops import vit_elementwise as ve

pytestmark = pytest.mark.cuda

EPS = 1e-6
_MANTISSA = {torch.bfloat16: 7, torch.float32: 23}


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from tdax_torch.runtime import get_device
    return get_device()


def _ulp(v: torch.Tensor, dtype) -> torch.Tensor:
    """One unit in the last place of ``dtype`` at |v| (f32), the smallest
    normal's at 0."""
    _, e = torch.frexp(v.abs().clamp_min(torch.finfo(dtype).tiny))
    return torch.ldexp(torch.ones_like(v), (e - 1 - _MANTISSA[dtype]).int())


def _within_ulp(got: torch.Tensor, want: torch.Tensor, scale: torch.Tensor) -> None:
    err = (got.float() - want.float()).abs()
    limit = _ulp(torch.maximum(scale, want.float().abs()), got.dtype)
    bad = err > limit
    assert not bad.any(), (f"{int(bad.sum())} of {err.numel()} elements beyond one ulp; "
                           f"worst {float((err / limit).max()):.2f} ulp")


def _inputs(device, dtype, rows, cols, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    x = (torch.randn(rows, cols, generator=g, device=device) * 2 + 0.3).to(dtype)
    w = (torch.randn(cols, generator=g, device=device) * 0.5 + 1).to(dtype)
    b = (torch.randn(cols, generator=g, device=device) * 0.5).to(dtype)
    return x, w, b


@pytest.mark.parametrize("rows,cols", [(16384, 1664), (16384, 4096), (256, 4096), (37, 1000),
                                       (5, 32), (1, 1664), (7, 96), (48, 104)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_layer_norm_matches_plain(device, rows, cols, dtype):
    x, w, b = _inputs(device, dtype, rows, cols)
    assert ve._route(x, w, b) == "kernel"
    before = ve.LAUNCHES_LN
    got = ve.layer_norm(x, w, b, EPS)
    torch.cuda.synchronize()
    assert ve.LAUNCHES_LN == before + 1
    want = ve.layer_norm_plain(x, w, b, EPS)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, want), f"{int((got != want).sum())} of {got.numel()} elements differ"


def test_rows_off_16_byte_vectors_are_refused(device):
    """A row stride and base off 16 bytes raise before a launch; the
    contiguous copy takes the kernel."""
    x, w, b = _inputs(device, torch.bfloat16, 64, 1664 + 3)
    view = x[:, 3:]
    before = (ve.LAUNCHES_LN, ve.LAUNCHES_EPILOGUE)
    with pytest.raises(ValueError, match="16-byte"):
        ve.layer_norm(view, w[3:], b[3:], EPS)
    with pytest.raises(ValueError, match="16-byte"):
        ve.bias_epilogue_(view.contiguous(), b[3:], residual=view)
    assert (ve.LAUNCHES_LN, ve.LAUNCHES_EPILOGUE) == before
    copies = view.contiguous(), w[3:].clone(), b[3:].clone()
    assert torch.equal(ve.layer_norm(*copies, EPS), ve.layer_norm(*copies, EPS))
    assert ve.LAUNCHES_LN == before[0] + 2


@pytest.mark.parametrize("rows,cols,form", [(16384, 4992, "bias"), (16384, 8192, "gelu"),
                                            (16384, 1664, "residual"), (16384, 4096, "bias"),
                                            (33, 1000, "gelu"), (33, 1000, "residual"),
                                            (7, 96, "bias")])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bias_epilogue_matches_plain(device, rows, cols, form, dtype):
    p, _, b = _inputs(device, dtype, rows, cols, seed=1)
    res = _inputs(device, dtype, rows, cols, seed=2)[0] if form == "residual" else None
    gelu = form == "gelu"
    want = ve.bias_epilogue_plain(p, b, gelu, res)
    before = ve.LAUNCHES_EPILOGUE
    work = p.clone()
    got = ve.bias_epilogue_(work, b, gelu=gelu, residual=res)
    torch.cuda.synchronize()
    assert ve.LAUNCHES_EPILOGUE == before + 1
    assert got is work  # written over the product, no gradient needed
    assert got.dtype == dtype and got.shape == want.shape
    if gelu:
        _within_ulp(got, want, want.float().abs())
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("form", ["layer_norm", "bias", "gelu", "residual"])
def test_gradients_through_the_functions_are_the_plain_chains(device, dtype, form):
    x, w, b = _inputs(device, dtype, 2048, 1664, seed=3)
    p = (x * 0.7).to(dtype)
    dy = _inputs(device, dtype, 2048, 1664, seed=4)[0]
    if form == "layer_norm":
        args = [x, w, b]
        fn = lambda *a: ve.layer_norm(*a, EPS)  # noqa: E731
        plain = lambda *a: ve.layer_norm_plain(*a, EPS)  # noqa: E731
    else:
        args = [p, b, x if form == "residual" else None]
        fn = lambda *a: ve.bias_epilogue_(a[0], a[1], gelu=form == "gelu", residual=a[2])  # noqa: E731
        plain = lambda *a: ve.bias_epilogue_plain(a[0], a[1], form == "gelu", a[2])  # noqa: E731
    grads, launches = [], []
    for f in (fn, plain):
        leaves = [None if t is None else t.clone().requires_grad_() for t in args]
        before = (ve.LAUNCHES_LN, ve.LAUNCHES_EPILOGUE)
        out = f(*leaves)
        launches.append((ve.LAUNCHES_LN - before[0], ve.LAUNCHES_EPILOGUE - before[1]))
        out.backward(dy)
        grads.append([None if t is None else t.grad for t in leaves])
    assert launches == [(1, 0) if form == "layer_norm" else (0, 1), (0, 0)]
    for got, want in zip(*grads):
        assert (got is None) == (want is None)
        if got is not None:
            assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_tiny_capture_takes_the_kernels_at_every_pass(device, dtype, monkeypatch):
    """Per visual_encode: ln_pre, two a block, ln_kv, ln_q and ln_post; four
    epilogues a block (qkv, attn_proj, fc, mlp_proj) and four in the
    resampler (q, k, v, out).  The capture matches the plain passes' on
    the same card."""
    from tdax_torch.models.qwen_vl import QwenVLConfig, extract_layer_activations
    from tdax_torch.models.qwen_vl.model import init_params

    cfg = QwenVLConfig.tiny(dtype=dtype)
    vis = cfg.visual
    params = init_params(cfg, device, seed=0)
    g = torch.Generator(device=device).manual_seed(0)
    bsz, t = 3, 40
    ids = torch.randint(0, cfg.vocab_size, (bsz, t), generator=g, device=device)
    mask = torch.ones((bsz, t), dtype=torch.int32, device=device)
    last = torch.full((bsz,), t - 1, dtype=torch.long, device=device)
    images = torch.randn((bsz, 3, vis.image_size, vis.image_size), generator=g, device=device)
    pos = (torch.arange(vis.n_queries, device=device) + 2).expand(bsz, -1)

    def capture():
        with torch.inference_mode():
            return extract_layer_activations(params, cfg, ids, mask, last, images, pos)

    before = (ve.LAUNCHES_LN, ve.LAUNCHES_EPILOGUE)
    got = capture()
    torch.cuda.synchronize()
    assert (ve.LAUNCHES_LN - before[0], ve.LAUNCHES_EPILOGUE - before[1]) == (
        2 * vis.layers + 4, 4 * vis.layers + 4)
    monkeypatch.setattr(ve, "_route", lambda *t: "plain")
    want = capture()
    scale = float(want.float().abs().max())
    tol = 1e-4 if dtype == "float32" else 5e-2
    assert float((got.float() - want.float()).abs().max()) <= tol * scale
