"""The visual tower's elementwise passes on the CPU: which version takes
which tensors, the plain versions against the expressions the tower
wrote before its kernels, the autograd Functions' replayed backward, and
what the kernel library's build hash and names cover.  ``_route`` reads
the device alone, and the kernels take rows of whole 16-byte vectors
(meta tensors stand in for the card's full-width tensors; their strides
and alignment are read, never their data).  The kernels themselves are
held against the plain versions on the card
(``tests/test_torch_vit_elementwise_cuda.py``).
"""

import re
import shutil

import pytest
import torch
import torch.nn.functional as F

from benchmark.layer_metrics import LIBRARY_GEMMS, PORT_KERNELS
from tdax_torch.models.qwen_vl.config import QwenVLConfig, VisualConfig
from tdax_torch.ops import _build
from tdax_torch.ops import vit_elementwise as ve

FULL = VisualConfig()
TINY = QwenVLConfig.tiny().visual
EPS = 1e-6


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _sites(cfg: VisualConfig, batch: int):
    """(name, the route's tensors) of every pass of visual_encode: the
    LayerNorms' x, w and b, the epilogues' p and b (and residual)."""
    t, w, d, m, q = cfg.n_patches, cfg.width, cfg.output_dim, cfg.mlp_dim, cfg.n_queries

    def ln(*shape):
        return (_meta(batch, *shape) if len(shape) == 2 else _meta(*shape),
                _meta(shape[-1]), _meta(shape[-1]))

    return [("ln_pre/ln_1/ln_2", ln(t, w)), ("ln_kv", ln(t, d)), ("ln_q", ln(q, d)),
            ("ln_post", ln(q, d)),
            ("qkv", (_meta(batch, t, 3 * w), _meta(3 * w))),
            ("fc", (_meta(batch, t, m), _meta(m))),
            ("attn_proj/mlp_proj", (_meta(batch, t, w), _meta(w), _meta(batch, t, w))),
            ("resampler_q/out", (_meta(batch, q, d), _meta(d))),
            ("resampler_k/v", (_meta(batch, t, d), _meta(d)))]


def _as(dtype, tensors):
    return tuple(torch.empty(x.shape, dtype=dtype, device="meta") for x in tensors)


def _taken(*tensors) -> str:
    """"plain", "kernel", or "refused" (a card tensor the kernels do not
    take)."""
    if ve._route(*tensors) == "plain":
        return "plain"
    return "kernel" if ve._whole_vectors(*tensors) else "refused"


@pytest.mark.parametrize("cfg,batch", [(FULL, 16), (TINY, 3)], ids=["capture", "tiny"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_every_pass_of_the_tower_takes_the_vector_kernels(cfg, batch, dtype):
    for name, tensors in _sites(cfg, batch):
        assert _taken(*_as(dtype, tensors)) == "kernel", name


@pytest.mark.parametrize("tp", [1, 2, 4, 8, 16])
def test_every_tp_shard_of_the_tower_is_whole_vectors(tp):
    """Under tp a rank holds 1/tp of the heads and MLP columns (tp divides
    ViT-bigG's 16 heads): each shard's width is whole vectors in both
    types, so no tp layout reaches the refusal."""
    for width in (3 * FULL.width // tp, FULL.width // tp, FULL.mlp_dim // tp):
        for dtype in (torch.bfloat16, torch.float32):
            assert _taken(_meta(16, 1024, width, dtype=dtype), _meta(width, dtype=dtype)) == (
                "kernel"), (tp, width, dtype)


def _x_view(rows, cols, offset=0, ld=None, dtype=torch.bfloat16):
    """x [rows, cols] as a view of a wider meta buffer: a card tensor's
    strides and base (``offset`` elements in)."""
    ld = ld or cols
    flat = torch.empty(offset + rows * ld + 8, dtype=dtype, device="meta")
    return flat[offset:offset + rows * ld].view(rows, ld)[:, :cols]


@pytest.mark.parametrize("make,want", [
    (lambda: (torch.zeros(4, 1664, dtype=torch.bfloat16), torch.zeros(1664, dtype=torch.bfloat16)),
     "plain"),
    (lambda: (torch.zeros(4, 16), torch.zeros(16)), "plain"),
    (lambda: (_meta(16, 1001), _meta(1001)), "refused"),              # C off the vector
    (lambda: (_meta(16, 1002, dtype=torch.float32), _meta(1002, dtype=torch.float32)), "refused"),
    (lambda: (_x_view(16, 1664, offset=1), _meta(1664)), "refused"),  # base 2 bytes off 16
    (lambda: (_x_view(16, 1664, ld=1668), _meta(1664)), "refused"),  # row stride % 8
    (lambda: (_x_view(16, 1664, ld=3 * 1664), _meta(1664)), "kernel"),  # an aligned column slice
    (lambda: (_meta(16, 1664), _meta(1664), _x_view(16, 1664, offset=4)), "refused"),  # residual
    (lambda: (_meta(16, 1664), _meta(3328)[::2]), "refused"),         # a strided bias
], ids=["cpu_bf16", "cpu_f32", "c1001", "f32_c1002", "x_misaligned", "x_ld1668",
        "x_column_slice", "residual_misaligned", "b_strided"])
def test_the_route_at_the_edges(make, want):
    assert _taken(*make()) == want


# (rows, cols) -> (threads a row, vectorized) of PyTorch's CUDA mean over
# the last dimension, each held on the card (the emulated order bitwise
# torch.mean's and the variance's): a warp from 16 rows up, wider blocks
# below, vectors of four from 128 elements
@pytest.mark.parametrize("rows,cols,want", [
    (16384, 1664, (32, True)),   # ln_pre, ln_1, ln_2
    (16384, 4096, (32, True)),   # ln_kv
    (4096, 4096, (32, True)),    # ln_post
    (256, 4096, (32, True)),     # ln_q
    (16384, 832, (32, True)),    # a tp=2 rank's width
    (16384, 104, (32, False)),   # a tp=16 rank's
    (48, 32, (32, False)),       # the tiny config
    (16, 64, (32, False)),
    (1, 1664, (256, True)),
    (5, 1664, (128, True)),
    (3, 4096, (256, True)),
    (7, 96, (64, False)),
    (100, 100, (32, False)),
])
def test_the_layer_norm_sums_in_pytorchs_reduce_shape(rows, cols, want):
    assert ve._reduce_shape(rows, cols) == want


@pytest.mark.parametrize("rows,cols", [(16, 8192), (16384, 16384), (1, 16384)])
def test_rows_pytorch_splits_across_warps_raise(rows, cols):
    with pytest.raises(ValueError, match="across warps"):
        ve._reduce_shape(rows, cols)


# the expressions models/qwen_vl/vit.py wrote before the kernels
def _old_layer_norm(x, w, b, eps):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * w + b


def _old_gelu_tanh(x):
    return F.gelu(x.float(), approximate="tanh").to(x.dtype)


def _wider(x, extra):
    """x's values in a buffer ``extra`` columns wider (row stride C + extra)."""
    out = torch.zeros(x.shape[0], x.shape[1] + extra, dtype=x.dtype)
    out[:, :x.shape[1]] = x
    return out


def _offset(x, elements):
    """x's values in a view starting ``elements`` past an aligned base."""
    flat = torch.zeros(x.numel() + elements, dtype=x.dtype)
    view = flat[elements:].view(x.shape)
    view.copy_(x)
    return view


def _inputs(dtype, rows=40, cols=96, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(rows, cols, generator=g) * 3 + 0.5).to(dtype)
    w = (torch.randn(cols, generator=g) + 1).to(dtype)
    b = torch.randn(cols, generator=g).to(dtype)
    return x, w, b


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("form", ["layer_norm", "bias", "gelu", "residual"])
def test_the_plain_versions_are_the_old_expressions_bitwise(dtype, form):
    x, w, b = _inputs(dtype)
    p = (x * 0.7).to(dtype)
    if form == "layer_norm":
        want = _old_layer_norm(x, w, b, EPS)
        got = [ve.layer_norm_plain(x, w, b, EPS), ve.layer_norm(x, w, b, EPS)]
    elif form == "bias":
        want = p + b
        got = [ve.bias_epilogue_plain(p, b), ve.bias_epilogue_(p.clone(), b)]
    elif form == "gelu":
        want = _old_gelu_tanh(p + b)
        got = [ve.bias_epilogue_plain(p, b, gelu=True),
               ve.bias_epilogue_(p.clone(), b, gelu=True), ve.gelu_tanh(p + b)]
    else:
        want = x + (p + b)
        got = [ve.bias_epilogue_plain(p, b, residual=x),
               ve.bias_epilogue_(p.clone(), b, residual=x)]
    for g in got:
        assert g.dtype == dtype and torch.equal(g, want)


def test_the_cpu_leaves_its_inputs_and_the_counters_alone():
    """Every input but the epilogue's p, which it consumes."""
    x, w, b = _inputs(torch.bfloat16)
    p = (x * 0.7).to(torch.bfloat16)
    keep = [t.clone() for t in (x, w, b)]
    before = (ve.LAUNCHES_LN, ve.LAUNCHES_EPILOGUE)
    ve.layer_norm(x, w, b, EPS)
    for kw in ({}, {"gelu": True}, {"residual": x}):
        ve.bias_epilogue_(p.clone(), b, **kw)
    assert all(torch.equal(t, k) for t, k in zip((x, w, b), keep))
    assert (ve.LAUNCHES_LN, ve.LAUNCHES_EPILOGUE) == before


@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "grad"])
@pytest.mark.parametrize("form", ["bias", "gelu", "residual"])
def test_the_epilogue_writes_over_p_where_no_gradient_is_needed(form, grad):
    """As on the card: without a gradient the result is p, overwritten;
    with one, p is left as it was and the result is new.  The values are
    the plain version's either way."""
    x, _, b = _inputs(torch.float32, seed=6)
    p = x * 0.7
    kw = {"gelu": form == "gelu", "residual": x if form == "residual" else None}
    want = ve.bias_epilogue_plain(p, b, kw["gelu"], kw["residual"])
    work = p.clone().requires_grad_(grad)
    got = ve.bias_epilogue_(work, b, **kw)
    assert (got is work) == (not grad)
    assert torch.equal(work.detach(), p if grad else want)
    assert torch.equal(got.detach(), want)


@pytest.mark.parametrize("call,err", [
    (lambda x, w, b: ve.layer_norm_cuda(x, w, b, EPS), (ValueError, "CUDA")),
    (lambda x, w, b: ve.bias_epilogue_cuda(x, b), (ValueError, "CUDA")),
    (lambda x, w, b: ve.bias_epilogue_cuda(x, b, residual=x), (ValueError, "CUDA")),
    (lambda x, w, b: ve.layer_norm_cuda(x, w.float(), b, EPS), (TypeError, "all be bfloat16")),
    (lambda x, w, b: ve.bias_epilogue_cuda(x.half(), b.half()), (TypeError, "all be bfloat16")),
    (lambda x, w, b: ve.layer_norm_cuda(x, w[:-1], b, EPS), (ValueError, "do not match")),
    (lambda x, w, b: ve.bias_epilogue_cuda(x, b, residual=x[:-1]), (ValueError, "do not match")),
    (lambda x, w, b: ve.bias_epilogue_cuda(x[:0], b), (ValueError, "empty")),
    (lambda x, w, b: ve.bias_epilogue_cuda(x, b, gelu=True, residual=x), (ValueError, "separate")),
    (lambda x, w, b: ve.layer_norm_cuda(x[:, :92], w[:92], b[:92], EPS), (ValueError, "16-byte")),
    (lambda x, w, b: ve.layer_norm_cuda(_wider(x, 4)[:, :96], w, b, EPS),
     (ValueError, "16-byte")),
    (lambda x, w, b: ve.bias_epilogue_cuda(x, b, residual=_offset(x, 1)), (ValueError, "16-byte")),
    (lambda x, w, b: ve.bias_epilogue_cuda(_offset(x, 3), b, in_place=True),
     (ValueError, "16-byte")),
], ids=["ln_cpu", "bias_cpu", "residual_cpu", "ln_mixed_types", "fp16", "ln_w_short",
        "residual_short", "empty", "gelu_and_residual", "ln_c_off_vector", "ln_row_stride",
        "residual_base_off_16", "in_place_base_off_16"])
def test_the_kernel_wrappers_refuse_what_the_kernels_do_not_take(call, err):
    """Each refusal comes before a build or a launch, and counts nothing:
    a row that is not whole 16-byte vectors on a 16-byte boundary too."""
    x, w, b = _inputs(torch.bfloat16)
    before = (ve.LAUNCHES_LN, ve.LAUNCHES_EPILOGUE)
    with pytest.raises(err[0], match=err[1]):
        call(x, w, b)
    assert (ve.LAUNCHES_LN, ve.LAUNCHES_EPILOGUE) == before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("form", ["layer_norm", "bias", "gelu", "residual"])
def test_the_functions_backward_is_the_plain_chains(monkeypatch, dtype, form):
    """The autograd Functions with the plain version standing in for the
    kernel: their gradients (x, w, b; p, b, residual) equal the plain
    chain's, bitwise, whichever inputs need one."""
    monkeypatch.setattr(ve, "layer_norm_cuda", ve.layer_norm_plain)
    monkeypatch.setattr(ve, "bias_epilogue_cuda",
                        lambda p, b, gelu=False, residual=None: ve.bias_epilogue_plain(
                            p, b, gelu, residual))
    x, w, b = _inputs(dtype, seed=3)
    p = (x * 0.7).to(dtype)
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(5)).to(dtype)
    for frozen in ((), (1,), (0, 2)):
        if form == "layer_norm":
            args = [x, w, b]
            fn = lambda *a: ve._LayerNorm.apply(*a, EPS)  # noqa: E731
            plain = lambda *a: ve.layer_norm_plain(*a, EPS)  # noqa: E731
        else:
            args = [p, b, x if form == "residual" else None]
            fn = lambda *a: ve._BiasEpilogue.apply(*a, form == "gelu")  # noqa: E731
            plain = lambda *a: ve.bias_epilogue_plain(a[0], a[1], form == "gelu", a[2])  # noqa: E731
        grads = []
        for f in (fn, plain):
            leaves = [None if t is None else t.clone().requires_grad_(i not in frozen)
                      for i, t in enumerate(args)]
            f(*leaves).backward(dy)
            grads.append([None if t is None else t.grad for t in leaves])
        for got, want in zip(*grads):
            assert (got is None) == (want is None)
            if got is not None:
                assert torch.equal(got, want)


def test_the_library_is_built_from_the_new_source(tmp_path, monkeypatch):
    """The kernels' source is one of the port's built sources; it includes
    no header of ``csrc/``, and an edit to it renames its library."""
    assert _build.SOURCES["vit_elementwise_sm90"] == "vit_elementwise_sm90.cu"
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    src = csrc / "vit_elementwise_sm90.cu"
    assert _build._INCLUDE.findall(src.read_text()) == []
    before = _build._target("vit_elementwise_sm90")
    assert before.name.startswith("libvit_elementwise_sm90_") and before.parent == _build.BUILD_DIR
    header = csrc / "sm90.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build._target("vit_elementwise_sm90") == before
    src.write_text(src.read_text() + "\n// edited\n")
    assert _build._target("vit_elementwise_sm90") != before


def test_no_kernel_name_is_read_as_another_family():
    """The source's kernels are the module's ``KERNELS``, and no name holds
    a string by which the benchmark's readers take a kernel for the
    port's flash, qmm or sqdist kernels or a library product: their time
    stays in ``elementwise_ms``."""
    text = (_build.CSRC / "vit_elementwise_sm90.cu").read_text()
    names = set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\(", text))
    assert names == set(ve.KERNELS)
    for name in names:
        assert not any(family in name for family in PORT_KERNELS + LIBRARY_GEMMS), name
