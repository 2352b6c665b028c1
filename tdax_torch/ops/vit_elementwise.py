"""The visual tower's elementwise passes: LayerNorm, and the bias, tanh-GELU
and residual epilogue of its products, as hand-written CUDA kernels with
their plain versions.

tdax has no Pallas kernel here: ``tdax/models/qwen_vl/vit.py`` writes
these passes as jnp expressions and XLA fuses them on the TPU.  Run
eagerly, each operation of those expressions is a pass of its own over
device memory (an f32 upcast, two means, a square, an rsqrt, casts, the
scale and the shift of a LayerNorm; the bias add, the GELU's two casts):
the 48 blocks of ViT-bigG move ~354 GB a capture batch of 16 images that
way, where ``csrc/vit_elementwise_sm90.cu`` moves ~68 GB.

- ``layer_norm``: tdax's layer norm (population variance, normalized in
  f32, cast to x's type, *then* ``* w + b`` in that type);
  ``vit_ln_rows`` reads each row of x once and writes it once, and sums
  in the order of PyTorch's CUDA reduce, so its bits are the plain
  version's on the card.
- ``bias_epilogue_``: ``p + b``, ``gelu_tanh(p + b)`` or ``residual + (p
  + b)`` with the plain version's roundings (bitwise on the bias and
  residual forms), written over p, the product's fresh output, on every
  device where no gradient is needed.

``layer_norm_plain``, ``gelu_tanh`` and ``bias_epilogue_plain`` are the
plain versions (the expressions ``vit.py`` wrote), used for CPU tensors.
``_route`` reads the device alone: a CUDA tensor launches a kernel or
raises.  The kernels take rows of whole 16-byte vectors that start on
16-byte boundaries (every width of ViT-bigG and of its tp shards); a
type, shape, layout or device they do not take raises, a failed build or
launch raises, and nothing reroutes it.

Where grad mode is on and an input requires a gradient, the kernel runs
inside an autograd Function that saves the inputs; its backward replays
the plain version on them and differentiates it, so the gradients are
the plain chain's (training through the tower keeps its numbers).
``LAUNCHES_LN`` and ``LAUNCHES_EPILOGUE`` count successful launches
(a capture batch: 2 LayerNorms and 4 epilogues a block, plus ``ln_pre``,
the resampler's two norms and four bias adds, and ``ln_post``).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from tdax_torch.runtime import sm_count

LAUNCHES_LN = 0
LAUNCHES_EPILOGUE = 0

# the kernels' names as they launch (the benchmark's elementwise time
# holds every kernel whose name has none of its families' strings)
KERNELS = ("vit_ln_rows", "vit_bias_epilogue")

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# elements in a 16-byte vector
_VEC = {torch.float32: 4, torch.bfloat16: 8}
# vit_ln_rows: a block stashes its rows in at most LN_STASH_BYTES of
# shared memory
LN_STASH_BYTES = 48 << 10
# vit_bias_epilogue: blocks of 256 threads, at most 8 an SM
EPILOGUE_THREADS = 256
EPILOGUE_BLOCKS_PER_SM = 8
_MODES = {"bias": 0, "gelu": 1, "residual": 2}


def layer_norm_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)  # population variance
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * w + b


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (approximate=True) in f32, cast back."""
    return F.gelu(x.float(), approximate="tanh").to(x.dtype)


def bias_epilogue_plain(p: torch.Tensor, b: torch.Tensor, gelu: bool = False,
                        residual: torch.Tensor | None = None) -> torch.Tensor:
    h = p + b
    if gelu:
        h = gelu_tanh(h)
    return h if residual is None else residual + h


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library, with its C signatures declared."""
    from tdax_torch.ops._build import load

    lib = load("vit_elementwise_sm90")
    lib.tdax_vit_ln_rows.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                                     + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 2
                                     + [ctypes.c_float] * 2 + [ctypes.c_int]
                                     + [ctypes.c_void_p])
    lib.tdax_vit_ln_rows.restype = ctypes.c_int
    lib.tdax_vit_bias_epilogue.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                                           + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 3
                                           + [ctypes.c_void_p])
    lib.tdax_vit_bias_epilogue.restype = ctypes.c_int
    lib.tdax_vit_elementwise_error_string.argtypes = [ctypes.c_int]
    lib.tdax_vit_elementwise_error_string.restype = ctypes.c_char_p
    return lib


def _route(*tensors: torch.Tensor) -> str:
    """Which version takes these tensors: ``"plain"`` on the CPU, else
    ``"kernel"`` (which launches or raises)."""
    return "plain" if tensors[0].device.type == "cpu" else "kernel"


def _whole_vectors(*tensors: torch.Tensor) -> bool:
    """Whether every row of every tensor (the first [..., C], the rest
    [..., C] or [C]) is whole 16-byte vectors on a 16-byte boundary: C a
    whole number of vectors, unit last stride, the other strides whole
    vectors, the bases aligned."""
    vec = _VEC.get(tensors[0].dtype, 1)
    return tensors[0].shape[-1] % vec == 0 and all(
        t.stride(-1) == 1 and t.data_ptr() % 16 == 0
        and all(s % vec == 0 for s in t.stride()[:-1]) for t in tensors)


def _reduce_shape(rows: int, cols: int) -> tuple[int, bool]:
    """(threads a row, vectorized) of PyTorch's CUDA reduce for the mean
    over the last dimension of an f32 [rows, cols] (ATen's
    ``Reduce.cuh::setReduceConfig`` with 512 threads a block): rows of 128
    or more are read in vectors of four; the block's width runs along a
    row, a warp where there are 16 rows or more.  vit_ln_rows sums in
    that order.  Raises where PyTorch would split a row across warps or
    blocks (rows of ~8192 or more), which the kernel does not follow."""
    vectorized = cols >= 128
    width = min(_last_pow2(cols // 4 if vectorized else cols), 512)
    height = min(_last_pow2(rows), 512 // min(width, 32))
    lanes = min(width, 512 // height)
    if -(-cols // lanes) >= min(16 * height, 256):
        raise ValueError(f"layer_norm: PyTorch sums rows of {cols} elements across warps "
                         f"({rows} rows), in an order vit_ln_rows does not follow")
    return lanes, vectorized


def _last_pow2(n: int) -> int:
    return 1 << (n.bit_length() - 1)


def _rows(t: torch.Tensor) -> torch.Tensor:
    """t [..., C] as [R, C] with unit column stride (a view where the
    strides allow)."""
    t2 = t.reshape(-1, t.shape[-1])
    return t2 if t2.stride(-1) == 1 else t2.contiguous()


def _check(name: str, lead: torch.Tensor, vectors, same_shape=(), out=None) -> None:
    """``lead`` [R, C] on a CUDA device; ``vectors`` [C] and ``same_shape``
    [R, C] beside it, all of one type the kernels take, and with ``out``
    all of them rows of whole 16-byte vectors."""
    tensors = (lead, *vectors, *same_shape)
    if lead.dtype not in _DTYPE_CODE or any(t.dtype != lead.dtype for t in tensors):
        raise TypeError(f"{name}: inputs must all be bfloat16 or all float32, got "
                        f"{[t.dtype for t in tensors]}")
    rows, cols = lead.shape
    if any(t.shape != (cols,) for t in vectors) or any(t.shape != lead.shape for t in same_shape):
        raise ValueError(f"{name}: shapes {[tuple(t.shape) for t in tensors]} do not match")
    if rows < 1 or cols < 1:
        raise ValueError(f"{name}: empty input")
    if max(rows, cols) > 2**31 - 1:
        raise ValueError(f"{name}: [{rows}, {cols}] is too large")
    if not _whole_vectors(*tensors, *(() if out is None else (out,))):
        raise ValueError(f"{name}: rows must be whole 16-byte vectors on 16-byte boundaries, "
                         f"got shapes {[tuple(t.shape) for t in tensors]} and strides "
                         f"{[t.stride() for t in tensors]}")
    if not all(t.is_cuda and t.device == lead.device for t in tensors):
        raise ValueError(f"{name}: inputs must lie on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")


def _raise_if_failed(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed: "
                           f"{_library().tdax_vit_elementwise_error_string(rc).decode()} "
                           f"(cudaError {rc})")


def layer_norm_cuda(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    """Launch vit_ln_rows: x [..., C] (bf16 or f32) with w and b [C] of its
    type -> a new [..., C] tensor, on the current stream."""
    global LAUNCHES_LN
    x2, w, b = _rows(x), w.contiguous(), b.contiguous()
    _check("layer_norm", x2, (w, b))
    rows, cols = x2.shape
    if cols * x.element_size() > LN_STASH_BYTES:
        raise ValueError(f"layer_norm: rows of {cols} elements are wider than the kernel "
                         f"stashes ({LN_STASH_BYTES} bytes)")
    lanes, vectorized = _reduce_shape(rows, cols)
    out = torch.empty((rows, cols), dtype=x.dtype, device=x.device)
    # PyTorch's mean scales its f32 sum by (outputs / elements) in f32
    factor = float(np.float32(rows) / np.float32(rows * cols))
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.tdax_vit_ln_rows(x2.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                                  rows, cols, x2.stride(0), cols, lanes, int(vectorized),
                                  factor, eps, _DTYPE_CODE[x.dtype], stream)
    _raise_if_failed(rc, "layer_norm")
    LAUNCHES_LN += 1
    return out.reshape(x.shape)


def bias_epilogue_cuda(p: torch.Tensor, b: torch.Tensor, gelu: bool = False,
                       residual: torch.Tensor | None = None,
                       in_place: bool = False) -> torch.Tensor:
    """Launch vit_bias_epilogue: p [..., N] with b [N] (and residual
    [..., N]) of one type -> ``bias_epilogue_plain``'s value, written over
    p (which must view as rows) and returned as p with ``in_place``, else
    into a new tensor."""
    global LAUNCHES_EPILOGUE
    if gelu and residual is not None:
        raise ValueError("bias_epilogue: the GELU and the residual add are separate forms")
    mode = "gelu" if gelu else ("residual" if residual is not None else "bias")
    p2, b = (p.view(-1, p.shape[-1]) if in_place else _rows(p)), b.contiguous()
    r2 = None if residual is None else _rows(residual)
    o2 = p2 if in_place else torch.empty(p2.shape, dtype=p.dtype, device=p.device)
    _check("bias_epilogue", p2, (b,), () if r2 is None else (r2,), out=o2)
    rows, cols = p2.shape
    vectors = rows * cols // _VEC[p.dtype]
    blocks = min(-(-vectors // EPILOGUE_THREADS),
                 EPILOGUE_BLOCKS_PER_SM * sm_count(p.device.index))
    lib = _library()
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        rc = lib.tdax_vit_bias_epilogue(p2.data_ptr(), b.data_ptr(),
                                        None if r2 is None else r2.data_ptr(), o2.data_ptr(),
                                        rows, cols, p2.stride(0),
                                        0 if r2 is None else r2.stride(0), o2.stride(0),
                                        _MODES[mode], _DTYPE_CODE[p.dtype], blocks, stream)
    _raise_if_failed(rc, "bias_epilogue")
    LAUNCHES_EPILOGUE += 1
    return p if in_place else o2.reshape(p.shape)


def _replay(ctx, plain, dy: torch.Tensor) -> tuple:
    """The gradients of ``plain`` at the saved inputs (None for those that
    need none), for ``dy``."""
    with torch.enable_grad():
        inputs = [None if t is None else t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [t for t in inputs if t is not None and t.requires_grad]
        grads = iter(torch.autograd.grad(plain(*inputs), wanted, dy))
    return tuple(next(grads) if t is not None and t.requires_grad else None for t in inputs)


class _LayerNorm(torch.autograd.Function):
    """Forward: vit_ln_rows.  Backward: the plain chain, replayed on the
    saved x, w and b and differentiated."""

    @staticmethod
    def forward(ctx, x, w, b, eps):
        ctx.save_for_backward(x, w, b)
        ctx.eps = eps
        return layer_norm_cuda(x, w, b, eps)

    @staticmethod
    def backward(ctx, dy):
        return _replay(ctx, lambda x, w, b: layer_norm_plain(x, w, b, ctx.eps), dy) + (None,)


class _BiasEpilogue(torch.autograd.Function):
    """Forward: vit_bias_epilogue into a new tensor.  Backward: the plain
    chain, replayed on the saved p, b and residual and differentiated."""

    @staticmethod
    def forward(ctx, p, b, residual, gelu):
        ctx.save_for_backward(p, b, residual)
        ctx.gelu = gelu
        return bias_epilogue_cuda(p, b, gelu, residual)

    @staticmethod
    def backward(ctx, dy):
        return _replay(ctx, lambda p, b, r: bias_epilogue_plain(p, b, ctx.gelu, r), dy) + (None,)


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    """tdax's layer norm over the last dimension: the plain version for CPU
    tensors, vit_ln_rows for CUDA tensors (through ``_LayerNorm`` where a
    gradient is needed)."""
    if _route(x, w, b) == "plain":
        return layer_norm_plain(x, w, b, eps)
    if _needs_grad(x, w, b):
        return _LayerNorm.apply(x, w, b, eps)
    return layer_norm_cuda(x, w, b, eps)


def bias_epilogue_(p: torch.Tensor, b: torch.Tensor, *, gelu: bool = False,
                   residual: torch.Tensor | None = None) -> torch.Tensor:
    """``p + b``, ``gelu_tanh(p + b)`` or ``residual + (p + b)``, in place:
    where no gradient is needed the result is written over p (a product's
    fresh output) and p is returned, on every device; where one is, p is
    left to autograd and the result is a new tensor.  The plain version
    computes it for CPU tensors, vit_bias_epilogue for CUDA tensors
    (through ``_BiasEpilogue`` where a gradient is needed)."""
    if _needs_grad(p, b, residual):
        if _route(p, b) == "plain":
            return bias_epilogue_plain(p, b, gelu, residual)
        return _BiasEpilogue.apply(p, b, residual, gelu)
    if _route(p, b) == "plain":
        return p.copy_(bias_epilogue_plain(p, b, gelu, residual))
    return bias_epilogue_cuda(p, b, gelu, residual, in_place=True)
