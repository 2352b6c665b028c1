"""Weight-only int8 matrix product: the hand-written CUDA kernel and its
plain version.

Counterpart of ``tdax/ops/quant_matmul.py``.  The kernel
(``csrc/qmm.cu``) replaces the Pallas TPU kernel ``_qmm_kernel``
(reached there as ``qdot`` -> ``quant_matmul`` -> ``_qmm_2d`` ->
``_qmm_kernel``): x [M, K] bf16 or f32 times an int8 weight q [K, N],
the int8 -> x-type convert inside the K loop, f32 accumulation, the
per-output-channel scale s [N] f32 applied at the single write, one
cast to x's type.  On an H100 the tensor cores bound it at the
capture's row counts and reading the int8 weight bounds it at decode
(see the note at the top of the CUDA source).

Where tdax takes the Pallas kernel only when asked (``TDAX_QMM=1`` on a
TPU, bf16, K and N multiples of 128), the port takes its kernel for
every int8 product on the card, at every shape: a shape it does not
take raises, and nothing reroutes it.

``quant_matmul_plain`` is the plain PyTorch version (tdax's XLA dequant
path and the Pallas kernel's function), used for CPU tensors only;
``quant_matmul`` launches the kernel on CUDA tensors or raises; ``qmm``
dispatches on the device.  ``LAUNCHES`` counts kernel launches (one per
successful launch, and nowhere else).
"""

from __future__ import annotations

import ctypes
import functools

import torch

LAUNCHES = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def quant_matmul_plain(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """[..., K] @ int8 [K, N] * s [N] -> [..., N] in x.dtype: the exact
    product in f32, then the scale, then one cast."""
    return ((x.float() @ q.float()) * s).to(x.dtype)


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library, with its C signatures declared."""
    from tdax_torch.ops._build import load

    lib = load("qmm")
    lib.tdax_qmm.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                             + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    lib.tdax_qmm.restype = ctypes.c_int
    lib.tdax_qmm_error_string.argtypes = [ctypes.c_int]
    lib.tdax_qmm_error_string.restype = ctypes.c_char_p
    return lib


def _check(x2: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> None:
    if x2.dtype not in _DTYPE_CODE:
        raise TypeError(f"quant_matmul: x must be bfloat16 or float32, got {x2.dtype}")
    if q.dtype != torch.int8 or q.dim() != 2:
        raise TypeError(f"quant_matmul: q must be a 2-D int8 tensor, got {q.dtype} "
                        f"{tuple(q.shape)}")
    if s.dtype != torch.float32 or s.dim() != 1:
        raise TypeError(f"quant_matmul: s must be a 1-D float32 tensor, got {s.dtype} "
                        f"{tuple(s.shape)}")
    m, k = x2.shape
    if q.shape[0] != k or s.shape[0] != q.shape[1]:
        raise ValueError(f"quant_matmul: x [.., {k}], q {tuple(q.shape)} and s {tuple(s.shape)} "
                         f"do not match")
    if min(m, k, q.shape[1]) < 1:
        raise ValueError("quant_matmul: empty input")
    if max(m, k, q.shape[1]) > 2**31 - 1 or m > 65535 * 16:
        raise ValueError(f"quant_matmul: [{m}, {k}] x {tuple(q.shape)} is too large")
    if x2.stride(1) != 1 or not q.is_contiguous() or not s.is_contiguous():
        raise ValueError("quant_matmul: x needs contiguous rows, q and s must be contiguous")
    if not (x2.is_cuda and q.device == x2.device and s.device == x2.device):
        raise ValueError("quant_matmul: x, q and s must lie on one CUDA device, got "
                         f"{x2.device}, {q.device}, {s.device}")


def quant_matmul(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel: x [..., K] (bf16 or f32) @ q [K, N] int8
    * s [N] f32 -> [..., N] in x.dtype, on the current stream.  The
    leading dimensions of x collapse to M rows (a view where the strides
    allow, a copy where they do not, as for a broadcast view).  Raises on
    any input the kernel does not take."""
    global LAUNCHES
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x2.stride(-1) != 1:
        x2 = x2.contiguous()
    _check(x2, q, s)
    lib = _library()
    m, k = x2.shape
    n = q.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    vec = (x2.dtype == torch.bfloat16 and k % 8 == 0 and x2.stride(0) % 8 == 0 and n % 16 == 0
           and x2.data_ptr() % 16 == 0 and q.data_ptr() % 16 == 0)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.tdax_qmm(x2.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(), m, n, k,
                          x2.stride(0), _DTYPE_CODE[x2.dtype], int(vec), stream)
    if rc != 0:
        msg = lib.tdax_qmm_error_string(rc).decode()
        raise RuntimeError(f"quant_matmul: kernel launch failed: {msg} (cudaError {rc})")
    LAUNCHES += 1
    return out.reshape(*lead, n)


def qmm(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The plain version for CPU tensors, the kernel for CUDA tensors."""
    if x.device.type == "cpu":
        return quant_matmul_plain(x, q, s)
    if x.device.type == "cuda":
        return quant_matmul(x, q, s)
    raise ValueError(f"qmm: unsupported device {x.device}")
