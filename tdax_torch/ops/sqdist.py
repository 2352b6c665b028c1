"""Pairwise squared Euclidean distances: the hand-written CUDA kernel and
its plain version.

Counterpart of ``tdax/ops/pallas_distances.py``.  The kernel
(``csrc/sqdist.cu``) replaces the Pallas TPU kernel ``_sqdist_kernel``
(reached there as ``pairwise_euclidean_pallas`` ->
``pairwise_sq_euclidean_pallas`` -> ``_sqdist_kernel``): x [n, d] f32
-> [n, n] f32 ``max(|x_i|^2 + |x_j|^2 - 2 x_i.x_j, 0)``, the product
accumulated in true f32, the norms, clamp and store fused into the
epilogue.  The row norms are computed outside the kernel, as tdax
computes them outside its Pallas body.

``sqdist`` dispatches: CPU tensors take the plain PyTorch version
(``pairwise_sq_euclidean_plain``, the expansion form of
``ops/distances.py``), CUDA tensors launch the kernel
(``pairwise_sq_euclidean_cuda``) or raise.  There is no path from one to
the other.  ``euclidean`` is tdax's Euclidean wrapper on top: square
root, diagonal exactly 0.

``LAUNCHES`` counts kernel launches (one per successful launch, and
nowhere else), so a run can show that its distances went through the
kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tdax_torch.ops import distances

LAUNCHES = 0


def pairwise_sq_euclidean_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel's function: ``x @ x.T`` in
    f32 (TF32 off) plus the row norms, clamped at 0."""
    return distances.pairwise_sq_euclidean(x.to(torch.float32))


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library, with its C signatures declared."""
    from tdax_torch.ops._build import load

    lib = load("sqdist")
    lib.tdax_sqdist.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                                + [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_void_p])
    lib.tdax_sqdist.restype = ctypes.c_int
    lib.tdax_sqdist_error_string.argtypes = [ctypes.c_int]
    lib.tdax_sqdist_error_string.restype = ctypes.c_char_p
    return lib


def _check(x: torch.Tensor) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"pairwise_sq_euclidean_cuda: x must be float32, got {x.dtype}")
    if x.dim() != 2 or min(x.shape) < 1:
        raise ValueError(f"pairwise_sq_euclidean_cuda: expected x [n, d] with n, d >= 1, "
                         f"got {tuple(x.shape)}")
    if x.stride(1) != 1:
        raise ValueError("pairwise_sq_euclidean_cuda: x's last dimension must be contiguous")
    if x.shape[0] > 65535 * 128 or x.shape[1] > 2**31 - 1:
        raise ValueError(f"pairwise_sq_euclidean_cuda: x {tuple(x.shape)} is too large")
    if not x.is_cuda:
        raise ValueError(f"pairwise_sq_euclidean_cuda: x must lie on a CUDA device, got {x.device}")


def pairwise_sq_euclidean_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on x [n, d] f32 (any row stride, contiguous
    last dimension) -> [n, n] f32 on the current stream.  Raises on any
    input the kernel does not take."""
    global LAUNCHES
    _check(x)
    lib = _library()
    n, d = x.shape
    sq = (x * x).sum(1)
    out = torch.empty((n, n), dtype=torch.float32, device=x.device)
    vec = d % 4 == 0 and x.stride(0) % 4 == 0 and x.data_ptr() % 16 == 0
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.tdax_sqdist(x.data_ptr(), sq.data_ptr(), out.data_ptr(), n, d,
                             x.stride(0), out.stride(0), int(vec), stream)
    if rc != 0:
        msg = lib.tdax_sqdist_error_string(rc).decode()
        raise RuntimeError(f"pairwise_sq_euclidean_cuda: kernel launch failed: {msg} "
                           f"(cudaError {rc})")
    LAUNCHES += 1
    return out


def sqdist(x: torch.Tensor) -> torch.Tensor:
    """x [n, d] -> [n, n] squared distances: the plain version for CPU
    tensors, the kernel for CUDA tensors."""
    if x.device.type == "cpu":
        return pairwise_sq_euclidean_plain(x)
    if x.device.type == "cuda":
        return pairwise_sq_euclidean_cuda(x.to(torch.float32))
    raise ValueError(f"sqdist: unsupported device {x.device}")


def euclidean(x: torch.Tensor) -> torch.Tensor:
    """Euclidean distances [n, n] with the diagonal exactly 0 (tdax's
    ``pairwise_euclidean_pallas``); square root and diagonal in place."""
    d = sqdist(x).sqrt_()
    return d.fill_diagonal_(0.0)
