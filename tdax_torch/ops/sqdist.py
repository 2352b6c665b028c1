"""Pairwise squared Euclidean distances: the hand-written CUDA kernels and
their plain version.

Counterpart of ``tdax/ops/pallas_distances.py``.  Two kernels replace the
Pallas TPU kernel ``_sqdist_kernel`` (reached there as
``pairwise_euclidean_pallas`` -> ``pairwise_sq_euclidean_pallas`` ->
``_sqdist_kernel``): x [n, d] f32 -> [n, n] f32
``max(|x_i|^2 + |x_j|^2 - 2 x_i.x_j, 0)``, the norms, clamp and store
fused into the epilogue.

- ``csrc/sqdist_sm90.cu`` takes f32 x of any layout with at least
  ``SM90_MIN_N`` rows: a split pass (x, read in any row stride and from
  any base -> tf32 hi and lo, contiguous and zero-padded to d rounded up
  to 4, and the row norms in true f32) and a product on the tensor cores
  in 3xTF32 (hi.hi^T + hi.lo^T + lo.hi^T, f32 accumulators) over the
  tiles on and above the diagonal, each written to both places, so the
  output is exactly symmetric.  3xTF32 stands for tdax's ``Precision.HIGHEST`` within the
  port's unchanged bound, 1e-5 (|x_i|^2 + |x_j|^2).
- ``csrc/sqdist.cu`` takes fewer rows (and the private ``_kernel="fma"``):
  the product accumulated in true f32 on the CUDA cores, the row norms
  computed by the wrapper.

``_route`` decides from the row count alone, so an input's precision
does not hang on its layout: a strided or offset view takes the kernel
its contiguous copy takes, with the same bits.
``sqdist`` dispatches: CPU tensors take the plain PyTorch version
(``pairwise_sq_euclidean_plain``, the expansion form of
``ops/distances.py``), CUDA tensors launch the routed kernel
(``pairwise_sq_euclidean_cuda``) or raise.  There is no path from one to
the other.  ``euclidean`` is tdax's Euclidean wrapper on top: square
root, diagonal exactly 0.

``LAUNCHES`` counts launches of both product kernels, ``LAUNCHES_SM90``
of the Hopper one alone and ``SPLIT_LAUNCHES`` of its split pass (one per
successful launch, and nowhere else), so a run can show that its
distances went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tdax_torch.ops import distances

LAUNCHES = 0
LAUNCHES_SM90 = 0
SPLIT_LAUNCHES = 0

# the fewest rows sqdist_sm90.cu takes: one full 128 x 128 tile.  Below
# it both kernels run a single block, and sqdist.cu needs neither the
# split pass nor tensor maps
SM90_MIN_N = 128

_TF32_HALF, _TF32_MASK = 0x1000, ~0x1FFF  # half of tf32's last place; its 13 dropped bits


def pairwise_sq_euclidean_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernels' function: ``x @ x.T`` in
    f32 (TF32 off) plus the row norms, clamped at 0."""
    return distances.pairwise_sq_euclidean(x.to(torch.float32))


def _tf32_rna(v: torch.Tensor) -> torch.Tensor:
    """f32 -> tf32 as ``cvt.rna.tf32.f32`` rounds (to nearest, ties away
    from zero), on the bit patterns: add half of tf32's last place to the
    magnitude (a carry runs on into the exponent), clear the 13 dropped
    bits.  NaN stays NaN."""
    bits = v.contiguous().view(torch.int32)
    out = ((bits + _TF32_HALF) & _TF32_MASK).view(torch.float32)
    return torch.where(torch.isnan(v), v, out)


def tf32_split_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the split pass: x [n, d] f32 -> (hi, lo, sq) with
    hi = tf32(x), lo = tf32(x - hi) (the difference is exact), both
    contiguous f32 [n, dp] with the low 13 bits zero, dp = d rounded up
    to 4 (the pad columns zero), and sq [n] = |x_i|^2 in f32.
    |x - hi - lo| <= 2^-22 |x| for normal x."""
    x = x.to(torch.float32)
    hi = _tf32_rna(x)
    lo = _tf32_rna(x - hi)
    pad = -x.shape[1] % 4
    if pad:
        hi, lo = (torch.nn.functional.pad(t, (0, pad)) for t in (hi, lo))
    return hi, lo, (x * x).sum(1)


@functools.cache
def _library() -> ctypes.CDLL:
    """The built FMA kernel library, with its C signatures declared."""
    from tdax_torch.ops._build import load

    lib = load("sqdist")
    lib.tdax_sqdist.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                                + [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_void_p])
    lib.tdax_sqdist.restype = ctypes.c_int
    lib.tdax_sqdist_error_string.argtypes = [ctypes.c_int]
    lib.tdax_sqdist_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _sm90_library() -> ctypes.CDLL:
    """The built Hopper kernel library (split pass and product), with its
    C signatures declared."""
    from tdax_torch.ops._build import load

    lib = load("sqdist_sm90")
    lib.tdax_sqdist_split.argtypes = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                                       ctypes.c_int] + [ctypes.c_void_p] * 4)
    lib.tdax_sqdist_split.restype = ctypes.c_int
    lib.tdax_sqdist_sm90.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                                     + [ctypes.c_longlong, ctypes.c_void_p])
    lib.tdax_sqdist_sm90.restype = ctypes.c_int
    lib.tdax_sqdist_sm90_error_string.argtypes = [ctypes.c_int]
    lib.tdax_sqdist_sm90_error_string.restype = ctypes.c_char_p
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


def _route(x: torch.Tensor) -> str:
    """Which kernel takes x [n, d] f32: ``"sm90"`` with n >= ``SM90_MIN_N``
    rows, whatever the row stride, base or d (the split pass reads any
    layout), ``"fma"`` below."""
    return "sm90" if x.shape[0] >= SM90_MIN_N else "fma"


def _pick(x: torch.Tensor, forced: str | None) -> str:
    """The route, or the private ``_kernel`` choice of the wrapper:
    ``"fma"`` or ``"sm90"``, either for any input."""
    if forced not in (None, "fma", "sm90"):
        raise ValueError(f"pairwise_sq_euclidean_cuda: unknown kernel {forced!r}")
    return forced or _route(x)


def _raise(lib_errors, rc: int, what: str) -> None:
    raise RuntimeError(f"pairwise_sq_euclidean_cuda ({what}): kernel launch failed: "
                       f"{lib_errors(rc).decode()} (cudaError {rc})")


def tf32_split_cuda(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the split pass of ``sqdist_sm90.cu`` on x [n, d] f32 of any
    row stride and base -> (hi, lo, sq), as ``tf32_split_plain``; hi and
    lo [n, dp] (dp = d rounded up to 4) are the two halves of one [2, n,
    dp] allocation."""
    global SPLIT_LAUNCHES
    _check(x)
    lib = _sm90_library()
    n, d = x.shape
    hl = torch.empty((2, n, -(-d // 4) * 4), dtype=torch.float32, device=x.device)
    sq = torch.empty((n,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.tdax_sqdist_split(x.data_ptr(), x.stride(0), n, d, hl[0].data_ptr(),
                                   hl[1].data_ptr(), sq.data_ptr(), stream)
    if rc != 0:
        _raise(lib.tdax_sqdist_sm90_error_string, rc, "split")
    SPLIT_LAUNCHES += 1
    return hl[0], hl[1], sq


def sm90_product(hi: torch.Tensor, lo: torch.Tensor, sq: torch.Tensor) -> torch.Tensor:
    """Launch the product of ``sqdist_sm90.cu`` on the split pass's output
    (hi and lo [n, dp], zero-padded) -> [n, n] f32, contiguous.  The
    output's rows are padded to a multiple of 4 floats for TMA's 16-byte
    strides; where n % 4 != 0 the padded result is copied out."""
    global LAUNCHES, LAUNCHES_SM90
    if not (hi.dtype == lo.dtype == sq.dtype == torch.float32 and hi.dim() == 2
            and lo.shape == hi.shape and sq.shape == hi.shape[:1]
            and all(t.is_cuda and t.device == hi.device and t.is_contiguous()
                    for t in (hi, lo, sq))):
        raise ValueError("sm90_product: expected tf32_split_cuda's hi, lo [n, d] and sq [n], "
                         "contiguous f32 on one CUDA device")
    lib = _sm90_library()
    n, d = hi.shape
    ldo = -(-n // 4) * 4
    out = torch.empty((n, ldo), dtype=torch.float32, device=hi.device)
    with torch.cuda.device(hi.device):
        stream = torch.cuda.current_stream(hi.device).cuda_stream
        rc = lib.tdax_sqdist_sm90(hi.data_ptr(), lo.data_ptr(), sq.data_ptr(), out.data_ptr(),
                                  n, d, ldo, stream)
    if rc != 0:
        _raise(lib.tdax_sqdist_sm90_error_string, rc, "sm90")
    LAUNCHES += 1
    LAUNCHES_SM90 += 1
    return out if ldo == n else out[:, :n].contiguous()


def _fma(x: torch.Tensor) -> torch.Tensor:
    global LAUNCHES
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
        _raise(lib.tdax_sqdist_error_string, rc, "fma")
    LAUNCHES += 1
    return out


def pairwise_sq_euclidean_cuda(x: torch.Tensor, *, _kernel: str | None = None) -> torch.Tensor:
    """Launch a CUDA kernel on x [n, d] f32 (any row stride, contiguous
    last dimension) -> [n, n] f32 on the current stream.  ``_route``
    picks the kernel; the private ``_kernel="fma"`` forces ``sqdist.cu``
    and ``"sm90"`` the Hopper kernel (to check and time both on the same
    inputs).  Raises on any input the kernel does not take."""
    _check(x)
    if _pick(x, _kernel) == "sm90":
        return sm90_product(*tf32_split_cuda(x))
    return _fma(x)


def sqdist(x: torch.Tensor) -> torch.Tensor:
    """x [n, d] -> [n, n] squared distances: the plain version for CPU
    tensors, the routed kernel for CUDA tensors."""
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
