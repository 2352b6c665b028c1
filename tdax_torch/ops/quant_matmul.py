"""Weight-only int8 matrix product: the hand-written CUDA kernels and their
plain version.

Counterpart of ``tdax/ops/quant_matmul.py``.  Two kernels replace the
Pallas TPU kernel ``_qmm_kernel`` (reached there as ``qdot`` ->
``quant_matmul`` -> ``_qmm_2d`` -> ``_qmm_kernel``): x [M, K] bf16 or f32
times an int8 weight q [K, N], the int8 -> x-type convert on chip, f32
accumulation, the per-output-channel scale s [N] f32 applied at the
single write, one cast to x's type.  ``csrc/qmm_sm90.cu`` (TMA, an
mbarrier ring, the conversion in shared memory, wgmma, a producer
warpgroup and two consumer warpgroups) takes bf16 products of at least
``SM90_MIN_M`` rows that TMA can read: every int8 product of the capture
and of ``generate``'s prefill but the ViT's patch embedding (K = 588).
``csrc/qmm_decode_sm90.cu`` (split K, a TMA ring of int8 tiles,
``mma.sync``, the splits summed in order by the last block of each column
tile) takes the same bf16 products at ``DECODE_MAX_M`` rows or fewer:
every product of a decode step and the prefill's LM head.  ``csrc/qmm.cu``
(``mma.sync``) takes the rest: f32, 65 to 127 rows, views TMA cannot
read.  ``_route`` decides from the type, shapes, strides and alignment
alone, before any launch.  On an H100 the tensor cores bound the product
at the capture's row counts and reading the int8 weight bounds it at
decode (see the notes at the top of the CUDA sources).

Where tdax takes the Pallas kernel only when asked (``TDAX_QMM=1`` on a
TPU, bf16, K and N multiples of 128), the port takes a kernel for every
int8 product on the card, at every shape: a shape neither takes raises,
a failed build or launch raises, and nothing reroutes it.

``quant_matmul_plain`` is the plain PyTorch version (tdax's XLA dequant
path and the Pallas kernel's function), used for CPU tensors only;
``quant_matmul`` launches a kernel on CUDA tensors or raises; ``qmm``
dispatches on the device.  ``LAUNCHES`` counts launches of every kernel,
``LAUNCHES_SM90`` and ``LAUNCHES_DECODE`` of each Hopper one alone (one
per successful launch, and nowhere else).

The product is differentiable in x as tdax's ``quant_matmul`` is (a
``jax.custom_vjp`` whose ``_qmm_bwd`` dequantizes the weight and takes
dy . (q s)^T outside the kernel): where grad mode is on and x requires
a gradient, ``qmm`` runs its dispatch inside ``QuantMatmul``, an
autograd Function with that backward on both devices.  The kernels
write through raw pointers, so without it a CUDA product would carry no
gradient at all.  Under ``inference_mode`` or ``no_grad`` (serving,
capture) ``qmm`` calls the dispatch as it is.

``int8_mm`` is W8A8's int8 x int8 -> int32 product (tdax computes it as
a plain ``dot_general`` outside any Pallas kernel): ``torch._int_mm``
on either device, exact.  ``LAUNCHES_INT8`` counts its products.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.utils.weak import WeakIdKeyDictionary

from tdax_torch.runtime import sm_count

LAUNCHES = 0
LAUNCHES_SM90 = 0
LAUNCHES_DECODE = 0
LAUNCHES_INT8 = 0

# the fewest rows qmm_sm90.cu takes (its blocks have 256); below it
# (decode, M = 16) qmm.cu's 16 x 32 tiling spreads the weight stream over
# more SMs
SM90_MIN_M = 128
# the most rows qmm_decode_sm90.cu takes (four m16 tiles of mma.sync);
# its blocks own 128 columns and K tiles of 128, at least
# DECODE_MIN_K_TILES of them a split, about DECODE_BLOCKS_PER_SM blocks an
# SM a product
DECODE_MAX_M = 64
DECODE_TILE = 128
DECODE_MIN_K_TILES = 4
DECODE_BLOCKS_PER_SM = 2

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


@functools.cache
def _decode_library() -> ctypes.CDLL:
    """The built decode-step kernel library, with its C signatures declared."""
    from tdax_torch.ops._build import load

    lib = load("qmm_decode_sm90")
    lib.tdax_qmm_decode_sm90.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                                         + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
                                         + [ctypes.c_void_p] * 3)
    lib.tdax_qmm_decode_sm90.restype = ctypes.c_int
    lib.tdax_qmm_decode_sm90_error_string.argtypes = [ctypes.c_int]
    lib.tdax_qmm_decode_sm90_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _sm90_library() -> ctypes.CDLL:
    """The built Hopper kernel library, with its C signatures declared."""
    from tdax_torch.ops._build import load

    lib = load("qmm_sm90")
    lib.tdax_qmm_sm90.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                                  + [ctypes.c_longlong, ctypes.c_void_p])
    lib.tdax_qmm_sm90.restype = ctypes.c_int
    lib.tdax_qmm_sm90_error_string.argtypes = [ctypes.c_int]
    lib.tdax_qmm_sm90_error_string.restype = ctypes.c_char_p
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


def _route(x2: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> str:
    """Which kernel takes x2 [M, K] @ q [K, N] * s: for bf16 that TMA can
    read (K, x2's row stride and N giving 16-byte strides: K % 8, ldx % 8,
    N % 16, no stride 0; the x2, q and s bases 16-byte aligned)
    ``"decode"`` at ``DECODE_MAX_M`` rows or fewer and ``"sm90"`` at
    ``SM90_MIN_M`` or more; ``"mma"`` for everything else."""
    if x2.dtype != torch.bfloat16 or x2.stride(1) != 1:
        return "mma"
    k, n = q.shape
    if k % 8 or n % 16 or x2.stride(0) % 8 or x2.stride(0) < k:
        return "mma"
    if any(t.data_ptr() % 16 for t in (x2, q, s)):
        return "mma"
    if x2.shape[0] <= DECODE_MAX_M:
        return "decode"
    return "sm90" if x2.shape[0] >= SM90_MIN_M else "mma"


@functools.cache
def _decode_split(k: int, n: int, sms: int) -> tuple[int, int]:
    """(K tiles a split, splits) of qmm_decode_sm90.cu for q [K, N] on a
    card of ``sms`` SMs: about ``DECODE_BLOCKS_PER_SM`` blocks an SM over
    the column tiles and splits, at least ``DECODE_MIN_K_TILES`` K tiles a
    split (or all of them), and no split empty."""
    k_tiles, n_tiles = -(-k // DECODE_TILE), -(-n // DECODE_TILE)
    per = max(DECODE_MIN_K_TILES, -(-k_tiles * n_tiles // (DECODE_BLOCKS_PER_SM * sms)))
    per = min(per, k_tiles)
    return per, -(-k_tiles // per)


# the decode kernel's scratch, per (device, stream), grown as needed: its
# splits' f32 partial sums, and int32 tickets that are zero between calls
# (the last block of each column tile resets its own).  Kept across calls:
# a decode step makes 161 products, and an allocation a call costs the
# host-bound step more than the kernel's few microseconds.
_WORKSPACE: dict = {}


def _workspace(device: torch.device, stream: int, parts: int,
               n_tiles: int) -> tuple[torch.Tensor, torch.Tensor]:
    key = (device.index, stream)
    part, ticket = _WORKSPACE.get(key, (None, None))
    if part is None or part.numel() < parts:
        part = torch.empty(parts, dtype=torch.float32, device=device)
    if ticket is None or ticket.numel() < n_tiles:
        ticket = torch.zeros(max(n_tiles, 2048), dtype=torch.int32, device=device)
    _WORKSPACE[key] = part, ticket
    return part, ticket


def _pick(x2: torch.Tensor, q: torch.Tensor, s: torch.Tensor, forced: str | None) -> str:
    """The route, or the private ``_kernel`` choice of the wrapper:
    ``"mma"`` always takes, ``"sm90"`` and ``"decode"`` only inputs the
    route sends there."""
    route = _route(x2, q, s)
    if forced not in (None, "mma", route):
        raise ValueError(f"quant_matmul: the {forced} kernel does not take these inputs")
    return forced or route


def quant_matmul(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor, *,
                 _kernel: str | None = None) -> torch.Tensor:
    """Launch a CUDA kernel: x [..., K] (bf16 or f32) @ q [K, N] int8
    * s [N] f32 -> [..., N] in x.dtype, on the current stream.  The
    leading dimensions of x collapse to M rows (a view where the strides
    allow, a copy where they do not, as for a broadcast view).  ``_route``
    picks the kernel; the private ``_kernel="mma"`` forces ``qmm.cu`` (to
    time and check it at the shapes the Hopper kernels take).  Raises on
    any input the kernel does not take."""
    global LAUNCHES, LAUNCHES_SM90, LAUNCHES_DECODE
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x2.stride(-1) != 1:
        x2 = x2.contiguous()
    _check(x2, q, s)
    route = _pick(x2, q, s, _kernel)
    m, k = x2.shape
    n = q.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    sm90 = route == "sm90"
    lib = {"sm90": _sm90_library, "decode": _decode_library, "mma": _library}[route]()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        args = (x2.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(), m, n, k, x2.stride(0))
        if route == "decode":
            per, splits = _decode_split(k, n, sm_count(x.device.index))
            part = ticket = None
            if splits > 1:
                part, ticket = _workspace(x.device, stream, splits * m * n,
                                          -(-n // DECODE_TILE))
            rc = lib.tdax_qmm_decode_sm90(*args, per, splits,
                                          None if part is None else part.data_ptr(),
                                          None if ticket is None else ticket.data_ptr(), stream)
            errors = lib.tdax_qmm_decode_sm90_error_string
        elif sm90:
            rc = lib.tdax_qmm_sm90(*args, stream)
            errors = lib.tdax_qmm_sm90_error_string
        else:
            vec = (x2.dtype == torch.bfloat16 and k % 8 == 0 and x2.stride(0) % 8 == 0
                   and n % 16 == 0 and x2.data_ptr() % 16 == 0 and q.data_ptr() % 16 == 0)
            rc = lib.tdax_qmm(*args, _DTYPE_CODE[x2.dtype], int(vec), stream)
            errors = lib.tdax_qmm_error_string
    if rc != 0:
        raise RuntimeError(f"quant_matmul ({route}): kernel launch failed: "
                           f"{errors(rc).decode()} (cudaError {rc})")
    LAUNCHES += 1
    LAUNCHES_SM90 += int(sm90)
    LAUNCHES_DECODE += int(route == "decode")
    return out.reshape(*lead, n)


def _dispatch(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return quant_matmul_plain(x, q, s)
    if x.device.type == "cuda":
        return quant_matmul(x, q, s)
    raise ValueError(f"qmm: unsupported device {x.device}")


class QuantMatmul(torch.autograd.Function):
    """``qmm``'s product with tdax's ``_qmm_bwd`` as its backward.

    Forward: the plain version on the CPU, the routed kernel on the card
    (one launch, counted as any).  Backward, on both devices: w = q . s
    in dy's type, dx = (dy @ w^T) in x's type, no gradient for q or s
    (the weights are frozen, as in tdax).  tdax takes that product with
    XLA outside any Pallas kernel; here it is ``torch.matmul``.  The
    dequantized weight is a transient of K x N in dy's type: 1.24 GB in
    bf16 for the LM head (4096 x 151936)."""

    @staticmethod
    def forward(ctx, x, q, s):
        ctx.save_for_backward(q, s)
        ctx.x_dtype = x.dtype
        return _dispatch(x, q, s)

    @staticmethod
    def backward(ctx, dy):
        q, s = ctx.saved_tensors
        w = q.to(dy.dtype) * s.to(dy.dtype)
        return torch.matmul(dy, w.t()).to(ctx.x_dtype), None, None


def qmm(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The plain version for CPU tensors, the kernel for CUDA tensors;
    through ``QuantMatmul`` when grad mode is on and x requires a
    gradient."""
    if torch.is_grad_enabled() and x.requires_grad:
        return QuantMatmul.apply(x, q, s)
    return _dispatch(x, q, s)


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _column_major(wq: torch.Tensor, kp: int, np_: int) -> torch.Tensor:
    """wq [K, N] as a zero-padded row-major [Np, Kp] tensor: wq's
    column-major form, the layout cuBLASLt's int8 kernels take."""
    bt = wq.new_zeros((np_, kp))
    bt[:wq.shape[1], :wq.shape[0]] = wq.t()
    return bt


# the column-major forms int8_mm_padded made, per root tensor of the
# weights they came from (a stacked [layers, K, N] weight or a single one):
# dropped with that tensor, made again after it is written to
_COLUMN_MAJOR = WeakIdKeyDictionary()


def _column_major_cached(wq: torch.Tensor, kp: int, np_: int) -> torch.Tensor:
    root = wq if wq._base is None else wq._base
    views = _COLUMN_MAJOR.setdefault(root, {})
    key = (wq.storage_offset(), tuple(wq.shape), wq.stride(), kp, np_)
    version, bt = views.get(key, (None, None))
    if version != wq._version:
        bt = _column_major(wq, kp, np_)
        views[key] = (wq._version, bt)
    return bt


def int8_mm_padded(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] @ int8 [K, N] -> the exact int32 [M, N] through
    ``torch._int_mm`` in the form the card's cuBLASLt takes: more than 16
    rows (M <= 16 padded to 32), K and N multiples of 8, and the weight
    column-major.  On an H100 a row-major weight runs 5-7x slower at the
    capture's shapes, and a column-major copy made at every call costs
    more than the product at decode (``chip_smoke.py``'s w8a8 phase), so
    the copy of each weight is made once and kept (``_COLUMN_MAJOR``:
    under W8A8 the card holds the int8 weights twice).  Zero rows and
    columns add nothing to an int32 sum, so the slice of the padded
    product is the product."""
    m, k = xq.shape
    n = wq.shape[1]
    mp = m if m > 16 else 32
    kp, np_ = _round_up(k, 8), _round_up(n, 8)
    if (mp, kp) != (m, k) or xq.stride(1) != 1:
        a = xq.new_zeros((mp, kp))
        a[:m, :k] = xq
    else:
        a = xq
    if (kp, np_) == (k, n) and wq.stride() == (1, k):
        bt = wq.t()  # already column-major
    else:
        bt = _column_major_cached(wq, kp, np_)
    return torch._int_mm(a, bt.t())[:m, :n]


def int8_mm(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] @ int8 [K, N] -> int32 [M, N], exact (|acc| <= K * 127^2
    stays below 2^31 for K < 133,000).  CPU tensors go to ``torch._int_mm``
    as they are; CUDA tensors through ``int8_mm_padded``.  A product
    cuBLASLt refuses raises; there is no other route."""
    global LAUNCHES_INT8
    if xq.dtype != torch.int8 or wq.dtype != torch.int8 or xq.dim() != 2 or wq.dim() != 2:
        raise TypeError(f"int8_mm: two 2-D int8 tensors expected, got {xq.dtype} "
                        f"{tuple(xq.shape)} and {wq.dtype} {tuple(wq.shape)}")
    if xq.shape[1] != wq.shape[0] or xq.device != wq.device:
        raise ValueError(f"int8_mm: {tuple(xq.shape)} @ {tuple(wq.shape)} on {xq.device}, "
                         f"{wq.device} do not match")
    if xq.device.type == "cpu":
        out = torch._int_mm(xq, wq)
    elif xq.device.type == "cuda":
        out = int8_mm_padded(xq, wq)
    else:
        raise ValueError(f"int8_mm: unsupported device {xq.device}")
    LAUNCHES_INT8 += 1
    return out
