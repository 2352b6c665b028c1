"""Flash attention: the hand-written CUDA kernels and their plain versions.

Counterpart of ``tdax/ops/flash_attention.py``.  Two forward kernels
replace the Pallas TPU kernel ``tdax/ops/flash_attention.py::_kernel``
(reached there as ``mha`` -> ``_get_flash`` -> ``_build_flash`` ->
``_flash_impl`` -> ``_kernel``): a tiled online-softmax forward with an
additive key bias, an optional causal mask with the tiles above the
diagonal skipped, f32 running max / denominator / accumulator, and no
[Tq, Tk] tensor in device memory.  ``csrc/flash_fwd_sm90.cu`` (TMA, an
mbarrier ring, wgmma, a producer warp and two consumer warpgroups) takes
bf16 inputs that TMA can read with at least ``SM90_MIN_TQ`` query rows;
``csrc/flash_decode_sm90.cu`` (split-KV over a block's half-warps, f32 on
the CUDA cores, the splits merged in the block) takes the same bf16
inputs at one query row, the decode step; ``csrc/flash_fwd.cu``
(``mma.sync``) takes the rest: f32, 2 to 63 query rows, hd not a
multiple of 8, misaligned views.  ``_route`` decides from the shapes,
strides and type alone, before any launch; a failed launch raises.  On
an H100 the tensor cores bound the forward at the ViT's shape and memory
at the decoder's, the resampler's and the decode step's (the notes at
the top of the CUDA sources give the bound and the designs).

Two pairs of backward kernels replace tdax's ``_bwd_dq_kernel`` and
``_bwd_dkv_kernel`` (driven by ``_flash_bwd_impl``): each recomputes p =
exp(s - lse) per tile from the forward's per-row log-normalizer, and
gives dq, or dk and dv.  ``csrc/flash_bwd_sm90.cu`` (TMA, an mbarrier
ring, wgmma, a producer warp and two consumer warpgroups) takes bf16
inputs that TMA can read with at least ``SM90_MIN_TQ`` query rows and
keys; ``csrc/flash_bwd.cu`` (``mma.sync`` bf16, FMA f32) the rest.
``_bwd_route`` decides as ``_route`` does.  ``FlashAttention`` is the
``torch.autograd.Function`` around them, the counterpart of tdax's
``custom_vjp`` in ``_build_flash``: its forward asks the forward kernel
for lse too, its backward computes delta = rowsum(dO * O) in f32 (tdax
does this outside the kernels, ``flash_attention.py:748-753``), then
launches the dq kernel, then the dk/dv kernel.  ``FlashAttentionLse``
(tdax's ``_build_flash_lse``) returns lse too and folds its cotangent
into the same kernels (delta' = delta - dlse): the ring attention's
per-step attention.

``mha`` is what the model calls.  On CPU tensors it takes the plain
PyTorch versions (``flash_attention_plain``, which materializes the
[B, nh, Tq, Tk] f32 logits like tdax's ``_reference_mha``, and
``flash_bwd_dq_plain`` / ``flash_bwd_dkv_plain``); on CUDA tensors it
launches the kernels or raises.  There is no fallback from one to the
other.  It goes through ``FlashAttention`` only when autograd needs it
(grad mode on and q, k or v requiring grad); under ``inference_mode``
the call is the plain forward launch.

``flash_sharding(mesh, batch_axis, head_axis, seq_axis)`` declares how
a multi-device run shards attention (tdax's context of that name).  In
the port each rank already holds its shard: q, k and v are its dp rows
and its tp heads, so ``mha`` runs the same route on them; the model's
row-parallel sites read the tp group from the context.  With
``seq_axis`` (context parallelism) they are also the rank's chunk of the
sequence, and ``mha`` runs the ring (``ring_attention``), each of its
steps on the kernels above.

``LAUNCHES`` (every forward kernel), ``LAUNCHES_SM90`` and
``LAUNCHES_DECODE`` (each Hopper one alone), ``BWD_DQ_LAUNCHES`` and
``BWD_DKV_LAUNCHES`` (both backward kernels of each pair) and
``BWD_DQ_LAUNCHES_SM90`` and ``BWD_DKV_LAUNCHES_SM90`` (the Hopper ones
alone) count kernel launches (one per successful launch, and nowhere
else), so a run can show that its attention and its gradients went
through the kernels, and which kernel carried each path.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math

import torch

from tdax_torch.runtime import sm_count

NEG_INF = -1e30  # finite: a fully masked tile must not produce NaN

LAUNCHES = 0
LAUNCHES_SM90 = 0
LAUNCHES_DECODE = 0
BWD_DQ_LAUNCHES = 0
BWD_DKV_LAUNCHES = 0
BWD_DQ_LAUNCHES_SM90 = 0
BWD_DKV_LAUNCHES_SM90 = 0

_C_TAIL = [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int]  # causal, scale, dtype, vec
_C_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 13
               + _C_TAIL + [ctypes.c_void_p, ctypes.c_void_p])  # lse, stream
_C_SM90_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 10
                    + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])
_C_DECODE_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 9
                      + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_int,
                         ctypes.c_void_p])
_C_BWD_DQ_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 16
                      + _C_TAIL + [ctypes.c_void_p])
_C_BWD_DKV_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 16
                       + _C_TAIL + [ctypes.c_void_p])
_C_BWD_SM90_TAIL = [ctypes.c_longlong] * 13 + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
_C_BWD_SM90_DQ_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + _C_BWD_SM90_TAIL
_C_BWD_SM90_DKV_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + _C_BWD_SM90_TAIL
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# fewest query rows for the Hopper kernels (and, in the backward, fewest
# keys): below it a 128-row block is mostly padding (the decode step has
# one row)
SM90_MIN_TQ = 64
# flash_decode_sm90.cu: keys a half-warp loads at once (its U), and the
# warps a block may have (one block per (batch, head))
DECODE_KEYS_AT_ONCE = 4
DECODE_WARPS = (4, 8, 16)


# Active (mesh, batch_axis, head_axis, seq_axis) of a multi-device run;
# a stack, so nested scopes restore.  Set by flash_sharding().
_SHARD_CTX: list[tuple] = []


@contextlib.contextmanager
def flash_sharding(mesh, batch_axis: str | None = "dp", head_axis: str | None = None,
                   seq_axis: str | None = None):
    """Declare how attention inputs are sharded over ``mesh``
    (``tdax_torch.parallel.mesh.make_mesh``): the batch over
    ``batch_axis``, the heads over ``head_axis``, and with ``seq_axis``
    (context parallelism) the sequence over that axis.  Each rank runs
    the flash kernels on its local q, k and v; the model's tp collectives
    (and the train step, which takes its mesh from here) run over
    ``head_axis``'s group.  Under ``seq_axis`` each rank holds its
    contiguous chunk of the sequence, and ``mha`` sends self-attention
    on it to the ring (``tdax_torch.ops.ring_attention``); sequence
    parallelism over tp is the train step's ``sp_mesh``."""
    _SHARD_CTX.append((mesh, batch_axis, head_axis, seq_axis))
    try:
        yield
    finally:
        _SHARD_CTX.pop()


def current_flash_sharding():
    return _SHARD_CTX[-1] if _SHARD_CTX else None


@contextlib.contextmanager
def without_seq_axis():
    """The active ``flash_sharding`` without its seq axis, while inside:
    attention that is not the sequence's (the visual tower's) runs whole
    on each rank under context parallelism."""
    ctx = current_flash_sharding()
    if ctx is None or ctx[3] is None:
        yield
        return
    with flash_sharding(*ctx[:3]):
        yield


class AttnSpec:
    """Structural attention mask: key-validity row + causal flag.

    ``kv_valid``: [B, Tk] bool/int tensor (1 = real token) or None
    (all keys valid).  ``causal``: Python bool."""

    __slots__ = ("kv_valid", "causal")

    def __init__(self, kv_valid: torch.Tensor | None = None, causal: bool = False):
        self.kv_valid = kv_valid
        self.causal = bool(causal)

    def bias(self, batch: int, tk: int, device) -> torch.Tensor:
        """[B, Tk] f32 additive key bias: 0 for a valid key, NEG_INF else."""
        if self.kv_valid is None:
            return torch.zeros((batch, tk), dtype=torch.float32, device=device)
        return torch.where(self.kv_valid > 0, 0.0, NEG_INF).to(torch.float32)


def _logits(q, k, additive) -> torch.Tensor:
    """[B, nh, Tq, Tk] f32: (q . k) * scale, then the additive mask."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    return logits + additive


def _reference_mha(q, k, v, additive) -> torch.Tensor:
    """Full [B, nh, Tq, Tk] f32 logits + softmax (tdax ``_reference_mha``):
    products accumulate in f32, the probabilities are cast to q's type
    before the PV product, the output is in q's type."""
    probs = torch.softmax(_logits(q, k, additive), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float()).to(q.dtype)


def _additive(bias, causal: bool, tq: int, tk: int) -> torch.Tensor:
    additive = bias.to(torch.float32)[:, None, None, :]
    if causal:
        tril = torch.ones((tq, tk), dtype=torch.bool, device=bias.device).tril()
        additive = additive + torch.where(tril, 0.0, NEG_INF)
    return additive


def flash_attention_plain(q, k, v, bias, causal: bool, return_lse: bool = False):
    """Plain PyTorch version of the forward kernel's function: q [B, Tq,
    nh, hd], k/v [B, Tk, nh, hd], bias [B, Tk] f32 -> [B, Tq, nh, hd] in
    q.dtype; with ``return_lse`` also the per-row log-normalizer [B, nh,
    Tq] f32, m + log(l) as tdax's kernel writes it, 0 on a row that sees
    no key (l == 0, or every score masked), whose output is then 0 where
    l == 0."""
    additive = _additive(bias, causal, q.shape[1], k.shape[1])
    if not return_lse:
        return _reference_mha(q, k, v, additive)
    logits = _logits(q, k, additive)
    m = logits.amax(dim=-1).clamp_min(NEG_INF)
    l = torch.exp(logits - m[..., None]).sum(dim=-1)
    empty = (l == 0) | (m <= NEG_INF)
    lse = torch.where(empty, 0.0, m + torch.log(torch.where(l == 0, 1.0, l)))
    probs = torch.softmax(logits, dim=-1).masked_fill((l == 0)[..., None], 0.0).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float()).to(q.dtype)
    return out, lse


def _probs_and_ds(q, k, v, bias, lse, delta, do, causal: bool):
    """p = exp(s - lse) and ds = p * (dO . v - delta) * scale, [B, nh, Tq,
    Tk] f32, as tdax's backward kernels compute them per tile."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.exp(_logits(q, k, _additive(bias, causal, q.shape[1], k.shape[1]))
                  - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dp - delta[..., None]) * scale


def flash_bwd_dq_plain(q, k, v, bias, lse, delta, do, causal: bool) -> torch.Tensor:
    """Plain version of the dq kernel (tdax ``_bwd_dq_kernel``): dq =
    bf16(ds) @ k summed in f32, in q.dtype."""
    _, ds = _probs_and_ds(q, k, v, bias, lse, delta, do, causal)
    return torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), k.float()).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, bias, lse, delta, do, causal: bool):
    """Plain version of the dk/dv kernel (tdax ``_bwd_dkv_kernel``): dv =
    bf16(p)^T @ dO and dk = bf16(ds)^T @ q, summed in f32, in q.dtype."""
    p, ds = _probs_and_ds(q, k, v, bias, lse, delta, do, causal)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float()).to(q.dtype)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float()).to(q.dtype)
    return dk, dv


def _check(q, k, v, bias) -> None:
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q/k/v must all be bfloat16 or all float32, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if bias.dtype != torch.float32:
        raise TypeError(f"flash_attention: bias must be float32, got {bias.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: expected q [B,Tq,nh,hd] and k = v [B,Tk,nh,hd], "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, tq, nh, hd = q.shape
    if k.shape[0] != b or k.shape[2] != nh or k.shape[3] != hd:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if tuple(bias.shape) != (b, k.shape[1]):
        raise ValueError(f"flash_attention: bias must be [B, Tk] = {(b, k.shape[1])}, "
                         f"got {tuple(bias.shape)}")
    if not 1 <= hd <= 128:
        raise ValueError(f"flash_attention: head_dim {hd} is outside 1..128")
    if min(b, tq, nh, k.shape[1]) < 1:
        raise ValueError("flash_attention: empty input")
    if b > 65535 or nh > 65535:  # grid (q tiles, heads, batch)
        raise ValueError(f"flash_attention: batch {b} or heads {nh} above 65535")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name}'s last dimension must be contiguous")
    if bias.stride(-1) != 1:
        raise ValueError("flash_attention: bias's last dimension must be contiguous")
    if not (q.is_cuda and k.device == q.device and v.device == q.device
            and bias.device == q.device):
        raise ValueError("flash_attention: q, k, v and bias must lie on one CUDA device, got "
                         f"{q.device}, {k.device}, {v.device}, {bias.device}")


def _check_bwd(q, k, v, bias, lse, delta, do) -> None:
    """Input checks first, then ``_check`` (whose device check is last)."""
    if do.dtype != q.dtype or do.shape != q.shape:
        raise ValueError(f"flash_attention backward: dO {tuple(do.shape)} {do.dtype} does not "
                         f"match q {tuple(q.shape)} {q.dtype}")
    if do.stride(-1) != 1:
        raise ValueError("flash_attention backward: dO's last dimension must be contiguous")
    rows = (q.shape[0], q.shape[2], q.shape[1])
    for name, x in (("lse", lse), ("delta", delta)):
        if x.dtype != torch.float32 or tuple(x.shape) != rows or not x.is_contiguous():
            raise ValueError(f"flash_attention backward: {name} must be contiguous float32 "
                             f"[B, nh, Tq] = {rows}, got {tuple(x.shape)} {x.dtype}")
        if x.device != q.device or do.device != q.device:
            raise ValueError(f"flash_attention backward: {name} and dO must lie on q's device")
    _check(q, k, v, bias)


def _vectorizable(*tensors) -> bool:
    """16-byte loads need hd, every stride and every base aligned to 8
    bf16 elements."""
    if tensors[0].dtype != torch.bfloat16:
        return False
    for x in tensors:
        if x.shape[-1] % 8 or x.data_ptr() % 16 or any(s % 8 for s in x.stride()[:3]):
            return False
    return True


def _route(q, k, v) -> str:
    """Which forward kernel takes these inputs: for bf16 q/k/v that the
    Hopper kernels read with 16-byte loads or TMA (``_vectorizable``: hd,
    the bases and the strides 16-byte aligned; no stride 0) ``"decode"``
    at one query row and ``"sm90"`` at ``SM90_MIN_TQ`` or more; ``"mma"``
    for everything else."""
    if not _vectorizable(q, k, v) or any(s == 0 for x in (q, k, v) for s in x.stride()[:3]):
        return "mma"
    if q.shape[1] == 1:
        return "decode"
    return "sm90" if q.shape[1] >= SM90_MIN_TQ else "mma"


@functools.cache
def _decode_warps(b: int, nh: int, tk: int, sms: int) -> int:
    """Warps a block of flash_decode_sm90.cu (one block per (batch, head),
    two key splits a warp): the fewest of ``DECODE_WARPS`` that give the
    card's ``sms`` SMs 8 warps of loads each, but no more than let every
    split load its keys in one group of ``DECODE_KEYS_AT_ONCE``."""
    warps = next((w for w in DECODE_WARPS if b * nh * w >= 8 * sms), DECODE_WARPS[-1])
    enough = next((w for w in DECODE_WARPS if 2 * w * DECODE_KEYS_AT_ONCE >= tk),
                  DECODE_WARPS[-1])
    return min(warps, enough)


def _bwd_route(q, k, v, do) -> str:
    """Which backward kernels take these inputs: ``"sm90"`` for bf16 q, k,
    v and dO that TMA can read (``_vectorizable``; no stride 0) with at
    least ``SM90_MIN_TQ`` query rows and keys, ``"mma"`` for everything
    else.  hd 104 (the ViT's) takes the Hopper kernels, zero-filled to 128
    columns."""
    if min(q.shape[1], k.shape[1]) < SM90_MIN_TQ or not _vectorizable(q, k, v, do):
        return "mma"
    if any(s == 0 for x in (q, k, v, do) for s in x.stride()[:3]):
        return "mma"
    return "sm90"


def _bwd_kernel(q, k, v, do, forced: str | None) -> str:
    """The route, or the private ``_kernel`` choice of the wrappers:
    ``"mma"`` always takes, ``"sm90"`` only inputs the route sends there."""
    route = _bwd_route(q, k, v, do)
    if forced not in (None, "mma", route):
        raise ValueError(f"flash backward: the {forced} kernel does not take these inputs")
    return forced or route


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library, with its C signatures declared."""
    from tdax_torch.ops._build import load

    lib = load("flash_fwd")
    lib.tdax_flash_fwd.argtypes = _C_ARGTYPES
    lib.tdax_flash_fwd.restype = ctypes.c_int
    lib.tdax_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tdax_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _sm90_library() -> ctypes.CDLL:
    """The built Hopper forward library, with its C signatures declared."""
    from tdax_torch.ops._build import load

    lib = load("flash_fwd_sm90")
    lib.tdax_flash_fwd_sm90.argtypes = _C_SM90_ARGTYPES
    lib.tdax_flash_fwd_sm90.restype = ctypes.c_int
    lib.tdax_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tdax_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _decode_library() -> ctypes.CDLL:
    """The built decode-step library, with its C signatures declared."""
    from tdax_torch.ops._build import load

    lib = load("flash_decode_sm90")
    lib.tdax_flash_decode_sm90.argtypes = _C_DECODE_ARGTYPES
    lib.tdax_flash_decode_sm90.restype = ctypes.c_int
    lib.tdax_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tdax_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _bwd_library() -> ctypes.CDLL:
    """The built backward library, with its C signatures declared."""
    from tdax_torch.ops._build import load

    lib = load("flash_bwd")
    lib.tdax_flash_bwd_dq.argtypes = _C_BWD_DQ_ARGTYPES
    lib.tdax_flash_bwd_dq.restype = ctypes.c_int
    lib.tdax_flash_bwd_dkv.argtypes = _C_BWD_DKV_ARGTYPES
    lib.tdax_flash_bwd_dkv.restype = ctypes.c_int
    lib.tdax_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tdax_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _bwd_sm90_library() -> ctypes.CDLL:
    """The built Hopper backward library, with its C signatures declared."""
    from tdax_torch.ops._build import load

    lib = load("flash_bwd_sm90")
    lib.tdax_flash_bwd_dq_sm90.argtypes = _C_BWD_SM90_DQ_ARGTYPES
    lib.tdax_flash_bwd_dq_sm90.restype = ctypes.c_int
    lib.tdax_flash_bwd_dkv_sm90.argtypes = _C_BWD_SM90_DKV_ARGTYPES
    lib.tdax_flash_bwd_dkv_sm90.restype = ctypes.c_int
    lib.tdax_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tdax_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(rc: int, lib, what: str) -> None:
    if rc != 0:
        msg = lib.tdax_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: kernel launch failed: {msg} (cudaError {rc})")


def _strides(*tensors) -> list:
    return [s for x in tensors for s in x.stride()[:3]]


def flash_attention(q, k, v, bias, causal: bool, return_lse: bool = False, *,
                    _kernel: str | None = None):
    """Launch the CUDA flash-attention forward on CUDA tensors.

    q [B, Tq, nh, hd], k/v [B, Tk, nh, hd] (bf16 or f32, any strides
    with a contiguous last dimension), bias [B, Tk] f32 ->
    [B, Tq, nh, hd] in q.dtype, on the current stream; with
    ``return_lse`` also lse [B, nh, Tq] f32 (see
    ``flash_attention_plain``).  ``_route`` picks the kernel; the private
    ``_kernel="mma"`` forces ``flash_fwd.cu`` (to time and check it at
    the shapes the Hopper kernels take).  Raises on any input the kernel
    does not take."""
    global LAUNCHES, LAUNCHES_SM90, LAUNCHES_DECODE
    _check(q, k, v, bias)
    route = _route(q, k, v)
    if _kernel not in (None, "mma", route):
        raise ValueError(f"flash_attention: the {_kernel} kernel does not take these inputs")
    route = _kernel or route
    b, tq, nh, hd = q.shape
    tk = k.shape[1]
    out = torch.empty((b, tq, nh, hd), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, nh, tq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    lse_ptr = None if lse is None else lse.data_ptr()
    if route == "decode":
        lib = _decode_library()
        warps = _decode_warps(b, nh, tk, sm_count(q.device.index))
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            rc = lib.tdax_flash_decode_sm90(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(),
                b, tk, nh, hd, q.stride(0), q.stride(2), *k.stride()[:3], *v.stride()[:3],
                bias.stride(0), int(causal), 1.0 / math.sqrt(hd), lse_ptr, warps, stream)
        _raise_on(rc, lib, "flash_attention (decode)")
        LAUNCHES += 1
        LAUNCHES_DECODE += 1
        return (out, lse) if return_lse else out
    if route == "sm90":
        lib = _sm90_library()
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            rc = lib.tdax_flash_fwd_sm90(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(),
                b, tq, tk, nh, hd, *_strides(q, k, v), bias.stride(0), int(causal),
                1.0 / math.sqrt(hd), lse_ptr, stream)
        _raise_on(rc, lib, "flash_attention (sm90)")
        LAUNCHES += 1
        LAUNCHES_SM90 += 1
        return (out, lse) if return_lse else out
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.tdax_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(),
            b, tq, tk, nh, hd,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            out.stride(0), out.stride(1), out.stride(2),
            bias.stride(0), int(causal), 1.0 / math.sqrt(hd),
            _DTYPE_CODE[q.dtype], int(_vectorizable(q, k, v)), lse_ptr, stream)
    _raise_on(rc, lib, "flash_attention")
    LAUNCHES += 1
    return (out, lse) if return_lse else out


def flash_bwd_dq(q, k, v, bias, lse, delta, do, causal: bool, *,
                 _kernel: str | None = None) -> torch.Tensor:
    """Launch the CUDA dq kernel: dq [B, Tq, nh, hd] in q.dtype, from q,
    k, v, bias as the forward took them, lse and delta [B, nh, Tq] f32
    and dO like q.  ``_bwd_route`` picks the kernel; the private
    ``_kernel="mma"`` forces ``flash_bwd.cu``.  Raises on any input the
    kernel does not take."""
    global BWD_DQ_LAUNCHES, BWD_DQ_LAUNCHES_SM90
    _check_bwd(q, k, v, bias, lse, delta, do)
    route = _bwd_kernel(q, k, v, do, _kernel)
    b, tq, nh, hd = q.shape
    dq = torch.empty((b, tq, nh, hd), dtype=q.dtype, device=q.device)
    sm90 = route == "sm90"
    lib = _bwd_sm90_library() if sm90 else _bwd_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), bias.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, tq, k.shape[1], nh, hd)
        if sm90:
            rc = lib.tdax_flash_bwd_dq_sm90(*args, *_strides(q, k, v, do), bias.stride(0),
                                            int(causal), 1.0 / math.sqrt(hd), stream)
        else:
            rc = lib.tdax_flash_bwd_dq(*args, *_strides(q, k, v, do, dq), bias.stride(0),
                                       int(causal), 1.0 / math.sqrt(hd), _DTYPE_CODE[q.dtype],
                                       int(_vectorizable(q, k, v, do)), stream)
    _raise_on(rc, lib, f"flash_bwd_dq ({route})")
    BWD_DQ_LAUNCHES += 1
    BWD_DQ_LAUNCHES_SM90 += int(sm90)
    return dq


def flash_bwd_dkv(q, k, v, bias, lse, delta, do, causal: bool, *, _kernel: str | None = None):
    """Launch the CUDA dk/dv kernel: (dk, dv), each [B, Tk, nh, hd] in
    q.dtype.  Inputs and ``_kernel`` as ``flash_bwd_dq``."""
    global BWD_DKV_LAUNCHES, BWD_DKV_LAUNCHES_SM90
    _check_bwd(q, k, v, bias, lse, delta, do)
    route = _bwd_kernel(q, k, v, do, _kernel)
    b, tq, nh, hd = q.shape
    tk = k.shape[1]
    dk = torch.empty((b, tk, nh, hd), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    sm90 = route == "sm90"
    lib = _bwd_sm90_library() if sm90 else _bwd_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), bias.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                b, tq, tk, nh, hd)
        if sm90:
            rc = lib.tdax_flash_bwd_dkv_sm90(*args, *_strides(q, k, v, do), bias.stride(0),
                                             int(causal), 1.0 / math.sqrt(hd), stream)
        else:
            rc = lib.tdax_flash_bwd_dkv(*args, *_strides(q, k, v, do, dk), bias.stride(0),
                                        int(causal), 1.0 / math.sqrt(hd), _DTYPE_CODE[q.dtype],
                                        int(_vectorizable(q, k, v, do)), stream)
    _raise_on(rc, lib, f"flash_bwd_dkv ({route})")
    BWD_DKV_LAUNCHES += 1
    BWD_DKV_LAUNCHES_SM90 += int(sm90)
    return dk, dv


def _forward_lse(ctx, q, k, v, bias, causal: bool):
    """(o, lse) of the forward kernel (the plain version on CPU tensors),
    both saved for the backward with q, k, v and the bias."""
    fwd = flash_attention if q.device.type == "cuda" else flash_attention_plain
    o, lse = fwd(q, k, v, bias, causal, return_lse=True)
    ctx.save_for_backward(q, k, v, bias, o, lse)
    ctx.causal = causal
    return o, lse


def _backward(ctx, do, dlse):
    """dq, dk, dv from the dq and dk/dv kernels (the plain versions on CPU
    tensors), with delta = rowsum(dO * O) - dlse: lse's cotangent folds
    into the kernels' per-row constant (tdax's ``_build_flash_lse``,
    ``flash_attention.py:767-810``)."""
    q, k, v, bias, o, lse = ctx.saved_tensors
    if do.stride(-1) != 1:
        do = do.contiguous()
    delta = (do.float() * o.float()).sum(dim=-1).transpose(1, 2)
    if dlse is not None:
        delta = delta - dlse.float()
    delta = delta.contiguous()
    if q.device.type == "cuda":
        dq = flash_bwd_dq(q, k, v, bias, lse, delta, do, ctx.causal)
        dk, dv = flash_bwd_dkv(q, k, v, bias, lse, delta, do, ctx.causal)
    else:
        dq = flash_bwd_dq_plain(q, k, v, bias, lse, delta, do, ctx.causal)
        dk, dv = flash_bwd_dkv_plain(q, k, v, bias, lse, delta, do, ctx.causal)
    return dq, dk, dv, None, None


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention: the forward kernel with lse, the
    dq and dk/dv kernels in the backward (plain versions on CPU
    tensors).  No gradient flows to the bias."""

    @staticmethod
    def forward(ctx, q, k, v, bias, causal: bool):
        return _forward_lse(ctx, q, k, v, bias, causal)[0]

    @staticmethod
    def backward(ctx, do):
        return _backward(ctx, do, None)


class FlashAttentionLse(torch.autograd.Function):
    """Differentiable ``(o, lse)``: tdax's ``_build_flash_lse``, whose
    per-chunk log-normalizer the ring's merge differentiates.  The same
    kernels as ``FlashAttention``; the backward runs them with delta' =
    rowsum(dO * O) - dlse (with p = exp(s - lse), d lse / d s = p, so
    lse's cotangent is a per-row constant beside delta; dv has no lse
    term).  The residual is the kernel's own lse, 0 on a row that sees
    no key, whose p = exp(s - 0) then vanishes; a caller that rewrites
    such rows (the ring, to NEG_INF) does so on the output, never on
    what the backward reads."""

    @staticmethod
    def forward(ctx, q, k, v, bias, causal: bool):
        return _forward_lse(ctx, q, k, v, bias, causal)

    @staticmethod
    def backward(ctx, do, dlse):
        return _backward(ctx, do, dlse)


def flash_attention_lse(q, k, v, bias, causal: bool):
    """(o [B, Tq, nh, hd] in q.dtype, lse [B, nh, Tq] f32): the forward
    kernel with its log-normalizer (the plain version on CPU tensors),
    through ``FlashAttentionLse`` when autograd will need its
    gradient."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionLse.apply(q, k, v, bias, causal)
    fwd = flash_attention if q.device.type == "cuda" else flash_attention_plain
    return fwd(q, k, v, bias, causal, return_lse=True)


def mha(q, k, v, spec: AttnSpec) -> torch.Tensor:
    """Multi-head attention used by the decoder, the ViT and the resampler.

    q [B, Tq, nh, hd], k/v [B, Tk, nh, hd] -> [B, Tq, nh, hd].  CPU
    tensors take the plain versions; CUDA tensors take the kernels.
    ``FlashAttention`` carries the call when autograd will need its
    gradient.  Under ``flash_sharding(..., seq_axis=...)`` q, k and v
    are this rank's chunk of the sequence and the call is the ring
    (``ring_attention``); tdax warns and attends replicated where the
    dimensions do not divide, but a rank here holds only its chunk, so
    anything but self-attention on it raises ValueError."""
    if not isinstance(spec, AttnSpec):
        raise TypeError("mha: the mask must be an AttnSpec")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"mha: unsupported device {q.device}")
    ctx = current_flash_sharding()
    if ctx is not None and ctx[3] is not None:
        mesh, b_ax, h_ax, s_ax = ctx
        if q.shape[1] != k.shape[1]:
            raise ValueError(f"mha: flash_sharding seq_axis={s_ax!r} takes self-attention on "
                             f"each rank's chunk; got Tq={q.shape[1]}, Tk={k.shape[1]}")
        from tdax_torch.ops.ring_attention import ring_attention
        return ring_attention(q, k, v, spec.kv_valid, spec.causal, mesh, b_ax, h_ax, s_ax)
    bias = spec.bias(q.shape[0], k.shape[1], q.device)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, bias, spec.causal)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, bias, spec.causal)
    return flash_attention(q, k, v, bias, spec.causal)
