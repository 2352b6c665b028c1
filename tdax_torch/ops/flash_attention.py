"""Flash attention: the hand-written CUDA kernel and its plain version.

Counterpart of ``tdax/ops/flash_attention.py``.  The kernel
(``csrc/flash_fwd.cu``) replaces the Pallas TPU kernel
``tdax/ops/flash_attention.py::_kernel`` (reached there as ``mha`` ->
``_get_flash`` -> ``_build_flash`` -> ``_flash_impl`` -> ``_kernel``):
a tiled online-softmax forward with an additive key bias, an optional
causal mask with the tiles above the diagonal skipped, f32 running
max / denominator / accumulator, and no [Tq, Tk] tensor in device
memory.  On an H100 the tensor cores bound it at the ViT's shape and
memory at the decoder's and resampler's (see the note at the top of the
CUDA source for the bound and the design).

``mha`` is what the model calls.  On CPU tensors it takes the plain
PyTorch version (``flash_attention_plain``, which materializes the
[B, nh, Tq, Tk] f32 logits like tdax's ``_reference_mha``); on CUDA
tensors it launches the kernel through ``flash_attention`` or raises.
There is no fallback from one to the other.

``LAUNCHES`` counts kernel launches (one per successful launch, and
nowhere else), so a run can show that its attention went through the
kernel.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

NEG_INF = -1e30  # finite: a fully masked tile must not produce NaN

LAUNCHES = 0

_C_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 13
               + [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


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


def _reference_mha(q, k, v, additive) -> torch.Tensor:
    """Full [B, nh, Tq, Tk] f32 logits + softmax (tdax ``_reference_mha``):
    products accumulate in f32, the probabilities are cast to q's type
    before the PV product, the output is in q's type."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    logits = logits + additive
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float()).to(q.dtype)


def flash_attention_plain(q, k, v, bias, causal: bool) -> torch.Tensor:
    """Plain PyTorch version of the kernel's function: q [B, Tq, nh, hd],
    k/v [B, Tk, nh, hd], bias [B, Tk] f32 -> [B, Tq, nh, hd] in q.dtype."""
    tq, tk = q.shape[1], k.shape[1]
    additive = bias.to(torch.float32)[:, None, None, :]
    if causal:
        tril = torch.ones((tq, tk), dtype=torch.bool, device=q.device).tril()
        additive = additive + torch.where(tril, 0.0, NEG_INF)
    return _reference_mha(q, k, v, additive)


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


def _vectorizable(q, k, v) -> bool:
    """16-byte loads need hd, every stride and every base aligned to 8
    bf16 elements."""
    if q.dtype != torch.bfloat16:
        return False
    for x in (q, k, v):
        if x.shape[-1] % 8 or x.data_ptr() % 16 or any(s % 8 for s in x.stride()[:3]):
            return False
    return True


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


def flash_attention(q, k, v, bias, causal: bool) -> torch.Tensor:
    """Launch the CUDA flash-attention forward on CUDA tensors.

    q [B, Tq, nh, hd], k/v [B, Tk, nh, hd] (bf16 or f32, any strides
    with a contiguous last dimension), bias [B, Tk] f32 ->
    [B, Tq, nh, hd] in q.dtype, on the current stream.  Raises on any
    input the kernel does not take."""
    global LAUNCHES
    _check(q, k, v, bias)
    lib = _library()
    b, tq, nh, hd = q.shape
    tk = k.shape[1]
    out = torch.empty((b, tq, nh, hd), dtype=q.dtype, device=q.device)
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
            _DTYPE_CODE[q.dtype], int(_vectorizable(q, k, v)), stream)
    if rc != 0:
        msg = lib.tdax_cuda_error_string(rc).decode()
        raise RuntimeError(f"flash_attention: kernel launch failed: {msg} (cudaError {rc})")
    LAUNCHES += 1
    return out


def mha(q, k, v, spec: AttnSpec) -> torch.Tensor:
    """Multi-head attention used by the decoder, the ViT and the resampler.

    q [B, Tq, nh, hd], k/v [B, Tk, nh, hd] -> [B, Tq, nh, hd].  CPU
    tensors take the plain version; CUDA tensors take the kernel."""
    if not isinstance(spec, AttnSpec):
        raise TypeError("mha: the mask must be an AttnSpec")
    bias = spec.bias(q.shape[0], k.shape[1], q.device)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, bias, spec.causal)
    if q.device.type == "cuda":
        return flash_attention(q, k, v, bias, spec.causal)
    raise ValueError(f"mha: unsupported device {q.device}")
