"""Device choice for the port's entry points.

Counterpart of ``tdax/utils/runtime.py``.  The port runs on the card:
``get_device()`` returns ``cuda`` when one is present and raises when
none is, so a run never carries on quietly on the CPU.  The CPU is
used only when the caller asks for it (``device="cpu"``, as the tests
do).

Float32 means true float32 here, as tdax pins ``Precision.HIGHEST`` for
f32 (``tdax/ops/flash_attention.py:263-266``): TF32 is switched off for
matrix products and convolutions, and bf16 products accumulate in f32
without cuBLAS's reduced-precision split-K reductions (tdax's
``qdot`` accumulates in f32 before its single cast).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _set_precision() -> None:
    """Process-wide numerics switches the port depends on."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def as_device_f32(x, device=None) -> torch.Tensor:
    """``x`` as a float32 tensor on the device it runs on: a tensor stays
    where it lies (a cloud born on the card makes no host round trip)
    unless ``device`` says otherwise; anything else goes to
    ``get_device(device)``, the card unless the caller asks for the CPU."""
    if isinstance(x, torch.Tensor) and device is None:
        return x.to(torch.float32)
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
    return torch.as_tensor(x, dtype=torch.float32).to(get_device(device))


@functools.cache
def sm_count(index: int) -> int:
    """The streaming multiprocessors of CUDA device ``index`` (the decode
    kernels size their grids by it)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def get_device(device: str | torch.device | None = None) -> torch.device:
    """``cuda`` by default; ``cpu`` only when asked for explicitly.

    Raises RuntimeError when no card is present and the caller did not
    ask for the CPU."""
    _set_precision()
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "tdax_torch: no CUDA device is available; pass device='cpu' "
                "to run on the CPU")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"tdax_torch: {device} requested but CUDA is not available")
    return device
