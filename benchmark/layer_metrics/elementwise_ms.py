"""elementwise_ms (ms a unit): device time of the kernels that are
neither the port's nor a library's matrix products, outside
``Optimizer.step``: PyTorch's eager passes (norms, activations, rotary,
casts, adds, the clip, the loss)."""

from benchmark.layer_metrics import LIBRARY_GEMMS, PORT_KERNELS


def read(ctx):
    if ctx.units <= 0:
        return None
    s = ctx.trace.kernel_s(None, optimizer=False, exclude=PORT_KERNELS + LIBRARY_GEMMS)
    return 1e3 * s / ctx.units if s > 0 else None
