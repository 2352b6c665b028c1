"""Per-layer metrics, one reader per file, found by the metric's name.

Each module's ``read(ctx)`` returns the metric's value from a traced
window, or None where the window holds nothing for it to read (the
harness then leaves the metric out of the line).  ``ctx`` carries
``trace`` (``benchmark.trace.Trace``), ``work`` (``benchmark.work.Work``,
what one unit asks of the card) and ``units`` (the units traced).

Kernel families are named here once; a reader lists the names it reads.
A reader of one of the port's ``tdax.*`` spans names the span
(``span_ms``).
"""

# the port's own kernels (tdax_torch/ops/csrc), by the names they launch as
PORT_KERNELS = ("flash_", "bwd_dq", "bwd_dkv", "qmm_", "sqdist")
# library matrix products (cuBLAS, cuBLASLt, CUTLASS)
LIBRARY_GEMMS = ("gemm", "nvjet", "cutlass", "xmma")


def span_ms(ctx, span: str):
    """Device time a unit of the kernels that belong to the port's
    ``tdax.<span>`` ranges (``Trace.span_kernel_s``), in ms; None where
    the window holds none."""
    if ctx.units <= 0:
        return None
    s = ctx.trace.span_kernel_s(span)
    return 1e3 * s / ctx.units if s > 0 else None
