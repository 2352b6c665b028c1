"""step_mfu (%): the model FLOPs of the traced units (``benchmark.work``:
no recompute credited) over the traced window's time and the card's bf16
peak."""

from benchmark.roofline import BF16_PEAK


def read(ctx):
    if ctx.units <= 0 or ctx.trace.window_s <= 0 or ctx.trace.busy_s() <= 0:
        return None
    return 100.0 * ctx.work.flops * ctx.units / ctx.trace.window_s / BF16_PEAK
