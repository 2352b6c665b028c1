"""clip_ms (ms a unit): device time of the kernels launched inside the
port's ``tdax.clip`` range (the global-norm clip before AdamW's step)."""

from benchmark.layer_metrics import span_ms


def read(ctx):
    return span_ms(ctx, "clip")
