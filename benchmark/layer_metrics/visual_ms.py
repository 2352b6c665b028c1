"""visual_ms (ms a unit): device time of the kernels launched inside the
port's ``tdax.visual`` range (``models/qwen_vl/vit.py::visual_encode``:
the patch embedding, the tower's blocks, the resampler, the projection)."""

from benchmark.layer_metrics import span_ms


def read(ctx):
    return span_ms(ctx, "visual")
