"""mla_ms (ms a unit): device time of the kernels launched inside the
port's ``tdax.mla`` ranges (``models/kimi_vl/decoder.py``: each decoder
layer's latent attention, from its RMSNorm through W_o)."""

from benchmark.layer_metrics import span_ms


def read(ctx):
    return span_ms(ctx, "mla")
