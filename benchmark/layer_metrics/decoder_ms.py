"""decoder_ms (ms a unit): device time of the kernels launched inside the
port's ``tdax.decoder`` range (the forward's decoder blocks; remat's
replay belongs to the backward)."""

from benchmark.layer_metrics import span_ms


def read(ctx):
    return span_ms(ctx, "decoder")
