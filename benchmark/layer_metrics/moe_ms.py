"""moe_ms (ms a unit): device time of the kernels launched inside the
port's ``tdax.moe`` ranges and outside their ``tdax.route`` ranges
(``models/kimi_vl/decoder.py::ffn``: each expert FFN's norm, grouped
products and shared experts; ``route_ms`` holds the routing)."""

from benchmark.layer_metrics import span_ms


def read(ctx):
    return span_ms(ctx, "moe")
