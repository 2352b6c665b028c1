"""route_ms (ms a unit): device time of the kernels launched inside the
port's ``tdax.route`` ranges (``ops/moe.py::moe``: the router, the
dispatch and the gather of the routed rows, the combine)."""

from benchmark.layer_metrics import span_ms


def read(ctx):
    return span_ms(ctx, "route")
