"""backward_ms (ms a unit): device time of the kernels launched inside the
port's ``tdax.backward`` range (``torch.autograd.grad`` with remat's
replay; autograd's device thread counts as the range's)."""

from benchmark.layer_metrics import span_ms


def read(ctx):
    return span_ms(ctx, "backward")
