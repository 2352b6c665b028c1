"""adamw_ms (ms a unit): device time of the kernels launched inside
torch.optim's ``Optimizer.step`` range (the AdamW update, not the clip)."""


def read(ctx):
    if ctx.units <= 0:
        return None
    s = ctx.trace.kernel_s(None, optimizer=True)
    return 1e3 * s / ctx.units if s > 0 else None
