"""idle_share (%): the share of the traced window in which no operation
ran on the device (1 - the union of device operations / the window)."""


def read(ctx):
    w, busy = ctx.trace.window_s, ctx.trace.busy_s()
    return 100.0 * (1.0 - busy / w) if w > 0 and busy > 0 else None
