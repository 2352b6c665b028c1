"""flash_fwd_roofline (%): the least time the units' attention forwards
need (``benchmark.work``'s calls, ``roofline.attn_fwd_bound``) over the
device time of the attention forward kernels named here."""

KERNELS = ("flash_fwd", "flash_decode")


def read(ctx):
    bound = ctx.work.attn_fwd_bound_s() * ctx.units
    s = ctx.trace.kernel_s(KERNELS)
    return 100.0 * bound / s if bound > 0 and s > 0 else None
