"""flash_bwd_roofline (%): the least time the units' attention backward
pairs need (dq and dk/dv, ``roofline.attn_bwd_pair_bound``) over the
device time of the backward kernels named here."""

KERNELS = ("bwd_dq", "bwd_dkv")


def read(ctx):
    bound = ctx.work.attn_bwd_bound_s() * ctx.units
    s = ctx.trace.kernel_s(KERNELS)
    return 100.0 * bound / s if bound > 0 and s > 0 else None
