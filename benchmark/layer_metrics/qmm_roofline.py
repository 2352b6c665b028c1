"""qmm_roofline (%): the least time the units' int8 weight-only products
need (``roofline.qmm_bound``) over the device time of the int8 product
kernels named here."""

KERNELS = ("qmm_",)


def read(ctx):
    bound = ctx.work.qmm_bound_s() * ctx.units
    s = ctx.trace.kernel_s(KERNELS)
    return 100.0 * bound / s if bound > 0 and s > 0 else None
