"""expert_gemm_roofline (%): the least time the units' grouped expert
products need (``work_kimi_vl.expert_bound_s``) over the device time of
the grouped-product kernels, by the names they launch as (each
``torch._grouped_mm`` call: a small kernel that lays out the groups'
pointers and shapes, then CUTLASS's sm90 grouped GEMM over them)."""

KERNELS = ("groupproblemshape", "prepare_grouped_gemm_data")


def read(ctx):
    bound = getattr(ctx.work, "expert_bound_s", 0.0) * ctx.units
    s = ctx.trace.kernel_s(KERNELS)
    return 100.0 * bound / s if bound > 0 and s > 0 else None
