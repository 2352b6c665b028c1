"""mla_flash_roofline (%): the least time the units' latent-attention
forwards need (``work_kimi_vl.mla_attn_bound_s``: q.k over 192 columns,
v of 128, causal) over the device time of the kernels named here (the
sm90 forward's latent-attention kernel)."""

KERNELS = ("flash_fwd_mla",)


def read(ctx):
    bound = getattr(ctx.work, "mla_attn_bound_s", 0.0) * ctx.units
    s = ctx.trace.kernel_s(KERNELS)
    return 100.0 * bound / s if bound > 0 and s > 0 else None
