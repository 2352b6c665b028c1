"""moonvit_flash_roofline (%): the least time the units' MoonViT
attention forwards need (``work_kimi_vl.vit_attn_bound_s``: 16 heads of
72 over each image's patches, not causal) over the device time of the
sm90 flash forward's kernels other than the latent-attention one
(``flash_fwd_mla``), which the decoder launches."""

KERNELS = ("flash_fwd",)
EXCLUDE = ("flash_fwd_mla",)


def read(ctx):
    bound = getattr(ctx.work, "vit_attn_bound_s", 0.0) * ctx.units
    s = ctx.trace.kernel_s(KERNELS, exclude=EXCLUDE)
    return 100.0 * bound / s if bound > 0 and s > 0 else None
