"""conv_roofline.train: the conv blocks' least time (yardstick/roofline.py,
rows 1-4 in bytes and FLOPs at the compute dtype's peak) over the device
time of their kernels, a train step. Layer: conv blocks."""

from sedbench.yardstick import roofline

# every kernel of csrc/fused_cnn.cu, fp32 and bf16 modes, by name
KERNELS = ("conv3x3_", "conv_c1_", "lane_stats_final_kernel", "dy_eff_", "conv_dw_",
           "dw_final_kernel", "glu_fwd_", "glu_bwd_")


def read(ctx):
    if ctx.kind != "train":
        return None
    least = roofline.conv_least_s(ctx.config, ctx.kind, ctx.traffic)
    return roofline.share_percent(ctx, KERNELS, least)
