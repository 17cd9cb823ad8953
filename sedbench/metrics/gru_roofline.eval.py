"""gru_roofline.eval: the BiGRU kernels' least time (yardstick/roofline.py)
over the device time of the kernels of csrc/gru.cu (the op desed_torch::bigru
and its backward), an eval pass. Layer: BiGRU."""

from sedbench.yardstick import roofline

KERNELS = ("bigru_",)


def read(ctx):
    if ctx.kind != "eval":
        return None
    least = roofline.gru_least_s(ctx.config, ctx.kind, ctx.traffic)
    return roofline.share_percent(ctx, KERNELS, least)
