"""mfu.eval: the frozen analytic FLOPs of a pass's clips (yardstick/flops.py:
the CRNN forward and an rFFT front end) over the device's busy time a pass
in the traced block (kernels and copies merged), as a percent of the
compute dtype's peak (989 TFLOP/s bf16): the whole pass's share of the chip
while it runs, which bounds the kernels' roofline shares. Layer: device
(whole pass)."""

from sedbench.yardstick import flops, roofline


def read(ctx):
    if ctx.kind != "eval" or ctx.trace is None or not ctx.trace.device:
        return None
    busy = ctx.trace.busy_s() / ctx.trace.units
    work = flops.eval_clip_flops(ctx.config) * ctx.traffic["clips"]
    return 100.0 * work / busy / roofline.peak_flops(ctx.config)
