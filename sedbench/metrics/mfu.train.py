"""mfu.train: the frozen analytic FLOPs of a train step (yardstick/flops.py:
the student's forward and backward, 3x a forward, the teacher's forward,
an rFFT front end) over the device's busy time a step in the traced block
(kernels and copies merged), as a percent of the compute dtype's peak
(989 TFLOP/s bf16): the whole step's share of the chip while it runs,
which bounds the kernels' roofline shares. Layer: device (whole step)."""

from sedbench.yardstick import flops, roofline


def read(ctx):
    if ctx.kind != "train" or ctx.trace is None or not ctx.trace.device:
        return None
    busy = ctx.trace.busy_s() / ctx.trace.units
    return 100.0 * flops.train_step_flops(ctx.config) / busy / roofline.peak_flops(ctx.config)
