"""gather_ms.train: device milliseconds a step of the work launched under the
harness's span "sedbench.gather" (`index_to_device(flat_index(rows))` and
`batch_builder(stores, idx)`), over the traced steps. Layer: train store."""


def read(ctx):
    if ctx.kind != "train" or ctx.trace is None or not ctx.trace.device:
        return None
    t = ctx.trace.time_s(in_span="gather")
    return None if t <= 0 else 1e3 * t / ctx.trace.units
