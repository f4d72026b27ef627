"""predictor_device_pct: the device time of every kernel launched inside
the f32 homotopy (``solver.solve`` as ``mixed`` calls it, the inner QP
included), in percent of the traced window's busy device time."""

SPANS = {"predictor": ("lcqpow_tpu_torch.mixed.solve", "range")}


def read(ctx):
    if ctx.trace is None:
        return None
    return ctx.trace.range_busy_pct("bench::predictor")
