"""corrector_device_pct: the device time of every kernel launched inside
the df32 corrector and certificate (``mixed.correct_and_certify``), in
percent of the traced window's busy device time."""

SPANS = {"corrector": ("lcqpow_tpu_torch.mixed.correct_and_certify",
                       "range")}


def read(ctx):
    if ctx.trace is None:
        return None
    return ctx.trace.range_busy_pct("bench::corrector")
