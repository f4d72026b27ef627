"""device_idle_pct: the share of the traced window (first traced call's
start to last one's end) in which no kernel, copy or set ran on the card,
from the profiler's timeline, in percent."""


def read(ctx):
    t = ctx.trace
    if t is None or t.window() is None or t.dev_start.size == 0:
        return None
    return 100.0 * (1.0 - t.busy_ns() / t.window_ns())
