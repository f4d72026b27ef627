"""kernel_launches_per_call: kernels the card ran in the traced window,
per traced call, counted in the profiler's trace."""


def read(ctx):
    t = ctx.trace
    if t is None or t.window() is None:
        return None
    n = t.kernels_in_window()
    return n / ctx.calls if n else None
