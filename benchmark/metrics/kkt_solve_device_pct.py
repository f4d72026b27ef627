"""kkt_solve_device_pct: the device time of every kernel launched inside
the inner QP's active-set KKT solve (``solvers.admm._polish_solve``, which
the ADMM polish and every PAS pivot call), in percent of the traced
window's busy device time."""

SPANS = {"kkt_solve": ("lcqpow_tpu_torch.solvers.admm._polish_solve",
                       "range")}


def read(ctx):
    if ctx.trace is None:
        return None
    return ctx.trace.range_busy_pct("bench::kkt_solve")
