"""setup_s: from the process's start to the end of the warm call, on the
host clock: imports, the card's start, the kernels' build or load, the
fleet, and one call at the cell's own width."""


def read(ctx):
    return ctx.setup_s
