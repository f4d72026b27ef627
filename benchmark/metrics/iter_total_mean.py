"""iter_total_mean: homotopy iterations of the predictor (``solver.solve``)
a lane, the mean over the lanes of the traced calls
(``Solution.stats.iter_total``)."""


def read(ctx):
    vals = [getattr(s.stats, "iter_total", None) for s in ctx.solutions]
    if not vals or any(v is None for v in vals):
        return None
    return sum(float(v.double().mean()) for v in vals) / len(vals)
