"""subproblem_iter_mean: inner QP iterations (ADMM iterations or PAS KKT
solves, ``solvers/admm.py``, ``solvers/pas.py``) a lane, the mean over
the lanes of the traced calls (``Solution.stats.subproblem_iter``)."""


def read(ctx):
    vals = [getattr(s.stats, "subproblem_iter", None) for s in ctx.solutions]
    if not vals or any(v is None for v in vals):
        return None
    return sum(float(v.double().mean()) for v in vals) / len(vals)
