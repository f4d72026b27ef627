"""corrector_steps_mean: df32 corrector passes
(``mixed.correct_and_certify``) a lane, the mean over the lanes of the
traced calls (``Solution.stats.corrector_steps``)."""


def read(ctx):
    vals = [getattr(s.stats, "corrector_steps", None) for s in ctx.solutions]
    if not vals or any(v is None for v in vals):
        return None
    return sum(float(v.double().mean()) for v in vals) / len(vals)
