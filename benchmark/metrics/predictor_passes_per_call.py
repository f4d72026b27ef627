"""predictor_passes_per_call: lockstep passes of the predictor's homotopy
(``solver.solve``) a traced call, read as launches of the pass's
perturbation (one a pass, ``prng.launch_count``)."""

COUNTERS = {"perturb_launches": "lcqpow_tpu_torch.prng.launch_count"}


def read(ctx):
    deltas = ctx.counters.get("perturb_launches")
    if not deltas or None in deltas:
        return None
    return sum(deltas) / len(deltas)
