"""gj_launches_per_call: launches of the Gauss-Jordan inverse kernel a
traced call (``ops.gj_inverse.launch_count``)."""

COUNTERS = {"gj_launches": "lcqpow_tpu_torch.ops.gj_inverse.launch_count"}


def read(ctx):
    deltas = ctx.counters.get("gj_launches")
    if not deltas or None in deltas:
        return None
    return sum(deltas) / len(deltas)
