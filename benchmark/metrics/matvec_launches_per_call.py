"""matvec_launches_per_call: launches of the port's batched matvec kernel
a traced call (``ops.linalg.matvec_launch_count``), never of the plain
``torch.matmul`` path; null for a tree without the counter."""

COUNTERS = {"matvec_launches": "lcqpow_tpu_torch.ops.linalg.matvec_launch_count"}


def read(ctx):
    deltas = ctx.counters.get("matvec_launches")
    if not deltas or None in deltas:
        return None
    return sum(deltas) / len(deltas)
