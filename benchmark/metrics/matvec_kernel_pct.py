"""matvec_kernel_pct: the share of the CUDA ``mv``/``mtv`` calls of the
traced calls that the port's matvec kernel took, in % of
``ops.linalg.matvec_call_count`` (the rest went to ``torch.matmul``);
null for a tree without the counters or without a CUDA call."""

COUNTERS = {
    "matvec_launches": "lcqpow_tpu_torch.ops.linalg.matvec_launch_count",
    "matvec_calls": "lcqpow_tpu_torch.ops.linalg.matvec_call_count"}


def read(ctx):
    launches = ctx.counters.get("matvec_launches")
    calls = ctx.counters.get("matvec_calls")
    if not launches or not calls or None in launches or None in calls:
        return None
    return 100.0 * sum(launches) / sum(calls) if sum(calls) else None
