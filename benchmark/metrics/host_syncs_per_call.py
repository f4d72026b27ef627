"""host_syncs_per_call: the host's waits for the card a traced call, each
a read of a device flag or count that the solve's loops branch on
(``_sync.sync_count``)."""

COUNTERS = {"host_syncs": "lcqpow_tpu_torch._sync.sync_count"}


def read(ctx):
    deltas = ctx.counters.get("host_syncs")
    if not deltas or None in deltas:
        return None
    return sum(deltas) / len(deltas)
