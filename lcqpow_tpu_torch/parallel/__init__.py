"""Multi-card and multi-process fleets: the port of ``lcqpow_tpu/parallel``
(:mod:`.sharding`, :mod:`.distributed`), on ``torch.distributed``."""

from .sharding import (  # noqa: F401
    make_mesh,
    shard_batch,
    solve_batch_sharded,
    fleet_summary,
)
