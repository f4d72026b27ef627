"""Multi-process execution: the port of
``lcqpow_tpu/parallel/distributed.py``, on ``torch.distributed``.

The JAX package runs one program over all hosts: ``jax.distributed``
joins the processes into one runtime and a fleet is one global array whose
lanes live on every host's chips.  Here each process (rank) drives its own
card and keeps its own lanes: nothing is exchanged during a solve, and the
only collective is :func:`.sharding.fleet_summary`'s ``all_reduce``.  As
``jax.distributed.initialize`` does, :func:`initialize` ends the group it
opens when the process exits (:func:`shutdown`).
"""

from __future__ import annotations

import atexit
import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..data import LCQPData


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None,
               device=None) -> bool:
    """Idempotent ``torch.distributed.init_process_group``.

    Defaults come from the standard variables ``MASTER_ADDR`` (default
    ``localhost``), ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``;
    ``init_method`` (e.g. ``"tcp://localhost:29500"``) replaces the first
    two.  The backend is NCCL, each rank on card ``LOCAL_RANK`` (default:
    ``rank`` modulo the cards), or gloo with ``device="cpu"``.  Returns True
    if a process group of several ranks is active after the call; with one
    process it is a no-op that returns False, so one script runs
    everywhere.

    A group it opens is torn down when the process exits: :func:`shutdown`
    is registered with :mod:`atexit`, so no rank closes the group's store
    and connections while another still uses them.
    """
    if dist.is_initialized():
        return dist.get_world_size() > 1
    world_size = int(world_size if world_size is not None
                     else os.environ.get("WORLD_SIZE", 1))
    if world_size <= 1:
        return False
    rank = int(rank if rank is not None else os.environ["RANK"])
    if init_method is None:
        init_method = (f"tcp://{os.environ.get('MASTER_ADDR', 'localhost')}:"
                       f"{os.environ['MASTER_PORT']}")
    if device is not None and torch.device(device).type == "cpu":
        backend = "gloo"
    else:
        backend = "nccl"
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    atexit.unregister(shutdown)
    atexit.register(shutdown)
    return dist.get_world_size() > 1


def shutdown() -> None:
    """End the process group: ``barrier``, so that every rank has finished
    with the group, then ``destroy_process_group``.  Every rank must call
    it, as with any collective; a no-op without a group.  :func:`initialize`
    registers it to run at exit, and a script may call it earlier."""
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


@dataclasses.dataclass(frozen=True)
class HostLocalBatch:
    """A rank's lanes of a fleet spread over the ranks."""

    data: LCQPData  # this rank's lanes, on its device
    offset: int     # fleet index of its first lane
    total: int      # lanes over all ranks


def host_local_batch_to_global(batch: LCQPData,
                               device=None) -> HostLocalBatch:
    """The rank's part of a fleet whose lanes are spread over the ranks.

    In the JAX package this assembles one global array from every host's
    lanes.  In torch each rank keeps its own lanes, so this moves them to
    ``device`` (default: the rank's current CUDA card) and records where
    they sit in the fleet: the lane offset (the lanes of the lower ranks,
    gathered with ``all_gather``; the sizes may differ) and the fleet's
    size.  Without a process group the offset is 0.  Pass the result to
    :func:`.sharding.solve_batch_sharded`.
    """
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device())
    data = batch.map(lambda a: a.to(device))
    local = data.Q.shape[0]
    if not (dist.is_initialized() and dist.get_world_size() > 1):
        return HostLocalBatch(data, 0, local)
    dev = "cpu" if dist.get_backend() == "gloo" else device
    sizes = [torch.zeros(1, dtype=torch.int64, device=dev)
             for _ in range(dist.get_world_size())]
    dist.all_gather(sizes, torch.tensor([local], device=dev))
    sizes = [int(s) for s in sizes]
    return HostLocalBatch(data, sum(sizes[:dist.get_rank()]), sum(sizes))
