"""Fleets over several devices: the port of
``lcqpow_tpu/parallel/sharding.py``.

The JAX package shards the lane axis of a batch over a ``jax.sharding``
mesh and lets XLA run each shard on its chip.  Here a "mesh" is a list of
``torch.device``: :func:`shard_batch` splits the lane axis into one
contiguous slice per device, :func:`solve_batch_sharded` solves each slice
on its device with :func:`lcqpow_tpu_torch.solve_batch` and gathers the
lanes back in order.  The slices are solved one after another by this
process.  To run several cards at once, run one process per card
(:func:`.distributed.initialize`): each rank solves its own lanes, and
:func:`fleet_summary` adds the ranks' counts with ``all_reduce``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..batch import solve_batch
from ..data import LCQPData
from ..options import Options
from ..solver import Solution
from ..types import ReturnValue

#: Buckets of the stage histogram of :func:`fleet_summary`; stages from
#: ``_N_STAGES - 1`` up share the last one, so the counts total the fleet.
_N_STAGES = 16


def _world_size() -> int:
    """Processes in the initialized process group (1 without one)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def make_mesh(devices: Optional[Sequence] = None) -> list:
    """The devices to spread a fleet over, as ``torch.device``.

    ``devices`` given (``["cpu", "cpu"]``, ``["cuda:0", "cuda:1"]``, ...):
    those.  By default every visible CUDA device, or, once a process group
    of several ranks is initialized, the rank's own current CUDA device
    (each rank drives one card).  Raises without a CUDA device: there is no
    silent fallback to the CPU.
    """
    if devices is not None:
        return [torch.device(d) for d in devices]
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device; pass devices=['cpu', "
                           "...] to spread a fleet over the CPU")
    if _world_size() > 1:
        return [torch.device("cuda", torch.cuda.current_device())]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def shard_batch(tree, mesh: Sequence) -> list:
    """Split the lane axis of ``tree`` (an :class:`LCQPData`, a lane-leading
    tensor, or ``None``) into ``len(mesh)`` contiguous slices, each moved
    to its device.  The slices differ by at most one lane; with fewer lanes
    than devices the last slices are empty."""
    if tree is None:
        return [None] * len(mesh)
    if isinstance(tree, torch.Tensor):
        return [part.to(dev) for part, dev in
                zip(torch.tensor_split(tree, len(mesh)), mesh)]
    fields = {f.name: shard_batch(getattr(tree, f.name), mesh)
              for f in dataclasses.fields(tree)}
    return [type(tree)(**{k: v[i] for k, v in fields.items()})
            for i in range(len(mesh))]


def solve_batch_sharded(data: LCQPData, options: Options = Options(),
                        mesh: Optional[Sequence] = None,
                        x0: Optional[torch.Tensor] = None,
                        y0: Optional[torch.Tensor] = None) -> Solution:
    """Solve the fleet ``data`` (or the rank's lanes of a
    :class:`~.distributed.HostLocalBatch`) slice by slice over ``mesh``
    (default :func:`make_mesh`), and gather the lanes, in order, on the
    device of ``data``.  On one device it is :func:`solve_batch` bit for
    bit.  Over several, each slice is :func:`solve_batch` of those lanes on
    its device: it draws its step perturbation from its own generator
    seeded with ``options.seed``, and is solved at its own width, which
    on the card may round differently from the full width (cuBLAS picks
    its kernels by batch size)."""
    data = getattr(data, "data", data)
    if mesh is None:
        mesh = make_mesh()
    home = data.Q.device
    parts = [solve_batch(d, options, x0=x, y0=y)
             for d, x, y in zip(shard_batch(data, mesh),
                                shard_batch(x0, mesh), shard_batch(y0, mesh))
             if d.Q.shape[0] > 0]
    return parts[0].map(lambda *xs: torch.cat([a.to(home) for a in xs]),
                        *parts[1:])


def fleet_summary(sol: Solution) -> dict:
    """Fleet statistics: solved lanes, mean iterations, largest penalty
    and, for a mixed-pipeline solve, lanes by certification stage (1 =
    predictor point certified as-is, 2 = corrector steps needed, 2+k =
    escalation round k; see ``Stats.certified_stage``) and mean corrector
    steps.  The same dict as the JAX package's.  With a process group of
    several ranks, the counts and sums of every rank are added with
    ``all_reduce`` (and the penalty maximized), so each rank gets the
    fleet's summary."""
    dev = sol.ret.device
    ok = sol.ret == int(ReturnValue.SUCCESSFUL_RETURN)
    st = sol.stats.certified_stage
    sums = [ok.sum(), torch.tensor(ok.shape[0], device=dev),
            sol.stats.iter_total.sum()]
    if st is not None:
        sums += [torch.bincount(st.clamp_max(_N_STAGES - 1).long(),
                                minlength=_N_STAGES),
                 sol.stats.corrector_steps.sum()]
    sums = torch.cat([s.reshape(-1).to(torch.int64) for s in sums])
    max_rho = sol.stats.rho_opt.max().to(torch.float64).reshape(1)
    if _world_size() > 1:
        dist.all_reduce(sums, op=dist.ReduceOp.SUM)
        dist.all_reduce(max_rho, op=dist.ReduceOp.MAX)
    sums = sums.tolist()
    total = sums[1]
    # Means in float32, as the JAX package takes them.
    mean = lambda s: float(np.float32(s) / np.float32(total))
    out = {
        "solved": sums[0],
        "total": total,
        "mean_iterations": mean(sums[2]),
        "max_rho": float(max_rho),
    }
    if st is not None:
        counts = sums[3:3 + _N_STAGES]
        out["certified_by_stage"] = {
            (s if s < _N_STAGES - 1 else f"{_N_STAGES - 1}+"): c
            for s, c in enumerate(counts) if c}
        out["mean_corrector_steps"] = mean(sums[3 + _N_STAGES])
    return out
