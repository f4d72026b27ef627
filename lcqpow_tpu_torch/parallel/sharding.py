"""Fleets over several devices: the port of
``lcqpow_tpu/parallel/sharding.py``.

The JAX package shards the lane axis of a batch over a ``jax.sharding``
mesh, and one SPMD program solves every shard on its chip at once.  Here a
"mesh" is a list of ``torch.device``: :func:`shard_batch` splits the lane
axis into one contiguous slice per device, and :func:`solve_batch_sharded`
solves every slice at the same time, one host thread per slice.  The root
key is split over the whole fleet first, as the JAX package splits it over
its global batch, and each slice takes its lanes' keys.  Each thread owns a
CUDA stream on its device and runs :func:`lcqpow_tpu_torch.solve` on its
lanes; the caller gathers the lanes back in order.  Nothing crosses devices
during the solve.

The solve is host-bound (it launches one small op at a time), and the
threads share one interpreter: they take turns on a baton
(:class:`lcqpow_tpu_torch._sync.Baton`), handed over where a thread waits
for its device.  So the slices' device work overlaps but their host work
does not, and a sharded call takes about as long as its slices one after
another: 2.955-3.214 s against 2.754-3.039 s for 1024 f64 warm-up lanes
over four NVIDIA H100 80GB HBM3 cards at 700 W, and 0.803-0.871 s on one
of them at full width (``tools/torch_multicard.py``).  To drive several
cards at once,
run one process per card (:func:`.distributed.initialize`): each rank
solves its own lanes, and :func:`fleet_summary` adds the ranks' counts
with ``all_reduce``.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .. import prng
from .._sync import Baton
from ..data import LCQPData
from ..options import Options
from ..solver import Solution, solve
from ..types import ReturnValue
from .distributed import HostLocalBatch

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


def _solve_slice(dev: torch.device, stream, baton: Baton, data: LCQPData,
                 options: Options, keys, x0, y0) -> Solution:
    """:func:`solve` of one slice with its lanes' ``keys``, holding the
    workers' ``baton``, on its card's ``stream`` (``None`` off the
    card)."""
    if stream is None:
        with baton.held():
            return solve(data, options, x0=x0, y0=y0, key=keys)
    with torch.cuda.device(dev), torch.cuda.stream(stream), baton.held():
        return solve(data, options, x0=x0, y0=y0, key=keys)


def solve_batch_sharded(data: LCQPData, options: Options = Options(),
                        mesh: Optional[Sequence] = None,
                        x0: Optional[torch.Tensor] = None,
                        y0: Optional[torch.Tensor] = None,
                        key=None) -> Solution:
    """Solve the fleet ``data`` (or the rank's lanes of a
    :class:`~.distributed.HostLocalBatch`) over ``mesh`` (default
    :func:`make_mesh`), and gather the lanes, in order, on the device of
    ``data``.

    The root ``key`` (default ``PRNGKey(options.seed)``) is split over the
    whole fleet, as ``solve_batch`` splits it (for a
    ``HostLocalBatch``: over all ranks' lanes, the rank taking those from
    its offset), so every lane draws what it draws in a one-device solve of
    the fleet.  Every slice (:func:`shard_batch`) is solved at the same
    time by a worker thread of its own: the thread binds the slice's
    device, runs on a CUDA stream of its own there, holds the workers'
    baton except while it waits for its device (see the module docstring),
    and calls :func:`solve` with its lanes' keys.  The same kernels run in
    the same order on each slice's device, so each slice is bit for bit
    :func:`solve` of those lanes and keys on its device, whatever the
    threads' interleaving; on the CPU that is the full-width solve's lanes
    bit for bit, while on the card a slice is solved at its own width and
    may round differently from the full width (cuBLAS picks its kernels by
    batch size).  On a mesh of one device (or with one non-empty slice) it
    is one :func:`solve` call, with no thread.  A worker's
    exception is raised again here, after every worker has ended.  A mesh
    may name one card more than once: its slices then run on separate
    streams of that card."""
    offset = 0
    if isinstance(data, HostLocalBatch):
        offset, data = data.offset, data.data
    if mesh is None:
        mesh = make_mesh()
    home = data.Q.device
    local = data.Q.shape[0]
    keys = prng.fleet_keys(key, options.seed, offset + local, home, offset)
    slices = [(dev, d, k, x, y) for dev, d, k, x, y in zip(
        mesh, shard_batch(data, mesh), shard_batch(keys, mesh),
        shard_batch(x0, mesh), shard_batch(y0, mesh)) if d.Q.shape[0] > 0]
    if len(slices) == 1:
        dev, d, k, x, y = slices[0]
        return solve(d, options, x0=x, y0=y, key=k).map(
            lambda a: a.to(home))
    # Each worker's stream starts after the caller's copies of its slice.
    streams = []
    for dev, *_ in slices:
        stream = None
        if dev.type == "cuda":
            stream = torch.cuda.Stream(dev)
            stream.wait_stream(torch.cuda.current_stream(dev))
        streams.append(stream)
    baton = Baton()
    with ThreadPoolExecutor(len(slices),
                            thread_name_prefix="solve_batch_sharded") as pool:
        futures = [pool.submit(_solve_slice, dev, stream, baton, d, options,
                               k, x, y)
                   for (dev, d, k, x, y), stream in zip(slices, streams)]
    parts = [f.result() for f in futures]
    # The gather runs on the caller's streams, after each worker's; a
    # worker's tensors are marked as used there, so their memory is not
    # handed out again on the worker's stream before the gather has read it.
    readers = []
    for (dev, *_), stream in zip(slices, streams):
        reader = None
        if stream is not None:
            reader = torch.cuda.current_stream(dev)
            reader.wait_stream(stream)
        readers.append(reader)

    def gather(*xs):
        for a, reader in zip(xs, readers):
            if reader is not None:
                a.record_stream(reader)
        return torch.cat([a.to(home) for a in xs])

    return parts[0].map(gather, *parts[1:])


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
