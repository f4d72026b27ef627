"""Output statistics: the port of ``lcqpow_tpu/stats.py``.

Mirrors the reference ``OutputStatistics``
(``include/OutputStatistics.hpp:209-226``).  Every field is a per-lane tensor
with the batch axis leading: a solve of ``B`` lanes gives ``iter_total`` of
shape ``(B,)`` and trajectory buffers of shape ``(B, T, ...)``, where
``T = max_iterations + 2`` and entry ``i`` holds total iteration ``i``
(entries beyond a lane's ``iter_total`` are unwritten padding, NaN or 0).
An unbatched solve (:func:`lcqpow_tpu_torch.solve` on one instance) gives
the same fields without the lane axis; :meth:`Stats.trim` cuts its
trajectories to the iterations taken.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class Trajectories:
    """Per-iterate tracking buffers (``store_steps=True`` only)."""

    x_steps: torch.Tensor            # (B, T, nV)
    inner_iters: torch.Tensor        # (B, T) int32
    subproblem_iters: torch.Tensor   # (B, T) int32
    accu_subproblem_iters: torch.Tensor  # (B, T) int32
    step_length: torch.Tensor        # (B, T)  alpha_k
    step_size: torch.Tensor          # (B, T)  ||p_k||_inf
    stat_vals: torch.Tensor          # (B, T)  ||stat_k||_inf
    obj_vals: torch.Tensor           # (B, T)
    phi_vals: torch.Tensor           # (B, T)
    merit_vals: torch.Tensor         # (B, T)


@dataclasses.dataclass(frozen=True)
class Stats:
    """Solve statistics per lane (reference ``OutputStatistics.hpp:209-214``)."""

    iter_total: torch.Tensor       # (B,) int32
    iter_outer: torch.Tensor       # (B,) int32
    subproblem_iter: torch.Tensor  # (B,) int32 (accumulated inner-QP iterations)
    rho_opt: torch.Tensor          # (B,)  penalty value at termination
    solution_status: torch.Tensor  # (B,) int32 AlgorithmStatus
    qp_exit_flag: torch.Tensor     # (B,) int32 last inner-QP status
    trajectories: Optional[Trajectories] = None
    # Mixed-precision pipeline extensions (None for plain solves).
    corrector_steps: Optional[torch.Tensor] = None  # (B,) int32 KKT passes
    # certified_stage: 0 = uncertified, 1 = predictor point certified as-is,
    # 2 = certified after corrector steps, 2+k = certified in escalation
    # round k.
    certified_stage: Optional[torch.Tensor] = None  # (B,) int32

    # Reference-style getters (OutputStatistics get* pairs,
    # include/OutputStatistics.hpp:96-205), for a single-lane solve.
    def get_iter_total(self) -> int:
        return int(self.iter_total)

    def get_iter_outer(self) -> int:
        return int(self.iter_outer)

    def get_subproblem_iter(self) -> int:
        return int(self.subproblem_iter)

    def get_rho_opt(self) -> float:
        return float(self.rho_opt)

    def get_solution_status(self) -> int:
        return int(self.solution_status)

    def get_qp_solver_exit_flag(self) -> int:
        return int(self.qp_exit_flag)

    getIterTotal = get_iter_total
    getIterOuter = get_iter_outer
    getSubproblemIter = get_subproblem_iter
    getRhoOpt = get_rho_opt
    getSolutionStatus = get_solution_status
    getQPSolverExitFlag = get_qp_solver_exit_flag

    def trim(self) -> "Stats":
        """Trajectories cut to the iterations actually taken (a host read
        of ``iter_total``).  Unbatched: entry ``i < iter_total``.  Batched:
        the time axis is cut to the largest ``iter_total`` of the lanes, and
        a shorter lane keeps its padding beyond its own count."""
        if self.trajectories is None:
            return self
        n = int(self.iter_total.max())
        axis = self.iter_total.ndim
        return dataclasses.replace(self, trajectories=Trajectories(**{
            k.name: getattr(self.trajectories, k.name).narrow(axis, 0, n)
            for k in dataclasses.fields(Trajectories)}))

    def map(self, fn, *others: "Stats") -> "Stats":
        """Apply ``fn`` field-wise to the per-lane tensors of this and
        ``others`` (lane gathers, merges of two solves)."""
        def f(*vs):
            if vs[0] is None:
                return None
            if isinstance(vs[0], Trajectories):
                return Trajectories(**{
                    k.name: fn(*(getattr(v, k.name) for v in vs))
                    for k in dataclasses.fields(Trajectories)})
            return fn(*vs)
        return Stats(**{k.name: f(*(getattr(s, k.name)
                                    for s in (self,) + others))
                        for k in dataclasses.fields(self)})
