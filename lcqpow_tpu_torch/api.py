"""One-call solve API (parity with the reference's MATLAB mex entry): the
port of ``lcqpow_tpu/api.py``.

The reference's MATLAB interface is a single function

    [x, y, stats] = LCQPow(Q, g, L, R, lbL, ubL, lbR, ubR, {A, lbA, ubA},
                           {lb, ub}, {params})

(``interfaces/matlab/LCQPow.m:30-38``; mex implementation
``interfaces/matlab/LCQPow.cpp:570-1092``).  This module provides the same
shape of entry point for Python:

    x, y, stats = lcqpow(Q, g, L, R, lbL, ubL, lbR, ubR,
                         A=A, lbA=lbA, ubA=ubA, params={"x0": x0, ...})

``params`` accepts the mex parameter names (camelCase, ``LCQPow.cpp:679-854``)
as well as the snake_case option names.  ``stats`` is a dict with the mex
stats-struct fields (``LCQPow.cpp:952-1092``): ``iters_total``,
``iters_outer``, ``iters_subproblem``, ``rho_opt``, ``elapsed_time``,
``exit_flag``, ``solution_type``, ``qp_exit_flag`` — plus the per-iterate
trajectory fields (``xSteps``, ``innerIters``, ``subproblemIters``,
``accuSubproblemIters``, ``stepLength``, ``stepSize``, ``statVals``,
``objVals``, ``phiVals``, ``meritVals``) when ``storeSteps`` is on.  The
reference mex has a field-indexing bug where ``xSteps`` clobbers
``qp_exit_flag`` (``LCQPow.cpp:1014,1069``); it is not replicated.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch

from . import _config
from .data import make_lcqp
from .mixed import solve_mixed
from .options import Options
from .solver import solve
from .types import PrintLevel, QPSolver

# mex param name (LCQPow.cpp:679-854) -> Options field.
_PARAM_MAP = {
    "stationarityTolerance": "stationarity_tolerance",
    "complementarityTolerance": "complementarity_tolerance",
    "initialPenaltyParameter": "initial_penalty_parameter",
    "penaltyUpdateFactor": "penalty_update_factor",
    "maxPenaltyParameter": "max_penalty_parameter",
    "maxRho": "max_penalty_parameter",
    "solveZeroPenaltyFirst": "solve_zero_penalty_first",
    "perturbStep": "perturb_step",
    "maxIterations": "max_iterations",
    "nDynamicPenalty": "n_dynamic_penalty",
    "etaDynamicPenalty": "eta_dynamic_penalty",
    "printLevel": "print_level",
    "storeSteps": "store_steps",
    "qpSolver": "qp_solver",
    "innerSolver": "inner_solver",  # extension: the inner engine
    "seed": "seed",
}

# Disposition of every OSQP settings field the reference mex accepts
# (interfaces/matlab/LCQPow.cpp:488-565, 22 fields) on the batched ADMM
# engine: "mapped" fields go to the named ADMMOptions field; "ignored"
# fields have no meaning here (each with the reason) and are accepted
# silently for drop-in parity.  The same tables as the JAX package's.
_OSQP_FIELD_MAP = {
    # OSQP field        -> ADMMOptions field
    "rho": "rho",
    "sigma": "sigma",
    "alpha": "alpha",
    "eps_abs": "eps_abs",
    "eps_rel": "eps_rel",
    "eps_prim_inf": "eps_prim_inf",
    "eps_dual_inf": "eps_dual_inf",
    "max_iter": "max_iter",
    "polish": "polish",
    "polish_refine_iter": "polish_refine_iter",
    "delta": "polish_delta",             # OSQP's polish regularization
    "adaptive_rho": "adaptive_rho",
    "adaptive_rho_tolerance": "adaptive_rho_tolerance",
    "check_termination": "check_interval",
}
_OSQP_FIELDS_IGNORED = {
    "adaptive_rho_interval":
        "rho adaptation runs at the check_interval cadence",
    "adaptive_rho_fraction":
        "time-based adaptation has no meaning inside a lockstep batch",
    "scaled_termination":
        "termination is always tested on unscaled residuals",
    "scaling":
        "Ruiz equilibration is always on (fixed sweep count)",
    "linsys_solver":
        "one batched dense KKT operator; no alternative backends",
    "time_limit":
        "no wall-clock branching inside the lockstep loops",
    "verbose":
        "per-lane inner-iteration printing is meaningless in a batch",
    "warm_start":
        "warm starting is structural: ADMM state always carries across "
        "homotopy steps",
}

# The reference mex's qpOASES_options fields (LCQPow.cpp:347-482).  The
# qpOASES engine has no counterpart here — its role (machine-precision
# active-set solves with hotstarts) is played by the polish-first ADMM and
# the PAS engine — so ALL of these are accepted-but-ignored; unknown keys
# still fail loudly.
_QPOASES_FIELDS_IGNORED = frozenset({
    "printLevel", "enableRamping", "enableFarBounds", "enableFlippingBounds",
    "enableRegularisation", "enableFullLITests", "enableNZCTests",
    "enableDriftCorrection", "enableCholeskyRefactorisation",
    "enableEqualities", "terminationTolerance", "boundTolerance",
    "boundRelaxation", "epsNum", "epsDen", "maxPrimalJump", "maxDualJump",
    "initialRamping", "finalRamping", "initialFarBounds", "growFarBounds",
    "initialStatusBounds", "epsFlipping", "numRegularisationSteps",
    "epsRegularisation", "numRefinementSteps", "epsIterRef", "epsLITests",
    "epsNZCTests",
})

# Trajectories field -> mex stats-struct field.
_TRAJ_FIELDS = {
    "x_steps": "xSteps", "inner_iters": "innerIters",
    "subproblem_iters": "subproblemIters",
    "accu_subproblem_iters": "accuSubproblemIters",
    "step_length": "stepLength", "step_size": "stepSize",
    "stat_vals": "statVals", "obj_vals": "objVals", "phi_vals": "phiVals",
    "merit_vals": "meritVals",
}


def options_from_params(params: Optional[dict]) -> Tuple[Options,
                                                         Optional[np.ndarray],
                                                         Optional[np.ndarray]]:
    """Build :class:`Options` from a mex-style ``params`` dict.

    Returns ``(options, x0, y0)``: the reference passes the initial guess
    inside ``params`` too (``LCQPow.cpp:807-853``).  Unknown keys raise
    ``KeyError`` (the mex warns and ignores; failing loudly is safer for a
    Python API).  The nested ``OSQP_options`` dict configures the inner ADMM
    engine with the per-field disposition of :data:`_OSQP_FIELD_MAP` /
    :data:`_OSQP_FIELDS_IGNORED`; all 29 mex-accepted ``qpOASES_options``
    fields are accepted and ignored (:data:`_QPOASES_FIELDS_IGNORED`), and
    unknown keys of either raise.
    """
    params = dict(params or {})
    x0 = params.pop("x0", None)
    y0 = params.pop("y0", None)
    if x0 is not None:
        x0 = np.asarray(x0, np.float64).reshape(-1)
    if y0 is not None:
        y0 = np.asarray(y0, np.float64).reshape(-1)

    admm_kw = {}
    for k, v in (params.pop("OSQP_options", None) or {}).items():
        if k in _OSQP_FIELD_MAP:
            admm_kw[_OSQP_FIELD_MAP[k]] = v
        elif k not in _OSQP_FIELDS_IGNORED:
            raise KeyError(f"unknown OSQP_options field: {k!r}")
    for k in params.pop("qpOASES_options", None) or {}:
        if k not in _QPOASES_FIELDS_IGNORED:
            raise KeyError(f"unknown qpOASES_options field: {k!r}")

    fields = {f.name for f in dataclasses.fields(Options)}
    kw = {}
    for k, v in params.items():
        field = _PARAM_MAP.get(k, k)
        if field == "print_level":
            v = PrintLevel(int(v))
        elif field == "qp_solver":
            v = QPSolver(int(v))
        if field not in fields:
            raise KeyError(f"unknown LCQPow parameter: {k!r}")
        kw[field] = v
    opts = Options(**kw)
    if admm_kw:
        opts = opts.replace(admm=dataclasses.replace(opts.admm, **admm_kw))
    return opts, x0, y0


def synchronize(device: torch.device) -> None:
    """Wait for the card's queued work (no-op on the CPU): the end of every
    wall-clock interval this API reports."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def lcqpow(Q, g, L, R, lbL=None, ubL=None, lbR=None, ubR=None,
           A=None, lbA=None, ubA=None, lb=None, ub=None,
           params: Optional[dict] = None, *, mixed: bool = False,
           device=None):
    """Solve one LCQP with the mex calling convention; returns
    ``(x, y, stats_dict)``, ``x`` and ``y`` as NumPy arrays on the host.

    Runs on ``device`` (default: the CUDA card; ``"cpu"`` on request).
    ``mixed=True`` takes the mixed-precision pipeline
    (:func:`mixed.solve_mixed` on the one instance, which reaches the GJ
    kernel at B = 1 on the card).

    The port has no compile stage: ``elapsed_time`` is the wall clock of
    the solve call, ending in ``torch.cuda.synchronize()`` on the card;
    ``elapsed_time_solve`` equals it and ``elapsed_time_compile`` is 0.0
    (the JAX package splits its time into compile and solve).
    """
    opts, x0, y0 = options_from_params(params)
    dev = _config.default_device(device)
    data = make_lcqp(Q, g, L, R, lbL=lbL, ubL=ubL, lbR=lbR, ubR=ubR,
                     A=A, lbA=lbA, ubA=ubA, lb=lb, ub=ub, device=dev)
    base = solve_mixed if mixed else solve
    t0 = time.perf_counter()
    sol = base(data, opts, x0=x0, y0=y0)
    synchronize(dev)
    wall = time.perf_counter() - t0

    stats = {
        "iters_total": int(sol.stats.iter_total),
        "iters_outer": int(sol.stats.iter_outer),
        "iters_subproblem": int(sol.stats.subproblem_iter),
        "rho_opt": float(sol.stats.rho_opt),
        # mex parity: total wall clock (interfaces/matlab/LCQPow.cpp:882-916).
        "elapsed_time": wall,
        "elapsed_time_compile": 0.0,
        "elapsed_time_solve": wall,
        "exit_flag": int(sol.ret),
        "solution_type": int(sol.algo_status),
        "qp_exit_flag": int(sol.stats.qp_exit_flag),
    }
    traj = sol.stats.trim().trajectories
    if traj is not None:
        stats.update({mex: getattr(traj, name).cpu().numpy()
                      for name, mex in _TRAJ_FIELDS.items()})
    return sol.x.cpu().numpy(), sol.y.cpu().numpy(), stats


LCQPow = lcqpow  # reference-style name
