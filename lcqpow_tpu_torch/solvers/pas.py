"""Parametric active-set QP engine: the port of ``lcqpow_tpu/solvers/pas.py``.

The qpOASES-analogue second tier behind ``Options.inner_solver="pas"`` (see
the JAX module for the design).  The working set is a pair of boolean masks
``(low, up)`` over the stacked constraint rows; each pivot round solves the
masked equality-KKT system with :func:`admm._polish_solve` and tests it with
the full KKT check :func:`admm._kkt_ok`; the block pivot drops every
wrong-signed multiplier and adds every violated row at once.

The JAX package's ``lax.while_loop`` becomes a host loop over masked lane
state, as in :mod:`.admm`: a lane that passed the KKT test (or ran out of
pivots) keeps its carry unchanged while the others pivot on.

A QP that cannot be certified within ``pas_max_pivots`` rounds (infeasible
QPs included) returns ``ADMM_MAX_ITER``, which the homotopy driver maps to
``SUBPROBLEM_SOLVER_ERROR`` unless it tolerates inner max-iter exits.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..constants import INFTY
from ..ops.linalg import lane_where, mv
from ..options import ADMMOptions
from . import admm
from .admm import ADMM_MAX_ITER, ADMM_SOLVED, ADMMResult, ADMMState, \
    QPWorkspace


def solve(ws: QPWorkspace, q, state: ADMMState, cfg: ADMMOptions,
          active: Optional[torch.Tensor] = None) -> ADMMResult:
    """Solve ``min 1/2 x'Px + q'x  s.t.  l <= Ax <= u`` per lane by bounded
    block-pivot active-set iteration from a warm start.

    Same signature and result contract as :func:`admm.solve`;
    ``iterations`` counts KKT solves (pivot rounds + 1).  Lanes outside
    ``active`` never extend the pivot loop and their outputs are
    meaningless.
    """
    c = ws.c[:, None]
    y0 = ws.E * state.y / c          # unscaled warm-start dual
    x0 = ws.D * state.x
    has_l = ws.l > -INFTY
    has_u = ws.u < INFTY

    # Initial working set: dual-sign seed (OSQP sign: y < 0 pushes on the
    # lower bound) plus the rows the warm-start point already sits on.
    Ax0 = mv(ws.A, x0)
    near_low = has_l & (Ax0 <= ws.l + 1e-8 * (1.0 + ws.l.abs()))
    near_up = has_u & (Ax0 >= ws.u - 1e-8 * (1.0 + ws.u.abs()))
    low = ws.eq_mask | ((y0 < 0) & has_l) | near_low
    up = (((y0 > 0) & has_u) | near_up) & ~low

    x, y = admm._polish_solve(ws, q, low, up, cfg)
    ok = admm._kkt_ok(ws, q, x, y, cfg)
    if active is None:
        active = torch.ones_like(ok)
    it = torch.zeros(ok.shape, dtype=torch.int32, device=ok.device)
    while True:
        run = active & ~ok & (it < int(cfg.pas_max_pivots))
        if not bool(run.any()):
            break
        # Block pivot: drop wrong-signed multipliers, add violated rows;
        # equality rows never leave.
        Ax = mv(ws.A, x)
        low_n = ((low & (y < 0)) | (Ax < ws.l - cfg.polish_delta)
                 | ws.eq_mask) & has_l
        up_n = ((up & (y > 0)) | (Ax > ws.u + cfg.polish_delta)) \
            & has_u & ~low_n
        x_n, y_n = admm._polish_solve(ws, q, low_n, up_n, cfg)
        ok_n = admm._kkt_ok(ws, q, x_n, y_n, cfg)
        x = lane_where(run, x_n, x)
        y = lane_where(run, y_n, y)
        low = lane_where(run, low_n, low)
        up = lane_where(run, up_n, up)
        ok = torch.where(run, ok_n, ok)
        it = torch.where(run, it + 1, it)

    status = torch.where(ok, ADMM_SOLVED, ADMM_MAX_ITER).to(torch.int32)
    # An uncertified but finite iterate is exposed as-is; the warm-start
    # point is the fallback only when the iterate went NaN/Inf.
    keep = ok | (torch.isfinite(x).all(-1) & torch.isfinite(y).all(-1))
    x_out = lane_where(keep, x, x0)
    y_out = lane_where(keep, y, y0)
    return ADMMResult(x=x_out, y=y_out, status=status, iterations=it + 1,
                      state=admm._state_of(ws, x_out, y_out))
