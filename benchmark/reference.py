"""The plain reference that decides ``correct``: a float64 re-derivation,
from the fleet's own inputs, of what a certified lane claims.

The program under test certifies a lane (``ret == 0``) when its point is
stationary, complementary and feasible to the reference LCQPow's default
tolerances (``src/Options.cpp:296-298`` of LCQPow; the feasibility test
is the port's, 1e-9 relative to ``1 + max |[A; L; R; I] x|``).  This module
re-evaluates each of those three quantities in float64 for every certified
lane of every call, from the problem data and the returned ``x`` and
``y``, with no snapping of small slacks and no quantity the program
computed, and counts the lanes left uncertified.

Each number is a ratio to its stated tolerance, so 1 is the limit the
configuration states; a non-finite certified ``x`` or ``y`` reads as
infinity.  ``y`` is LCQPow's output layout: with box duals (qpOASES modes)
``[y_box (nV), y_A (nC), y_L (nComp), y_R (nComp)]``, without them the
same minus ``y_box``; the complementarity duals are the transformed ones
(``src/LCQProblem.cpp:1381-1409``), so stationarity is that of the
Lagrangian of the LCQP itself, with no penalty term.

Stationarity is taken with each dual held to its constraint: a dual
counts only where its side of the constraint is active, within the
feasibility tolerance (``y_A`` positive at ``lbA``, negative at ``ubA``;
``y_L`` and ``y_R`` of either sign where ``Lx`` or ``Rx`` is 0, the weak
stationarity of an MPCC; a box dual at its bound, and the family has no
box).  What a lane puts on an inactive constraint is left out of the
Lagrangian, so it shows as residual; its size is reported as
``inadmissible``.

The certificate tests stationarity on a double-word f32 evaluation (a
48-bit significand, ``ops/df32.py``), rounded to f32 and compared with the
tolerance rounded to f32; a lane it certifies a hair under the tolerance
can read a hair over it in float64.  So the stationarity number is the
float64 residual less a bound of that evaluation's rounding,
``DF32_ROUNDING`` of the largest sum of absolute terms of the residual's
rows and ``F32_ROUNDING`` of the tolerance: a lane fails only where no
rounding of the certificate's own precision explains the excess.  The
plain ratio is reported beside it (``stationarity_raw``).

The readings assume that the fields a family does not set keep the
program's defaults: ``lbL = lbR = 0``, no upper bound on ``Lx`` or ``Rx``
and no box.  A fleet whose family sets any field outside ``CHECKED`` is
refused, not judged under the wrong bounds.

Imports only torch and numpy (through :mod:`fleet`); nothing of the
program.
"""

from __future__ import annotations

import math

import torch

#: Lanes a block: the reference's working set stays under ~0.3 GB.
BLOCK = 65536
#: Rounding bound of the certificate's double-word f32 residual, relative
#: to the largest sum of absolute terms of a row (64 units of a 48-bit
#: significand: the operation count of the certificate's residual and of
#: its dual transform gives 58), and of its two roundings to f32, relative
#: to the tolerance.
DF32_ROUNDING = 2.0 ** -42
F32_ROUNDING = 2.0 ** -23
#: A raw ratio above this counts as near its limit (``near``).
NEAR = 0.999
#: The LCQP fields a family may set for the readings to hold.
CHECKED = frozenset({"Q", "g", "L", "R", "A", "lbA", "ubA"})


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched ``M @ v`` by products and sums, in the type of the inputs."""
    return (M * v[:, None, :]).sum(-1)


def _mtv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched ``M' @ v``."""
    return (M * v[:, :, None]).sum(-2)


def check_call(fleet, g: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
               ret: torch.Tensor, guarantees: dict) -> dict:
    """The float64 readings of one call's results against the data it was
    given (``fleet`` with this call's ``g``).  Raises ``ValueError`` where
    the fleet's family sets a field outside :data:`CHECKED`."""
    unchecked = sorted(set(fleet.fields) - CHECKED)
    if unchecked:
        raise ValueError(f"the reference does not check {unchecked}: "
                         f"it judges only {sorted(CHECKED)}")
    nV, nC, nK = fleet.nV, fleet.nC, fleet.nComp
    stat_tol = float(guarantees["stationarity_tolerance"])
    compl_tol = float(guarantees["complementarity_tolerance"])
    feas_tol = float(guarantees["feasibility_tolerance"])
    ny = y.shape[1]
    if ny == nV + nC + 2 * nK:
        box = True
    elif ny == nC + 2 * nK:
        box = False
    else:
        raise ValueError(f"y has {ny} entries a lane; expected "
                         f"{nC + 2 * nK} or {nV + nC + 2 * nK}")
    lanes = x.shape[0]
    out = dict(lanes=lanes, certified=0, stationarity=0.0,
               complementarity=0.0, feasibility=0.0, stationarity_raw=0.0,
               inadmissible=0.0, near=0)
    for lo in range(0, lanes, BLOCK):
        blk = slice(lo, min(lo + BLOCK, lanes))
        cert = ret[blk] == 0
        idx = torch.nonzero(cert).flatten() + lo
        n = idx.numel()
        out["certified"] += n
        if n == 0:
            continue
        inst = fleet.instance.index_select(0, idx)

        def field(name):
            return fleet.base[name].index_select(0, inst)

        xs = x.index_select(0, idx).double()
        ys = y.index_select(0, idx).double()
        if not (torch.isfinite(xs).all() and torch.isfinite(ys).all()):
            out.update(stationarity=math.inf, complementarity=math.inf,
                       feasibility=math.inf, stationarity_raw=math.inf)
            return out
        yc = ys[:, nV:] if box else ys
        yA, yL, yR = yc[:, :nC], yc[:, nC:nC + nK], yc[:, nC + nK:]
        Q, A, L, R = field("Q"), field("A"), field("L"), field("R")
        lbA, ubA = field("lbA"), field("ubA")
        gs = g.index_select(0, idx)
        Ax, Lx, Rx = _mv(A, xs), _mv(L, xs), _mv(R, xs)
        # Rows [A; L; R] with bounds [lbA, ubA], [0, inf), [0, inf); no box.
        viol = torch.stack([(lbA - Ax).amax(-1), (Ax - ubA).amax(-1),
                            (-Lx).amax(-1), (-Rx).amax(-1)], -1) \
            .amax(-1).clamp_min(0.0)
        scale = 1.0 + torch.cat([Ax, Lx, Rx, xs], -1).abs().amax(-1)
        active = (feas_tol * scale)[:, None]
        # Each dual held to its constraint (see the module's docstring).
        yA_ok = torch.where(yA > 0, Ax - lbA <= active, ubA - Ax <= active)
        yA_adm = torch.where(yA_ok, yA, 0.0)
        yL_adm = torch.where(Lx <= active, yL, 0.0)
        yR_adm = torch.where(Rx <= active, yR, 0.0)
        left = torch.cat([yA - yA_adm, yL - yL_adm, yR - yR_adm]
                         + ([ys[:, :nV]] if box else []), -1)
        r = _mv(Q, xs) + gs - _mtv(A, yA_adm) - _mtv(L, yL_adm) \
            - _mtv(R, yR_adm)
        mag = _mv(Q.abs(), xs.abs()) + gs.abs() \
            + _mtv(A.abs(), yA_adm.abs()) + _mtv(L.abs(), yL_adm.abs()) \
            + _mtv(R.abs(), yR_adm.abs())
        stat = r.abs().amax(-1)
        slack = DF32_ROUNDING * mag.amax(-1) + F32_ROUNDING * stat_tol
        phi = (Lx * Rx).sum(-1)
        ratios = torch.stack([(stat - slack) / stat_tol, phi / compl_tol,
                              viol / scale / feas_tol, stat / stat_tol,
                              left.abs().amax(-1) / stat_tol])
        worst = ratios.amax(-1).tolist()
        for k, v in zip(("stationarity", "complementarity", "feasibility",
                         "stationarity_raw", "inadmissible"), worst):
            out[k] = max(out[k], v)
        out["near"] += int((ratios[:4] > NEAR).any(0).sum())
    return out


def combine(readings: list[dict]) -> dict:
    """The run's numbers over its calls: the worst ratio of each quantity
    over every certified lane, and the share of lanes left uncertified."""
    lanes = sum(r["lanes"] for r in readings)
    certified = sum(r["certified"] for r in readings)
    out = {k: max((r[k] for r in readings), default=0.0)
           for k in ("stationarity", "complementarity", "feasibility",
                     "stationarity_raw", "inadmissible")}
    out["uncertified_pct"] = 100.0 * (lanes - certified) / max(lanes, 1)
    out.update(lanes=lanes, certified=certified,
               near=sum(r["near"] for r in readings))
    return out
