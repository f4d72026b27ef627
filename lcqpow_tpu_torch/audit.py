"""Host-side float64 certificate audit of solved LCQPs: the port of
``lcqpow_tpu/audit.py``.

The mixed-precision pipeline certifies in double-word f32 and snaps
sub-noise-floor complementarity slacks to zero before forming phi (see
:func:`mixed.correct_and_certify`).  This module is the independent check:
it re-evaluates the certificate quantities in NumPy float64 on the host,
with no snapping, against the reference-default tolerances
(``src/Options.cpp:297-298`` of LCQPow).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .data import LCQPData
from .options import Options
from .solver import Solution
from .types import ReturnValue


def _np(a) -> np.ndarray:
    return a.detach().to("cpu").double().numpy()


def audit_solution(data: LCQPData, sol: Solution,
                   options: Optional[Options] = None) -> dict:
    """f64 host audit of one solve (or a batch: leading axis on every field).

    Returns a dict with, over the certified lanes, the worst f64
    complementarity product ``max_phi`` ((Lx-lbL)'(Rx-lbR), the quantity
    LCQPow tests at ``src/LCQProblem.cpp:1172-1185``) and the worst primal
    violation ``max_violation`` of the stacked system [A; L; R; box];
    ``phi_ok`` is the verdict against the options' complementarity
    tolerance.  Uncertified lanes are excluded; ``audited`` counts the lanes
    checked and ``total`` all lanes.
    """
    options = options or Options()
    x = _np(sol.x)
    ret = sol.ret.detach().to("cpu").numpy()
    batched = x.ndim == 2
    if not batched:
        x = x[None]
        ret = ret.reshape(1)
    leaves = {name: _np(getattr(data, name)) for name in
              ("L", "R", "lbL", "lbR", "lb", "ub")}
    for name in ("A_full", "lbA_full", "ubA_full"):
        leaves[name] = _np(getattr(data, name))

    def lane(name, i):
        a = leaves[name]
        return a[i] if batched else a

    ok = ret == int(ReturnValue.SUCCESSFUL_RETURN)
    max_phi = 0.0
    max_viol = 0.0
    for i in np.nonzero(ok)[0]:
        sL = lane("L", i) @ x[i] - lane("lbL", i)
        sR = lane("R", i) @ x[i] - lane("lbR", i)
        max_phi = max(max_phi, abs(sL @ sR))
        for M, lo, hi in ((lane("A_full", i), lane("lbA_full", i),
                           lane("ubA_full", i)),
                          (np.eye(x.shape[1]), lane("lb", i),
                           lane("ub", i))):
            v = M @ x[i]
            max_viol = max(max_viol,
                           float(np.max(np.maximum(lo - v, v - hi),
                                        initial=0.0)))
    audited = int(ok.sum())
    return dict(
        audited=audited,
        total=int(ret.shape[0]),
        max_phi=float(max_phi) if audited else None,
        max_violation=float(max_viol) if audited else None,
        phi_ok=bool(max_phi <= options.complementarity_tolerance)
        if audited else None,
    )
