"""Problem data container: the port of ``lcqpow_tpu/data.py``.

The LCQP

    minimize    1/2 x'Qx + g'x
    subject to  lbA <=  A x <= ubA    (nC rows)
                lb  <=    x <= ub     (box)
                lbL <=  L x <= ubL    (nComp rows)
                lbR <=  R x <= ubR    (nComp rows)
                (Lx - lbL) 'perp' (Rx - lbR)

is one frozen dataclass of dense tensors.  A batch of problems is the same
dataclass with a leading batch axis on every field.  The derived quantities
are computed once, in float64, whatever the storage dtype:

* ``C = L'R + R'L``                      (src/LCQProblem.cpp:622-623)
* ``g_phi = -(R'lbL + L'lbR)``           (src/LCQProblem.cpp:974-996)
* ``phi_const = lbL'lbR``                (src/LCQProblem.cpp:970-971)

"Absent" bounds are encoded as +/-INFTY (finite 1e20, see ``constants.py``);
default complementarity bounds are ``lbL = lbR = 0``, ``ubL = ubR = +INFTY``
(``src/LCQProblem.cpp:745-782``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import _config
from .constants import INFTY
from .ops import linalg
from .types import ReturnValue


class LCQPError(ValueError):
    """Raised on invalid problem data; carries the reference-compatible
    :class:`ReturnValue` code."""

    def __init__(self, code: ReturnValue, msg: str = ""):
        self.code = code
        super().__init__(f"{code.name} ({int(code)}){': ' + msg if msg else ''}")


@dataclasses.dataclass(frozen=True)
class LCQPData:
    """Immutable LCQP instance (or batch thereof, with a leading axis)."""

    Q: torch.Tensor        # (nV, nV)
    g: torch.Tensor        # (nV,)
    L: torch.Tensor        # (nComp, nV)
    R: torch.Tensor        # (nComp, nV)
    lbL: torch.Tensor      # (nComp,)
    ubL: torch.Tensor      # (nComp,)
    lbR: torch.Tensor      # (nComp,)
    ubR: torch.Tensor      # (nComp,)
    A: torch.Tensor        # (nC, nV)
    lbA: torch.Tensor      # (nC,)
    ubA: torch.Tensor      # (nC,)
    lb: torch.Tensor       # (nV,)
    ub: torch.Tensor       # (nV,)
    # Derived (precomputed once, like the reference's load path)
    C: torch.Tensor        # (nV, nV)
    g_phi: torch.Tensor    # (nV,)
    phi_const: torch.Tensor  # ()

    @property
    def nV(self) -> int:
        return self.Q.shape[-1]

    @property
    def nC(self) -> int:
        return self.A.shape[-2]

    @property
    def nComp(self) -> int:
        return self.L.shape[-2]

    @property
    def has_box(self) -> bool:
        """True if any finite box bound is present (the reference's
        NULL-pointer check, ``src/LCQProblem.cpp:929-957``)."""
        return bool((self.lb > -INFTY).any() or (self.ub < INFTY).any())

    # -- stacked constraint system (A; L; R), reference src/LCQProblem.cpp:563-608
    @property
    def A_full(self) -> torch.Tensor:
        return torch.cat([self.A, self.L, self.R], dim=-2)

    @property
    def lbA_full(self) -> torch.Tensor:
        return torch.cat([self.lbA, self.lbL, self.lbR], dim=-1)

    @property
    def ubA_full(self) -> torch.Tensor:
        return torch.cat([self.ubA, self.ubL, self.ubR], dim=-1)

    def map(self, fn) -> "LCQPData":
        """Apply ``fn`` to every field (dtype casts, lane gathers)."""
        return LCQPData(**{f.name: fn(getattr(self, f.name))
                           for f in dataclasses.fields(self)})


def _clamp_inf(x: torch.Tensor) -> torch.Tensor:
    """Map IEEE +/-inf (and values beyond INFTY) onto the finite stand-in
    (NaN stays NaN)."""
    return x.clamp(-INFTY, INFTY)


def make_lcqp(
    Q,
    g,
    L,
    R,
    lbL=None,
    ubL=None,
    lbR=None,
    ubR=None,
    A=None,
    lbA=None,
    ubA=None,
    lb=None,
    ub=None,
    *,
    dtype=None,
    validate: bool = True,
    as_numpy: bool = False,
    device=None,
) -> LCQPData:
    """Build an :class:`LCQPData` from dense arrays, applying the reference's
    defaulting rules (``src/LCQProblem.cpp:563-785``):

    * ``A/lbA/ubA`` absent -> zero general constraints (nC = 0);
      absent bounds -> -/+INFTY.
    * ``lbL/lbR`` absent -> 0;  ``ubL/ubR`` absent -> +INFTY.
    * ``lb/ub`` absent -> -/+INFTY.
    * Lower complementarity bounds must be finite
      (INVALID_LOWER_COMPLEMENTARITY_BOUND, ``src/LCQProblem.cpp:747-768``).

    Construction and validation run in NumPy.  ``as_numpy=True`` returns
    NumPy fields (for assembling a fleet on the host); otherwise the fields
    move to ``device`` in one pass (default: the CUDA card, see
    :func:`_config.default_device`).
    """
    dtype = dtype or _config.default_dtype()
    np_dtype = np.dtype(str(dtype).removeprefix("torch."))

    Q = np.asarray(Q, np_dtype)
    g = np.asarray(g, np_dtype).reshape(-1)
    nV = g.shape[0]
    if validate and (Q.ndim != 2 or Q.shape != (nV, nV)):
        raise LCQPError(ReturnValue.INVALID_ARGUMENT,
                        f"Q must be ({nV},{nV}), got {Q.shape}")
    if validate and nV <= 0:
        raise LCQPError(ReturnValue.INVALID_NUMBER_OF_OPTIM_VARS)
    if validate and not np.all(np.isfinite(g)):
        # The reference rejects a null objective linear term at load
        # (INVALID_OBJECTIVE_LINEAR_TERM, src/LCQProblem.cpp:104-109).
        raise LCQPError(ReturnValue.INVALID_OBJECTIVE_LINEAR_TERM,
                        "g contains non-finite entries")
    if validate and not np.all(np.isfinite(Q)):
        raise LCQPError(ReturnValue.INVALID_ARGUMENT,
                        "Q contains non-finite entries")

    L = np.asarray(L, np_dtype).reshape(-1, nV)
    R = np.asarray(R, np_dtype).reshape(-1, nV)
    nComp = L.shape[0]
    if validate and R.shape != (nComp, nV):
        raise LCQPError(ReturnValue.INVALID_COMPLEMENTARITY_MATRIX,
                        f"L is {L.shape}, R is {R.shape}")

    def vec(v, n, default, name):
        if v is None:
            return np.full((n,), default, np_dtype)
        v = np.asarray(v, np_dtype).reshape(-1)
        if validate and v.shape[0] != n:
            raise LCQPError(ReturnValue.INVALID_ARGUMENT,
                            f"{name} must have length {n}, got {v.shape[0]}")
        return np.clip(v, -INFTY, INFTY)

    lbL = vec(lbL, nComp, 0.0, "lbL")
    ubL = vec(ubL, nComp, INFTY, "ubL")
    lbR = vec(lbR, nComp, 0.0, "lbR")
    ubR = vec(ubR, nComp, INFTY, "ubR")

    if validate:
        # Reference rejects unbounded-below complementarity rows
        # (src/LCQProblem.cpp:747-748, 767-768).
        if bool(np.any(lbL <= -INFTY)) or bool(np.any(lbR <= -INFTY)):
            raise LCQPError(ReturnValue.INVALID_LOWER_COMPLEMENTARITY_BOUND)

    if A is None:
        A = np.zeros((0, nV), np_dtype)
    else:
        A = np.asarray(A, np_dtype).reshape(-1, nV)
    nC = A.shape[0]
    lbA = vec(lbA, nC, -INFTY, "lbA")
    ubA = vec(ubA, nC, INFTY, "ubA")

    lb = vec(lb, nV, -INFTY, "lb")
    ub = vec(ub, nV, INFTY, "ub")

    L64 = L.astype(np.float64)
    R64 = R.astype(np.float64)
    C = (L64.T @ R64 + R64.T @ L64).astype(np_dtype)
    g_phi = (-(R64.T @ lbL.astype(np.float64)
               + L64.T @ lbR.astype(np.float64))).astype(np_dtype)
    phi_const = np_dtype.type(np.dot(lbL.astype(np.float64),
                                     lbR.astype(np.float64)))

    data = LCQPData(Q=Q, g=g, L=L, R=R, lbL=lbL, ubL=ubL, lbR=lbR, ubR=ubR,
                    A=A, lbA=lbA, ubA=ubA, lb=lb, ub=ub,
                    C=C, g_phi=g_phi, phi_const=np.asarray(phi_const))
    if as_numpy:
        return data
    dev = _config.default_device(device)
    return data.map(lambda a: torch.as_tensor(a, device=dev))


def pad_lcqp(data: LCQPData, nV: int, nC: int, nComp: int) -> LCQPData:
    """Pad one instance to target dims so heterogeneous problems can share a
    batched solve.  Padding is exact: extra variables are pinned to 0 by
    unit-diagonal Q rows and lb=ub=0 box rows; extra constraint and
    complementarity rows are all-zero with bounds that hold trivially."""
    dnV, dnC, dnK = data.nV, data.nC, data.nComp
    if (nV, nC, nComp) == (dnV, dnC, dnK):
        return data
    if nV < dnV or nC < dnC or nComp < dnK:
        raise LCQPError(ReturnValue.INVALID_ARGUMENT, "pad dims must not shrink")
    like = data.Q

    def padm(M, rows):
        out = like.new_zeros((rows, nV))
        out[:M.shape[0], :dnV] = M
        return out

    def padv(v, rows, fill):
        out = like.new_full((rows,), fill)
        out[:v.shape[0]] = v
        return out

    Q = padm(data.Q, nV)
    diag_pad = torch.arange(dnV, nV, device=like.device)
    Q[diag_pad, diag_pad] = 1.0
    g = padv(data.g, nV, 0.0)
    L = padm(data.L, nComp)
    R = padm(data.R, nComp)
    lbL = padv(data.lbL, nComp, 0.0)
    ubL = padv(data.ubL, nComp, INFTY)
    lbR = padv(data.lbR, nComp, 0.0)
    ubR = padv(data.ubR, nComp, INFTY)
    A = padm(data.A, nC)
    lbA = padv(data.lbA, nC, -INFTY)
    ubA = padv(data.ubA, nC, INFTY)
    lb = padv(data.lb, nV, 0.0)
    ub = padv(data.ub, nV, 0.0)

    C = linalg.matrix_symmetrization_product(L, R)
    g_phi = -(R.mT @ lbL + L.mT @ lbR)
    phi_const = torch.dot(lbL, lbR)
    return LCQPData(Q=Q, g=g, L=L, R=R, lbL=lbL, ubL=ubL, lbR=lbR, ubR=ubR,
                    A=A, lbA=lbA, ubA=ubA, lb=lb, ub=ub,
                    C=C, g_phi=g_phi, phi_const=phi_const)


def stack_lcqps(problems) -> LCQPData:
    """Stack equal-shape instances into one batched LCQPData (leading axis)."""
    problems = list(problems)
    return LCQPData(**{
        f.name: torch.stack([getattr(p, f.name) for p in problems])
        for f in dataclasses.fields(LCQPData)})
