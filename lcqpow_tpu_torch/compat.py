"""Reference-compatible object API: the port of ``lcqpow_tpu/compat.py``.

Mirrors the C++ ``LCQPow::LCQProblem`` surface
(``include/LCQProblem.hpp:47-242``) and the Python pybind11 binding
(``interfaces/python/lcqpow/LCQProblem.cpp:70-176``) so existing LCQPow
scripts port with minimal edits:

    lcqp = LCQProblem(nV, nC, nComp)
    lcqp.set_options(Options(...))
    ret = lcqp.load_lcqp(Q, g, L, R, lbL, ubL, lbR, ubR, A, lbA, ubA, lb, ub, x0, y0)
    ret = lcqp.switch_to_sparse_mode()      # required protocol for sparse enums
    ret = lcqp.run_solver()
    x = lcqp.get_primal_solution()
    y = lcqp.get_dual_solution()
    stats = lcqp.get_output_statistics()

Error handling follows the reference: methods *return* :class:`ReturnValue`
codes instead of raising (``src/LCQProblem.cpp`` throughout).  The
dense/sparse mode flag is an API-protocol shim only — the solver has one
dense representation — but the reference's mismatch rules are enforced so
ported code behaves identically (``DENSE_SPARSE_MISSMATCH``,
``src/LCQProblem.cpp:892-953``; every reference example calls
``switchToSparseMode`` before ``runSolver`` when using a sparse solver enum,
e.g. ``examples/warm_up.cpp:61-69``).

The problem lives on ``device`` (constructor argument; default: the CUDA
card, ``"cpu"`` on request).  Both snake_case and the reference's camelCase
method names are provided.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from . import _config, messages
from .api import synchronize
from .constants import INFTY
from .data import LCQPData, LCQPError, make_lcqp
from .io import load_lcqp_from_files
from .ops.csc import CSCMatrix
from .options import Options
from .solver import Solution, solve
from .stats import Stats
from .types import PrintLevel, QPSolver, ReturnValue


def _is_sparse(M) -> bool:
    return hasattr(M, "toarray")


def _densify(M):
    """Accept NumPy arrays, tensors, scipy.sparse matrices and
    :class:`~.ops.csc.CSCMatrix` (the reference's CSC load path,
    ``src/LCQProblem.cpp:390-441``, deep-copies CSC; here sparse input is
    converted to the dense layout on the host, through :mod:`.ops.csc`)."""
    if M is None:
        return None
    if _is_sparse(M):
        if not isinstance(M, CSCMatrix):
            M = M.tocsc(copy=True)
            M.sum_duplicates()
            M = CSCMatrix.from_scipy(M)
        return M.toarray()
    if isinstance(M, torch.Tensor):
        return M.detach().cpu().numpy()
    return np.asarray(M)


def _vector(v) -> Optional[np.ndarray]:
    return None if v is None else np.asarray(
        _densify(v), np.float64).reshape(-1)


def _has_box(lb, ub) -> bool:
    """The reference's NULL-pointer check of the box bounds
    (``src/LCQProblem.cpp:929-957``), on the host's NumPy inputs."""
    return bool((lb is not None and np.any(np.asarray(lb) > -INFTY))
                or (ub is not None and np.any(np.asarray(ub) < INFTY)))


class LCQProblem:
    """Stateful wrapper over the functional solver (reference parity)."""

    def __init__(self, nV: int = 0, nC: int = 0, nComp: int = 0,
                 device=None):
        self.nV = int(nV)
        self.nC = int(nC)
        self.nComp = int(nComp)
        self._device = device
        self._options = Options()
        self._data: Optional[LCQPData] = None
        self._x0 = None
        self._y0 = None
        self._sparse_mode = False
        self._solution: Optional[Solution] = None
        self._has_box = False
        self._setup_ok = self.nV > 0 and self.nComp > 0

    # ------------------------------------------------------------------ load
    def load_lcqp(self, Q, g, L, R, lbL=None, ubL=None, lbR=None, ubR=None,
                  A=None, lbA=None, ubA=None, lb=None, ub=None,
                  x0=None, y0=None) -> ReturnValue:
        """Dense/sparse load (reference ``loadLCQP``,
        ``src/LCQProblem.cpp:87-441``; argument order as in the MATLAB/Python
        interfaces)."""
        if not self._setup_ok:
            return ReturnValue.LCQPOBJECT_NOT_SETUP
        if L is None or R is None:
            return ReturnValue.INVALID_COMPLEMENTARITY_MATRIX
        if A is None and self.nC > 0:
            return ReturnValue.INVALID_CONSTRAINT_MATRIX
        sparse_in = _is_sparse(Q) or _is_sparse(L)
        lb_np, ub_np = _densify(lb), _densify(ub)
        try:
            self._data = make_lcqp(
                _densify(Q), _densify(g), _densify(L), _densify(R),
                lbL=_densify(lbL), ubL=_densify(ubL),
                lbR=_densify(lbR), ubR=_densify(ubR),
                A=_densify(A), lbA=_densify(lbA), ubA=_densify(ubA),
                lb=lb_np, ub=ub_np, device=self._device)
        except LCQPError as e:
            return e.code
        if self._data.nC != self.nC or self._data.nComp != self.nComp \
                or self._data.nV != self.nV:
            self._data = None
            return ReturnValue.INVALID_ARGUMENT
        # Host-side box flag from the NumPy inputs: no device read.
        self._has_box = _has_box(lb_np, ub_np)
        self._x0 = _vector(x0)
        self._y0 = _vector(y0)
        # A sparse load puts the object directly in sparse mode (reference
        # CSC overload); a dense load requires switchToSparseMode.
        self._sparse_mode = sparse_in
        return ReturnValue.SUCCESSFUL_RETURN

    def load_lcqp_from_files(self, directory: str, x0=None, y0=None
                             ) -> ReturnValue:
        """File load (reference ``loadLCQP`` file overload,
        ``src/LCQProblem.cpp:147-387``): parsed once to NumPy, where the
        box flag is computed, then moved to the device."""
        try:
            host = load_lcqp_from_files(directory, as_numpy=True)
        except (OSError, ValueError):
            return ReturnValue.UNABLE_TO_READ_FILE
        self._has_box = _has_box(host.lb, host.ub)
        dev = _config.default_device(self._device)
        self._data = host.map(lambda a: torch.as_tensor(a, device=dev))
        self.nV = self._data.nV
        self.nC = self._data.nC
        self.nComp = self._data.nComp
        self._setup_ok = True
        self._x0 = _vector(x0)
        self._y0 = _vector(y0)
        self._sparse_mode = False
        return ReturnValue.SUCCESSFUL_RETURN

    # ------------------------------------------------------- mode switching
    def switch_to_sparse_mode(self) -> ReturnValue:
        """Protocol shim (reference ``src/LCQProblem.cpp:1037-1068``)."""
        if self._data is None:
            return ReturnValue.FAILED_SWITCH_TO_SPARSE
        self._sparse_mode = True
        return ReturnValue.SUCCESSFUL_RETURN

    def switch_to_dense_mode(self) -> ReturnValue:
        """Protocol shim (reference ``src/LCQProblem.cpp:1071-1102``)."""
        if self._data is None:
            return ReturnValue.FAILED_SWITCH_TO_DENSE
        self._sparse_mode = False
        return ReturnValue.SUCCESSFUL_RETURN

    # -------------------------------------------------------------- options
    def set_options(self, options: Options) -> None:
        self._options = options

    def get_options(self) -> Options:
        return self._options

    # ---------------------------------------------------------------- solve
    def run_solver(self) -> ReturnValue:
        """Reference ``runSolver`` (``src/LCQProblem.cpp:444-560``) including
        the mode-protocol checks of ``initializeSolver`` (``:885-963``).

        ``elapsed_time`` is the wall clock of the solve, ending in
        ``torch.cuda.synchronize()`` on the card; ``elapsed_time_solve``
        equals it and ``elapsed_time_compile`` is 0.0 (nothing compiles)."""
        if self._data is None:
            return ReturnValue.LCQPOBJECT_NOT_SETUP
        qps = self._options.qp_solver
        # Dense/sparse protocol (initializeSolver :892-953).
        if qps == QPSolver.QPOASES_DENSE and self._sparse_mode:
            return ReturnValue.DENSE_SPARSE_MISSMATCH
        if qps in (QPSolver.QPOASES_SPARSE, QPSolver.OSQP_SPARSE) \
                and not self._sparse_mode:
            return ReturnValue.DENSE_SPARSE_MISSMATCH
        # OSQP mode rejects box constraints (:929-957), by the host flag.
        if qps == QPSolver.OSQP_SPARSE and self._has_box:
            return ReturnValue.INVALID_OSQP_BOX_CONSTRAINTS

        y0 = self._y0
        if y0 is not None and not self._options.uses_box_duals \
                and y0.shape[0] == self.nV + self.n_duals():
            # OSQP mode drops the box block of a full-length dual guess
            # (:936-948; the reference's byte-count bug there is fixed).
            y0 = y0[self.nV:]

        dev = self._data.Q.device
        t0 = time.perf_counter()
        self._solution = solve(self._data, self._options, x0=self._x0, y0=y0)
        synchronize(dev)
        self.elapsed_time = time.perf_counter() - t0
        self.elapsed_time_solve = self.elapsed_time
        self.elapsed_time_compile = 0.0
        ret = ReturnValue(int(self._solution.ret))
        # Reference reporting: the boxed stationarity banner on success
        # (runSolver :520-524 -> MessageHandler::PrintSolution) and the
        # ReturnValue message on failure (PrintMessage), both gated by the
        # print level.
        if self._options.print_level > PrintLevel.NONE:
            if ret == ReturnValue.SUCCESSFUL_RETURN:
                messages.print_solution(int(self._solution.algo_status))
            else:
                messages.print_message(ret)
        return ret

    # --------------------------------------------------------------- getters
    def n_duals(self) -> int:
        base = self.nC + 2 * self.nComp
        return base + self.nV if self._options.uses_box_duals else base

    def get_primal_solution(self) -> Optional[np.ndarray]:
        """x, shape (nV,), on the host."""
        if self._solution is None:
            return None
        return self._solution.x.cpu().numpy()

    def get_dual_solution(self) -> Optional[np.ndarray]:
        """y in the mode's layout, on the host."""
        if self._solution is None:
            return None
        return self._solution.y.cpu().numpy()

    def get_number_of_primals(self) -> int:
        return self.nV

    def get_number_of_duals(self) -> int:
        return self.n_duals()

    def get_output_statistics(self) -> Optional[Stats]:
        if self._solution is None:
            return None
        return self._solution.stats.trim()

    def get_solution(self) -> Optional[Solution]:
        return self._solution

    # ------------------------------------------------ reference-style names
    loadLCQP = load_lcqp
    switchToSparseMode = switch_to_sparse_mode
    switchToDenseMode = switch_to_dense_mode
    setOptions = set_options
    runSolver = run_solver
    getPrimalSolution = get_primal_solution
    getDualSolution = get_dual_solution
    getNumberOfPrimals = get_number_of_primals
    getNumberOfDuals = get_number_of_duals
    getOutputStatistics = get_output_statistics
