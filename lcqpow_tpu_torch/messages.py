"""Human-readable status reporting (the reference's ``MessageHandler``):
the port of ``lcqpow_tpu/messages.py``, the same text.

Reference: ``src/MessageHandler.cpp:28-211`` maps every ``ReturnValue`` to a
printed message; ``PrintSolution`` (``:214-245``) prints a boxed banner
naming the stationarity type of the returned point.  Here they are host-side
and functional: ``message(ret)`` / ``solution_banner(status)`` return
strings, and ``print_message`` / ``print_solution`` emit them; the solver
calls them only from its object API (:mod:`.compat`).
"""

from __future__ import annotations

import sys

from .types import AlgorithmStatus, ReturnValue

# One human-readable line per ReturnValue the solver can produce.  Wording
# is our own; the *set of codes* and their severities mirror the reference.
_MESSAGES = {
    ReturnValue.SUCCESSFUL_RETURN:
        "Solver terminated successfully.",
    ReturnValue.NOT_YET_IMPLEMENTED:
        "This feature is not yet implemented.",
    ReturnValue.INVALID_ARGUMENT:
        "An invalid argument was passed.",
    ReturnValue.INVALID_PENALTY_UPDATE_VALUE:
        "Invalid penalty update factor (must exceed 1).",
    ReturnValue.INVALID_COMPLEMENTARITY_TOLERANCE:
        "Invalid complementarity tolerance (must be at least machine "
        "precision); the default was restored.",
    ReturnValue.INVALID_INITIAL_PENALTY_VALUE:
        "Invalid initial penalty parameter (must be positive); the default "
        "was restored.",
    ReturnValue.INVALID_MAX_ITERATIONS_VALUE:
        "Invalid maximum-iterations value (must be a positive integer); the "
        "default was restored.",
    ReturnValue.INVALID_STATIONARITY_TOLERANCE:
        "Invalid stationarity tolerance (must be at least machine "
        "precision); the default was restored.",
    ReturnValue.INVALID_NUMBER_OF_OPTIM_VARS:
        "The number of optimization variables must be positive.",
    ReturnValue.INVALID_NUMBER_OF_COMP_VARS:
        "The number of complementarity pairs must be positive.",
    ReturnValue.INVALID_NUMBER_OF_CONSTRAINT_VARS:
        "The number of linear constraints must be non-negative.",
    ReturnValue.INVALID_QPSOLVER:
        "Invalid QP solver selection.",
    ReturnValue.INVALID_OSQP_BOX_CONSTRAINTS:
        "Box constraints are not supported in OSQP mode (pass them as rows "
        "of A, or use a qpOASES-parity/ADMM_TPU mode).",
    ReturnValue.INVALID_TOTAL_ITER_COUNT:
        "Invalid total iteration counter.",
    ReturnValue.INVALID_TOTAL_OUTER_ITER:
        "Invalid outer iteration counter.",
    ReturnValue.IVALID_SUBPROBLEM_ITER:
        "Invalid subproblem iteration counter.",
    ReturnValue.INVALID_RHO_OPT:
        "Invalid penalty value.",
    ReturnValue.INVALID_PRINT_LEVEL_VALUE:
        "Invalid print level; the default was restored.",
    ReturnValue.INVALID_OBJECTIVE_LINEAR_TERM:
        "The objective's linear term is invalid (null or non-finite).",
    ReturnValue.INVALID_CONSTRAINT_MATRIX:
        "The constraint matrix is invalid.",
    ReturnValue.INVALID_COMPLEMENTARITY_MATRIX:
        "The complementarity matrices are invalid.",
    ReturnValue.INVALID_ETA_VALUE:
        "Invalid eta for the dynamic penalty check (must lie in (0, 1)); "
        "the default was restored.",
    ReturnValue.INVALID_LOWER_COMPLEMENTARITY_BOUND:
        "Lower complementarity bounds must be finite.",
    ReturnValue.INVALID_MAX_RHO_VALUE:
        "Invalid maximum penalty value (must be positive); the default was "
        "restored.",
    ReturnValue.MAX_ITERATIONS_REACHED:
        "The maximum number of iterations was reached.",
    ReturnValue.MAX_PENALTY_REACHED:
        "The maximum penalty value was reached; consider rescaling the "
        "complementarity constraints or raising max_penalty_parameter.",
    ReturnValue.INITIAL_SUBPROBLEM_FAILED:
        "Failed to solve the initial QP subproblem.",
    ReturnValue.SUBPROBLEM_SOLVER_ERROR:
        "The inner QP solver reported an error (see qp_exit_flag; the "
        "subproblem may be primal or dual infeasible).",
    ReturnValue.FAILED_SYM_COMPLEMENTARITY_MATRIX:
        "Failed to build the symmetric complementarity penalty matrix "
        "C = L'R + R'L.",
    ReturnValue.FAILED_SWITCH_TO_SPARSE:
        "Failed to switch to sparse mode (no problem data loaded).",
    ReturnValue.FAILED_SWITCH_TO_DENSE:
        "Failed to switch to dense mode (no problem data loaded).",
    ReturnValue.OSQP_WORKSPACE_NOT_SET_UP:
        "The inner-solver workspace is not set up.",
    ReturnValue.OSQP_INITIAL_PRIMAL_GUESS_FAILED:
        "Failed to apply the initial primal guess.",
    ReturnValue.OSQP_INITIAL_DUAL_GUESS_FAILED:
        "Failed to apply the initial dual guess.",
    ReturnValue.LCQPOBJECT_NOT_SETUP:
        "The LCQP object is not set up (construct it with positive nV and "
        "nComp, then load a problem).",
    ReturnValue.INDEX_OUT_OF_BOUNDS:
        "Index out of bounds.",
    ReturnValue.UNABLE_TO_READ_FILE:
        "Unable to read a problem data file.",
    ReturnValue.INVALID_INDEX_POINTER:
        "Invalid CSC column-pointer array.",
    ReturnValue.INVALID_INDEX_ARRAY:
        "Invalid CSC row-index array.",
    ReturnValue.DENSE_SPARSE_MISSMATCH:
        "Dense/sparse mode mismatch: the problem's storage mode does not "
        "match the selected QP solver (call switch_to_sparse_mode / "
        "switch_to_dense_mode first).",
}

_BANNERS = {
    AlgorithmStatus.PROBLEM_NOT_SOLVED: "The LCQP has not been solved.",
    AlgorithmStatus.W_STATIONARY_SOLUTION: "W-Stationary solution found",
    AlgorithmStatus.C_STATIONARY_SOLUTION: "C-Stationary solution found",
    AlgorithmStatus.M_STATIONARY_SOLUTION: "M-Stationary solution found",
    AlgorithmStatus.S_STATIONARY_SOLUTION: "S-Stationary solution found",
}


def message(ret: ReturnValue) -> str:
    """The message for a return code (``MessageHandler::PrintMessage``,
    ``src/MessageHandler.cpp:28-211``)."""
    ret = ReturnValue(int(ret))
    return _MESSAGES.get(ret, f"Unknown return value {int(ret)}.")


def print_message(ret: ReturnValue, file=None) -> ReturnValue:
    """Print the message and pass the code through (the reference's
    pattern ``return MessageHandler::PrintMessage(ret)``)."""
    ret = ReturnValue(int(ret))
    print(message(ret), file=file or sys.stdout, flush=True)
    return ret


def solution_banner(status: AlgorithmStatus) -> str:
    """Boxed final-status banner (``MessageHandler::PrintSolution``,
    ``src/MessageHandler.cpp:214-245``)."""
    status = AlgorithmStatus(int(status))
    text = _BANNERS[status]
    if status == AlgorithmStatus.PROBLEM_NOT_SOLVED:
        return text + "\n"
    inner = f"## {text} ##"
    bar = "#" * len(inner)
    return f"\n\n{bar}\n{inner}\n{bar}\n\n"


def print_solution(status: AlgorithmStatus, file=None) -> AlgorithmStatus:
    status = AlgorithmStatus(int(status))
    print(solution_banner(status), end="", file=file or sys.stdout,
          flush=True)
    return status
