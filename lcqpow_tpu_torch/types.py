"""Status enums mirroring the reference's public enums.

Reference: ``include/Utilities.hpp:37-129`` (``ReturnValue``,
``AlgorithmStatus``, ``PrintLevel``, ``QPSolver``).  Values are kept
numerically identical so downstream tooling can compare exit codes 1:1.
"""

import enum


class ReturnValue(enum.IntEnum):
    """Solver exit codes (subset of the reference's 61 codes that can occur
    in the batched build, plus the validation codes raised by the API layer).

    Reference: ``include/Utilities.hpp:37-87``.
    """

    NOT_YET_IMPLEMENTED = -1
    SUCCESSFUL_RETURN = 0

    # Invalid arguments
    INVALID_ARGUMENT = 100
    INVALID_PENALTY_UPDATE_VALUE = 101
    INVALID_COMPLEMENTARITY_TOLERANCE = 102
    INVALID_INITIAL_PENALTY_VALUE = 103
    INVALID_MAX_ITERATIONS_VALUE = 104
    INVALID_STATIONARITY_TOLERANCE = 105
    INVALID_NUMBER_OF_OPTIM_VARS = 106
    INVALID_NUMBER_OF_COMP_VARS = 107
    INVALID_NUMBER_OF_CONSTRAINT_VARS = 108
    INVALID_QPSOLVER = 109
    INVALID_OSQP_BOX_CONSTRAINTS = 110
    INVALID_TOTAL_ITER_COUNT = 111
    INVALID_TOTAL_OUTER_ITER = 112
    IVALID_SUBPROBLEM_ITER = 113  # [sic] - typo preserved from reference
    INVALID_RHO_OPT = 114
    INVALID_PRINT_LEVEL_VALUE = 115
    INVALID_OBJECTIVE_LINEAR_TERM = 116
    INVALID_CONSTRAINT_MATRIX = 117
    INVALID_COMPLEMENTARITY_MATRIX = 118
    INVALID_ETA_VALUE = 119
    INVALID_LOWER_COMPLEMENTARITY_BOUND = 120
    INVALID_MAX_RHO_VALUE = 121

    # Algorithmic errors
    MAX_ITERATIONS_REACHED = 200
    MAX_PENALTY_REACHED = 201
    INITIAL_SUBPROBLEM_FAILED = 202
    SUBPROBLEM_SOLVER_ERROR = 203
    FAILED_SYM_COMPLEMENTARITY_MATRIX = 204
    FAILED_SWITCH_TO_SPARSE = 205
    FAILED_SWITCH_TO_DENSE = 206
    OSQP_WORKSPACE_NOT_SET_UP = 207
    OSQP_INITIAL_PRIMAL_GUESS_FAILED = 208
    OSQP_INITIAL_DUAL_GUESS_FAILED = 209

    # Generic errors
    LCQPOBJECT_NOT_SETUP = 300
    INDEX_OUT_OF_BOUNDS = 301
    UNABLE_TO_READ_FILE = 302

    # Sparse matrices
    INVALID_INDEX_POINTER = 400
    INVALID_INDEX_ARRAY = 401
    DENSE_SPARSE_MISSMATCH = 402  # [sic] - typo preserved from reference


class AlgorithmStatus(enum.IntEnum):
    """Stationarity classification of the returned point.

    Reference: ``include/Utilities.hpp:103-109``.
    """

    PROBLEM_NOT_SOLVED = 0
    W_STATIONARY_SOLUTION = 1
    C_STATIONARY_SOLUTION = 2
    M_STATIONARY_SOLUTION = 3
    S_STATIONARY_SOLUTION = 4


class PrintLevel(enum.IntEnum):
    """Reference: ``include/Utilities.hpp:115-119``."""

    NONE = 0
    OUTER_LOOP_ITERATES = 1
    INNER_LOOP_ITERATES = 2


class QPSolver(enum.IntEnum):
    """Inner-QP solver selector.

    The reference dispatches to qpOASES (dense/sparse) or OSQP
    (``include/Utilities.hpp:125-129``).  Here all three map
    to the same batched dense ADMM+polish engine; the enum is kept because it
    controls *semantics* the reference ties to the backend:

    * ``QPOASES_DENSE`` / ``QPOASES_SPARSE``: box constraints supported; dual
      vector is ``[y_box(nV); y_A(nC); y_L; y_R]`` (nDuals = nV+nC+2*nComp).
    * ``OSQP_SPARSE``: box constraints rejected
      (``src/LCQProblem.cpp:929-957``); dual vector is
      ``[y_A; y_L; y_R]`` (nDuals = nC+2*nComp).

    ``ADMM_TPU`` (name kept from the JAX package) is the native alias (same
    semantics as OSQP_SPARSE but with box-constraint support — a capability
    extension over the reference).
    """

    QPOASES_DENSE = 0
    QPOASES_SPARSE = 1
    OSQP_SPARSE = 2
    ADMM_TPU = 3
