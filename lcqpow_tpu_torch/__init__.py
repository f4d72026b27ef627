"""lcqpow_tpu_torch — the PyTorch + CUDA port of ``lcqpow_tpu``.

A batched solver for Quadratic Programs with linear Complementarity
constraints (LCQPs): the penalty homotopy with the polish-first ADMM or the
block-pivot active-set (PAS) inner engine, the f32-predictor /
double-word-f32 corrector pipeline with certification and escalation,
chunked fleets, an f64 host audit of certified solutions, the
reference-compatible surface (the :class:`LCQProblem` object API, the
one-call :func:`api.lcqpow`, CSC and file ingestion, messages and
iteration printing) and multi-card fleets (:mod:`.parallel`).  The batch
axis is written out (every tensor carries a leading lane axis); the batched
SPD inverse of small orders at the heart of every polish and corrector KKT
solve is a hand-written CUDA kernel (``csrc/gj_inverse.cu``), built with
``nvcc`` at first use.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; the JAX package ``lcqpow_tpu`` is the reference the tests
hold this one to, and nothing of it is imported here.

Quick start::

    import lcqpow_tpu_torch as lt
    from lcqpow_tpu_torch.problems import warmup_fleet
    data = warmup_fleet(4096)                      # on the card
    sol = lt.solve_batch_mixed(data, lt.Options(print_level=lt.PrintLevel.NONE,
                                                max_iterations=200),
                               n_corrector_iters=6)
    print(int((sol.ret == 0).sum()), "certified")
"""

from . import _config  # noqa: F401  (pins f32 matmul precision)

from .constants import EPS, INFTY, ZERO
from .types import AlgorithmStatus, PrintLevel, QPSolver, ReturnValue
from .options import ADMMOptions, Options
from .data import LCQPData, LCQPError, make_lcqp, pad_lcqp, stack_lcqps
from .stats import Stats, Trajectories
from .solver import Solution, solve
from .mixed import solve_mixed, solve_batch_mixed
from .batch import solve_batch
from .compat import LCQProblem
from .audit import audit_solution
from .messages import message, print_message, print_solution, solution_banner
from . import api
from . import batch
from . import convert
from . import io
from . import messages
from . import ops
from . import parallel
from . import problems

__version__ = "0.2.0"

__all__ = [
    "EPS", "INFTY", "ZERO",
    "AlgorithmStatus", "PrintLevel", "QPSolver", "ReturnValue",
    "ADMMOptions", "Options",
    "LCQPData", "LCQPError", "make_lcqp", "pad_lcqp", "stack_lcqps",
    "Stats", "Trajectories",
    "Solution", "solve", "solve_mixed", "solve_batch_mixed",
    "solve_batch", "LCQProblem", "audit_solution",
    "message", "print_message", "print_solution", "solution_banner",
    "api", "batch", "convert", "io", "messages", "ops", "parallel",
    "problems",
]
