"""Solver options.

Mirrors the reference ``Options`` class (``include/Options.hpp``,
defaults at ``src/Options.cpp:296-333``): the same 14 algorithm
knobs with the same defaults and the same validation semantics (invalid values
emit a warning and are replaced by the default rather than raising), plus the
embedded inner-solver sub-configuration (the reference embeds a full
``qpOASES::Options``/``OSQPSettings``; here the inner solver is the batched
ADMM engine, configured by :class:`ADMMOptions`).

A value-identical copy of ``lcqpow_tpu/options.py``: same fields, defaults and
warn-and-restore validation, so options carry across packages unchanged
(:func:`lcqpow_tpu_torch.convert.options_from_dict`).  Both classes are frozen
dataclasses and hashable.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

from .constants import EPS
from .types import PrintLevel, QPSolver


def _warn(msg: str) -> None:
    warnings.warn(msg, stacklevel=3)


@dataclasses.dataclass(frozen=True)
class ADMMOptions:
    """Configuration of the inner batched ADMM QP engine.

    Plays the role of the reference's embedded ``OSQPSettings``
    (``src/Options.cpp:328-332`` sets ``eps_prim_inf=EPS``,
    ``verbose=false``, ``polish=true`` on top of OSQP defaults).  Parameter
    names follow OSQP where a counterpart exists.
    """

    rho: float = 0.1            # ADMM penalty on inequality rows
    rho_eq_scale: float = 1e3   # equality rows (l==u) use rho*rho_eq_scale
    sigma: float = 1e-6         # proximal regularization
    alpha: float = 1.6          # relaxation
    eps_abs: float = 1e-6       # ADMM tolerance (tighter than OSQP's 1e-3 but
    eps_rel: float = 1e-6       #   deliberately loose in absolute terms: the
                                #   polish-first active-set solve is the
                                #   accuracy engine and verifies candidates to
                                #   this same test at machine precision)
    eps_prim_inf: float = 1e-11  # infeasibility-certificate tolerance
    eps_dual_inf: float = 1e-11
    max_iter: int = 4000
    check_interval: int = 25    # convergence/infeasibility test cadence
    polish: bool = True         # active-set polish to machine precision
    # OSQP-style residual-ratio rho adaptation.  Opt-in: it rescues
    # badly-scaled QPs that stall at a fixed rho (see
    # tests/test_admm_adaptive.py) but perturbs the homotopy trajectory on
    # well-scaled problems, so the reference-parity default keeps it off.
    adaptive_rho: bool = False
    adaptive_rho_tolerance: float = 5.0  # refactorize when ratio drifts 5x
    polish_delta: float = 1e-8  # Schur regularization of the polish KKT solve
    # Regularization of the cached polish PRECONDITIONER Hessian inverse
    # (inv(Ps + polish_precond_delta I)).  Deliberately a separate, larger
    # knob: it bounds ||Pinv_d|| (and hence the Schur complement's norm and
    # f32 condition number), while the delta-induced bias is removed by the
    # refinement loop — measured on the circle problem's f32 predictor,
    # precond 1e-3 / Schur 1e-5 contracts the KKT residual ~30x/step vs
    # ~1.5x/step with both at 1e-5.  None -> falls back to polish_delta
    # (the f64 default behavior).
    polish_precond_delta: Optional[float] = None
    polish_refine_iter: int = 3
    polish_active_set_rounds: int = 3  # bounded active-set refinement rounds
    # Active-set removal rule per polish round:
    #   "murty"  — drop ALL wrong-signed multipliers at once (fast from cold
    #              starts: typical sets correct in 1-2 rounds);
    #   "single" — drop one worst wrong-signed row per round, only once
    #              primal-feasible (robust on degenerate sets, but a cold
    #              start needing k>rounds removals never converges);
    #   "hybrid" — drop all rows whose multiplier is *significantly*
    #              wrong-signed (relative deadband) plus the single worst
    #              marginal one; significance-gated mass eviction keeps the
    #              cold-start speed of murty without its noise-driven
    #              oscillation on degenerate sets.
    polish_drop_rule: str = "hybrid"
    # KKT solve form for the polish / corrector active-set systems:
    #   "schur" — m x m dual Schur complement (cached Hfull mask; the
    #             battle-tested default, robust to any row structure);
    #   "range" — n x n augmented-Lagrangian operator K = P + G'(d*mask)G
    #             (~4x fewer inverse FLOPs when m >> n, SPD on
    #             rank-deficient active sets) — VALID ONLY when constraint
    #             rows don't structurally accumulate onto few variables:
    #             lambda_max of the row-normalized AA' must stay small
    #             (~<= 8), else cond(K) overruns working precision (the
    #             circle problem's 100 lifting rows all couple (x1,x2):
    #             cond 9e6, measured f32 inverse residual 3.1);
    #   "auto"  — resolved by the mixed pipeline from that structural
    #             estimate when the problem data is host-available,
    #             otherwise treated as "schur".
    kkt_form: str = "auto"
    pas_max_pivots: int = 30    # pivot-round budget of the PAS engine
                                # (lcqpow_tpu/solvers/pas.py)

    def __post_init__(self):
        if self.rho <= 0:
            _warn("ADMMOptions.rho must be positive; using default 0.1.")
            object.__setattr__(self, "rho", 0.1)
        if self.sigma <= 0:
            _warn("ADMMOptions.sigma must be positive; using default 1e-6.")
            object.__setattr__(self, "sigma", 1e-6)
        if not (0.0 < self.alpha < 2.0):
            _warn("ADMMOptions.alpha must be in (0, 2); using default 1.6.")
            object.__setattr__(self, "alpha", 1.6)
        if self.max_iter <= 0:
            _warn("ADMMOptions.max_iter must be positive; using default 4000.")
            object.__setattr__(self, "max_iter", 4000)
        if self.polish_drop_rule not in ("murty", "single", "hybrid"):
            _warn("ADMMOptions.polish_drop_rule must be 'murty', 'single' or "
                  "'hybrid'; using default 'hybrid'.")
            object.__setattr__(self, "polish_drop_rule", "hybrid")
        if self.kkt_form not in ("auto", "schur", "range"):
            _warn("ADMMOptions.kkt_form must be 'auto', 'schur' or 'range'; "
                  "using default 'auto'.")
            object.__setattr__(self, "kkt_form", "auto")


@dataclasses.dataclass(frozen=True)
class Options:
    """Algorithm options (reference defaults, ``src/Options.cpp:296-333``)."""

    # Tolerances
    complementarity_tolerance: float = 1.0e3 * EPS
    stationarity_tolerance: float = 1.0e6 * EPS

    # Penalty homotopy
    initial_penalty_parameter: float = 0.01
    penalty_update_factor: float = 2.0
    max_penalty_parameter: float = 1e8

    # Strategies
    solve_zero_penalty_first: bool = True
    perturb_step: bool = True

    # Iteration limits
    max_iterations: int = 1000

    # Return the best tracked iterate (feasibility-first score) instead of
    # the final one on MAX_ITERATIONS_REACHED exits.  Deliberate deviation
    # from the reference (which always returns the last iterate): the f32
    # predictor can collapse late in a hard homotopy, and the final iterate
    # is then garbage while an earlier pass sat near the solution.  Success
    # and penalty/subproblem-failure exits are unaffected.
    keep_best_iterate: bool = True

    # Leyffer dynamic penalty check (src/LCQProblem.cpp:1275-1313)
    n_dynamic_penalty: int = 3
    eta_dynamic_penalty: float = 0.9

    # Observability
    print_level: PrintLevel = PrintLevel.INNER_LOOP_ITERATES
    store_steps: bool = False

    # Inner solver selection + config.  ``qp_solver`` keeps the reference's
    # enum *semantics* (dual-vector layout, box-constraint rejection — see
    # types.QPSolver); ``inner_solver`` is the orthogonal strategy arg
    # (SURVEY.md §7) choosing the engine behind one signature:
    #   "admm" — OSQP-style ADMM + polish (solvers/admm.py, the default)
    #   "pas"  — parametric active-set, the qpOASES analogue (JAX
    #            package only so far: lcqpow_tpu/solvers/pas.py)
    qp_solver: QPSolver = QPSolver.QPOASES_DENSE
    inner_solver: str = "admm"
    admm: ADMMOptions = dataclasses.field(default_factory=ADMMOptions)

    # Extension over the reference: when True, an inner-QP MAX-ITER exit (OSQP flag
    # -2) does NOT abort the homotopy — the loop continues from the solver's
    # best iterate and the convergence tests keep governing termination.
    # Infeasibility certificates (-3/-4) still abort like the reference's
    # SUBPROBLEM_SOLVER_ERROR path (src/LCQProblem.cpp:548-551).  The mixed
    # pipeline's f32 predictor enables this: near the f32 residual noise
    # floor an occasional budget exhaustion is expected and harmless (the
    # df32 corrector restores accuracy), while aborting throws away an
    # almost-converged homotopy.  Default False = reference semantics.
    tolerate_inner_maxiter: bool = False

    # Seed of the step perturbation's torch.Generator.  The reference calls
    # srand(time(NULL)) per solve (src/LCQProblem.cpp:1016) and is therefore
    # nondeterministic; an explicit seed makes solves repeatable.
    seed: int = 0

    def __post_init__(self):
        # Validating setters: warn + restore default, matching the reference's
        # setter behavior (src/Options.cpp — each setter warns and keeps the
        # previous/default value on invalid input).
        if self.complementarity_tolerance < EPS:
            _warn("complementarity_tolerance must be >= machine precision; "
                  "using default.")
            object.__setattr__(self, "complementarity_tolerance", 1.0e3 * EPS)
        if self.stationarity_tolerance < EPS:
            _warn("stationarity_tolerance must be >= machine precision; "
                  "using default.")
            object.__setattr__(self, "stationarity_tolerance", 1.0e6 * EPS)
        if self.initial_penalty_parameter <= 0:
            _warn("initial_penalty_parameter must be positive; using default.")
            object.__setattr__(self, "initial_penalty_parameter", 0.01)
        if self.penalty_update_factor <= 1:
            _warn("penalty_update_factor must be > 1; using default.")
            object.__setattr__(self, "penalty_update_factor", 2.0)
        if self.max_penalty_parameter <= 0:
            _warn("max_penalty_parameter must be positive; using default.")
            object.__setattr__(self, "max_penalty_parameter", 1e8)
        if self.max_iterations <= 0:
            _warn("max_iterations must be a positive integer; using default.")
            object.__setattr__(self, "max_iterations", 1000)
        if self.n_dynamic_penalty > 0 and not (0 < self.eta_dynamic_penalty < 1):
            _warn("eta_dynamic_penalty must be in (0, 1); using default.")
            object.__setattr__(self, "eta_dynamic_penalty", 0.9)
        if not isinstance(self.print_level, PrintLevel):
            object.__setattr__(self, "print_level", PrintLevel(self.print_level))
        if not isinstance(self.qp_solver, QPSolver):
            object.__setattr__(self, "qp_solver", QPSolver(self.qp_solver))
        if self.inner_solver not in ("admm", "pas"):
            _warn("inner_solver must be 'admm' or 'pas'; using default "
                  "'admm'.")
            object.__setattr__(self, "inner_solver", "admm")

    # Convenience: functional update preserving validation.
    def replace(self, **kw) -> "Options":
        return dataclasses.replace(self, **kw)

    @property
    def uses_box_duals(self) -> bool:
        """qpOASES-parity modes carry an nV-long box-dual block
        (``src/LCQProblem.cpp:888-935``)."""
        return self.qp_solver in (QPSolver.QPOASES_DENSE, QPSolver.QPOASES_SPARSE)
