"""The penalty-homotopy solver: the port of ``lcqpow_tpu/solver.py``.

The reference's ``LCQProblem::runSolver`` (``src/LCQProblem.cpp:444-560``)
as a batched lockstep loop: every lane carries its own ``done`` flag, each
pass runs the loop body for the lanes that are not done and leaves the
carry of finished lanes unchanged, as ``lax.while_loop`` does under
``vmap`` in the JAX package (``batch.py:6-9``).  The loop semantics are the
JAX package's, which replicate the reference (fused inner/outer loop,
linearization updated twice per pass, Leyffer dynamic penalty check, the
stale-``statk`` stationarity test, the ``g_tilde`` quirk, exact merit line
search, dual transform and S/M/C/W typing on convergence); see that module
for the citations.

Step perturbation draws ``{-1, 0, 1} * eps`` per coordinate from a
per-lane Threefry key carried in the loop state, split once a pass as the
JAX package splits its key (:mod:`.prng`, one kernel launch a pass on the
card): from the same keys the port draws the JAX package's bits.

The inner QP engine is chosen by ``Options.inner_solver`` through
``_INNER_ENGINES``: the polish-first ADMM (:mod:`.solvers.admm`) or the
block-pivot active-set engine (:mod:`.solvers.pas`); both share one
workspace and one signature.

Iteration printing: an unbatched solve (one instance, ``print_level >
NONE``) prints the reference's INNER or OUTER table
(``printIteration``/``printHeader``, ``src/LCQProblem.cpp:1528-1637``), as
the JAX package's ``solve`` does.  Each pass then reads its row's eight
scalars to the host once.  A batched solve prints nothing, whatever
``print_level`` says: the JAX package prints only from an unbatched solve
(its ``solve_batch`` and the mixed predictor force ``NONE``), and a table of
lanes that run in lockstep would interleave them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import prng
from ._sync import any_
from .data import LCQPData
from .ops.linalg import absmax, eye, lane_where, mtv, mv
from .options import Options
from .solvers import admm, pas
from .stats import Stats, Trajectories
from .types import AlgorithmStatus, PrintLevel, ReturnValue

# Inner-engine dispatch; both engines share QPWorkspace/ADMMState.
_INNER_ENGINES = {"admm": admm.solve, "pas": pas.solve}

# The INNER and OUTER tables of printIteration/printHeader
# (src/LCQProblem.cpp:1528-1637), with the JAX package's formats.
_INNER_HLINE = ("------+-------+------------+------------+------------"
                "+------------+------------+-------")
_INNER_HEADER = (_INNER_HLINE + "\n outer | inner |  station   |  complem   |"
                 "    rho     |   norm p   |   alpha    | sub it\n"
                 + _INNER_HLINE)
_OUTER_HLINE = "------+------------+------------+------------+------------"
_OUTER_HEADER = (_OUTER_HLINE + "\n outer |  station   |  complem   |"
                 "    rho     |   norm p\n" + _OUTER_HLINE)


def print_iteration(level: PrintLevel, outer: int, inner: int, stat: float,
                    phi: float, rho: float, norm_p: float, alpha: float,
                    sub_iters: int) -> None:
    """One row of the iteration table at ``level``, with its header where
    the cadence asks: INNER prints every pass, a header every 10 inner
    iterations; OUTER prints only passes with ``inner == 0`` (the pass
    after a penalty update), a header every 10 outer iterations."""
    if level == PrintLevel.INNER_LOOP_ITERATES:
        if inner % 10 == 0:
            print(_INNER_HEADER)
        print(f"{outer:6d} | {inner:5d} | {stat:10.3e} | {phi:10.3e} | "
              f"{rho:10.3e} | {norm_p:10.3e} | {alpha:10.3e} | "
              f"{sub_iters:6d}", flush=True)
    elif level == PrintLevel.OUTER_LOOP_ITERATES and inner == 0:
        if outer % 10 == 0:
            print(_OUTER_HEADER)
        print(f"{outer:6d} | {stat:10.3e} | {phi:10.3e} | {rho:10.3e} | "
              f"{norm_p:10.3e}", flush=True)


@dataclasses.dataclass(frozen=True)
class Solution:
    """Result of a batched solve; every field has the lane axis leading.

    ``y`` follows the mode-dependent reference layout
    (``src/LCQProblem.cpp:888-960``): ``[y_box(nV); y_A(nC); y_L; y_R]`` for
    qpOASES-parity modes, ``[y_A; y_L; y_R]`` otherwise.
    """

    x: torch.Tensor            # (B, nV)
    y: torch.Tensor            # (B, nDuals)
    ret: torch.Tensor          # (B,) int32 ReturnValue
    algo_status: torch.Tensor  # (B,) int32 AlgorithmStatus
    stats: Stats

    @property
    def success(self):
        return self.ret == int(ReturnValue.SUCCESSFUL_RETURN)

    def map(self, fn, *others: "Solution") -> "Solution":
        """Apply ``fn`` field-wise to the per-lane tensors of this and
        ``others``."""
        return Solution(
            x=fn(self.x, *(o.x for o in others)),
            y=fn(self.y, *(o.y for o in others)),
            ret=fn(self.ret, *(o.ret for o in others)),
            algo_status=fn(self.algo_status,
                           *(o.algo_status for o in others)),
            stats=self.stats.map(fn, *(o.stats for o in others)))


def _phi(data: LCQPData, x):
    """phi(x) = (Lx-lbL)'(Rx-lbR), in the cancellation-free product form."""
    return ((mv(data.L, x) - data.lbL) * (mv(data.R, x) - data.lbR)).sum(-1)


def _obj(data: LCQPData, x):
    return (data.g * x).sum(-1) + 0.5 * (x * mv(data.Q, x)).sum(-1)


def _merit(data: LCQPData, x, rho):
    """g'x + 1/2 x'Qk x, replicating ``getMerit`` (``:1188-1196``)."""
    return (data.g * x).sum(-1) + 0.5 * (x * mv(data.Q, x)).sum(-1) \
        + 0.5 * rho * (x * mv(data.C, x)).sum(-1)


def _determine_stationarity(data: LCQPData, x, yL, yR, compl_tol):
    """Per-lane ``determineStationarityType`` (``src/LCQProblem.cpp:1412-1453``)."""
    Lx = mv(data.L, x)
    Rx = mv(data.R, x)
    weak = (Lx <= compl_tol) & (Rx <= compl_tol)
    prod = yL * yR
    mn = torch.minimum(yL, yR)
    s_fail = weak & (mn < 0)
    mc_fail = weak & (prod.abs() >= compl_tol) & (mn <= 0)
    w_flag = mc_fail & (prod <= compl_tol)
    return _classify(w_flag.any(-1), s_fail.any(-1), mc_fail.any(-1))


def _classify(any_w, any_s_fail, any_mc_fail):
    AS = AlgorithmStatus
    return torch.where(
        any_w, int(AS.W_STATIONARY_SOLUTION),
        torch.where(~any_s_fail, int(AS.S_STATIONARY_SOLUTION),
                    torch.where(~any_mc_fail, int(AS.M_STATIONARY_SOLUTION),
                                int(AS.C_STATIONARY_SOLUTION)))
    ).to(torch.int32)


def build_workspace(data: LCQPData, options: Options) -> admm.QPWorkspace:
    """Assemble the internal constraint system ``[A; L; R; box]`` per lane
    and factorize once."""
    n = data.nV
    B = data.Q.shape[0]
    A_int = torch.cat([data.A_full, eye(n, data.Q).expand(B, n, n)], dim=-2)
    l_int = torch.cat([data.lbA_full, data.lb], dim=-1)
    u_int = torch.cat([data.ubA_full, data.ub], dim=-1)
    return admm.factorize(data.Q, A_int, l_int, u_int, options.admm,
                          q_proto=data.g)


def _on_device(data: LCQPData, a):
    """An initial guess as a tensor on the device of ``data``."""
    return None if a is None else torch.as_tensor(a, device=data.Q.device)


def _as_batch(data: LCQPData):
    """(data with a lane axis, whether one was added)."""
    if data.Q.ndim == 2:
        return data.map(lambda a: a.unsqueeze(0)), True
    return data, False


def solve(data: LCQPData, options: Options = Options(),
          x0: Optional[torch.Tensor] = None,
          y0: Optional[torch.Tensor] = None,
          key=None) -> Solution:
    """Solve a batch of LCQPs (leading lane axis on every field of
    ``data`` and on ``x0``/``y0``), or one unbatched instance.  Runs on the
    device of ``data``.  ``key`` feeds the step perturbation: per-lane keys
    (B, 2) for a batch, or one key (2,) (every lane of a batch starts from
    it); by default ``prng.prng_key(options.seed)``, as the JAX package's
    ``solve`` takes ``PRNGKey(options.seed)`` (see :func:`prng.lane_keys`).
    ``x0`` and ``y0`` may be tensors or array-likes.  Only an unbatched
    solve prints its iterations (``options.print_level``)."""
    x0, y0 = _on_device(data, x0), _on_device(data, y0)
    data, squeeze = _as_batch(data)
    print_level = options.print_level if squeeze else PrintLevel.NONE
    if squeeze:
        x0 = None if x0 is None else x0.unsqueeze(0)
        y0 = None if y0 is None else y0.unsqueeze(0)
    B, n = data.g.shape
    nC, nK = data.nC, data.nComp
    m0 = nC + 2 * nK
    m_int = m0 + n
    dtype = data.Q.dtype
    dev = data.Q.device
    cfg = options.admm
    nhist = max(int(options.n_dynamic_penalty), 1)
    i32 = torch.int32
    keys0 = prng.lane_keys(key, B, options.seed, dev)

    ws = build_workspace(data, options)

    xk0 = torch.zeros((B, n), dtype=dtype, device=dev) if x0 is None \
        else x0.to(dtype).contiguous()
    if y0 is None:
        yk0 = torch.zeros((B, m_int), dtype=dtype, device=dev)
    else:
        y0 = y0.to(dtype).reshape(B, -1)
        if y0.shape[1] == n + m0:
            # Reference qpOASES layout [box; A; L; R] -> internal [A; L; R; box].
            yk0 = torch.cat([y0[:, n:], y0[:, :n]], dim=-1)
        elif y0.shape[1] == m0:
            yk0 = torch.cat([y0, y0.new_zeros((B, n))], dim=-1)
        else:
            raise ValueError(f"y0 must have length {m0} or {n + m0}")

    # ADMM warm start (OSQP sign is the negative of the LCQPow convention,
    # src/SubsolverOSQP.cpp:196-199).
    st0 = admm.init_state(ws, xk0 if x0 is not None else None,
                          -yk0 if y0 is not None else None)

    rho0 = torch.full((B,), options.initial_penalty_parameter, dtype=dtype,
                      device=dev)
    g_tilde0 = data.g      # NOT g + rho0*g_phi — reference quirk.

    if options.solve_zero_penalty_first:
        gk0 = data.g
    else:
        gk0 = rho0[:, None] * mv(data.C, xk0) + g_tilde0

    def qp_failed(status):
        if options.tolerate_inner_maxiter:
            return (status == admm.ADMM_PRIMAL_INFEASIBLE) \
                | (status == admm.ADMM_DUAL_INFEASIBLE) | (status == 0)
        return status <= 0

    inner_solve = _INNER_ENGINES[options.inner_solver]
    res0 = inner_solve(ws, gk0, st0, cfg)
    yk_full0 = -res0.y
    init_failed = qp_failed(res0.status)

    stat_tol = options.stationarity_tolerance
    compl_tol = options.complementarity_tolerance
    beta = options.penalty_update_factor
    # The step perturbation of a pass (one kernel launch on the card),
    # checked here once for the solve's keys, iterate shape and stream;
    # every pass's xk is an elementwise result of contiguous tensors.
    perturb = prng.perturbation(keys0, xk0, torch.finfo(dtype).eps) \
        if options.perturb_step else None

    store = options.store_steps
    T = options.max_iterations + 2
    traj = None
    if store:
        nan = float("nan")
        fz = lambda *s: torch.full((B, T) + s, nan, dtype=dtype, device=dev)
        iz = lambda: torch.zeros((B, T), dtype=i32, device=dev)
        traj = dict(x_steps=fz(n), inner_iters=iz(), subproblem_iters=iz(),
                    accu_subproblem_iters=iz(), step_length=fz(),
                    step_size=fz(), stat_vals=fz(), obj_vals=fz(),
                    phi_vals=fz(), merit_vals=fz())

    def full(v, dt=i32):
        return torch.full((B,), v, dtype=dt, device=dev)

    inf_ = float("inf")
    c = dict(
        xk=xk0, yk=yk_full0, pk=res0.x - xk0,
        statk=torch.zeros((B, n), dtype=dtype, device=dev), gk=gk0,
        g_tilde=g_tilde0, rho=rho0, alphak=full(1.0, dtype),
        st_x=res0.state.x, st_z=res0.state.z, st_y=res0.state.y,
        hist=torch.zeros((B, nhist), dtype=dtype, device=dev),
        hist_n=full(0), inner=full(0), outer=full(0), total=full(0),
        sub_iters=res0.iterations, qp_flag=res0.status,
        qp_iter_k=res0.iterations, done=init_failed,
        qp_streak=full(0), streak_stat0=full(inf_, dtype),
        streak_phi0=full(inf_, dtype),
        ret=torch.where(init_failed,
                        int(ReturnValue.SUBPROBLEM_SOLVER_ERROR),
                        int(ReturnValue.SUCCESSFUL_RETURN)).to(i32),
        algo=full(int(AlgorithmStatus.PROBLEM_NOT_SOLVED)),
        x_best=xk0, y_best=yk_full0, score_best=full(inf_, dtype),
        key=keys0,
    )
    lanes = torch.arange(B, device=dev)

    def Qk_mv(rho, v):
        return mv(data.Q, v) + rho[:, None] * mv(data.C, v)

    while True:
        run = ~c["done"]
        if not any_(run):
            break
        rho = c["rho"]
        # 1. updateStep (:479, :1240-1243)
        xk = c["xk"] + c["alphak"][:, None] * c["pk"]
        # 2. updateStationarity (:482, :1246-1272)
        statk = Qk_mv(rho, xk) + c["g_tilde"] - mtv(ws.A, c["yk"])
        phi_k = _phi(data, xk)
        stat_abs = absmax(statk)

        if options.keep_best_iterate:
            Axk = mv(ws.A, xk)
            Axc = torch.clamp(Axk, ws.l, ws.u)
            viol = ((Axk - Axc).clamp_min(0.0)
                    + (Axc - Axk).clamp_min(0.0)).amax(-1)
            score = viol * 1e6 + stat_abs + phi_k.abs()
            better = torch.isfinite(score) & (score < c["score_best"])
            x_best = lane_where(better, xk, c["x_best"])
            y_best = lane_where(better, c["yk"], c["y_best"])
            score_best = torch.where(better, score, c["score_best"])
        else:
            x_best, y_best, score_best = c["x_best"], c["y_best"], \
                c["score_best"]

        # 3. printIteration (:485), one lane.
        if print_level > PrintLevel.NONE:
            row = torch.stack([
                t[0].to(torch.float64) for t in (
                    c["outer"], c["inner"], stat_abs, phi_k, rho,
                    absmax(c["pk"]), c["alphak"], c["qp_iter_k"])]).tolist()
            print_iteration(print_level, int(row[0]), int(row[1]), *row[2:7],
                            int(row[7]))

        if store:
            idx = c["total"].long()
            sel = lanes[run]
            at = idx[run]
            for name, val in (
                    ("x_steps", xk), ("inner_iters", c["inner"]),
                    ("subproblem_iters", c["qp_iter_k"]),
                    ("accu_subproblem_iters", c["sub_iters"]),
                    ("step_length", c["alphak"]),
                    ("step_size", absmax(c["pk"])),
                    ("stat_vals", stat_abs), ("obj_vals", _obj(data, xk)),
                    ("phi_vals", phi_k),
                    ("merit_vals", _merit(data, xk, rho))):
                traj[name][sel, at] = val[run].to(traj[name].dtype)

        # 5. counters (:493-496)
        total = c["total"] + 1
        inner = c["inner"] + 1

        # 6. Leyffer dynamic penalty (:499-505, :1275-1313)
        g_tilde = c["g_tilde"]
        outer = c["outer"]
        hist, hist_n = c["hist"], c["hist_n"]
        if options.n_dynamic_penalty > 0:
            nh = options.n_dynamic_penalty
            warmup = hist_n < nh
            compl_ok_now = phi_k < compl_tol
            progress = (phi_k[:, None]
                        < options.eta_dynamic_penalty * hist).any(-1) & ~warmup
            fired = ~warmup & ~compl_ok_now & ~progress
            pushed_warm = hist.clone()
            pushed_warm[lanes, hist_n.clamp(0, nh - 1).long()] = phi_k
            pushed_ring = torch.cat([hist[:, 1:], phi_k[:, None]], dim=-1)
            hist_push = lane_where(warmup, pushed_warm, pushed_ring)
            hist = lane_where(fired, torch.zeros_like(hist), hist_push)
            hist_n = torch.where(fired, 0,
                                 torch.clamp_max(hist_n + 1, nh)).to(i32)
            rho = torch.where(fired, rho * beta, rho)
            g_tilde = lane_where(fired, data.g + rho[:, None] * data.g_phi,
                                 g_tilde)
            outer = (outer + fired.to(i32)).to(i32)
            inner = torch.where(fired, 0, inner).to(i32)

        # 7. updateLinearization #1 (:508)
        gk = rho[:, None] * mv(data.C, xk) + g_tilde

        # 8. termination / penalty branch (:511-534), stale statk.
        stat_ok = stat_abs < stat_tol
        compl_ok = phi_k < compl_tol
        converged = stat_ok & compl_ok

        yk = c["yk"]
        yL = yk[:, nC:nC + nK] - rho[:, None] * mv(data.R, xk)
        yR = yk[:, nC + nK:m0] - rho[:, None] * mv(data.L, xk)
        yk_conv = torch.cat([yk[:, :nC], yL, yR, yk[:, m0:]], dim=-1)
        algo_conv = _determine_stationarity(data, xk, yL, yR, compl_tol)
        yk = lane_where(converged, yk_conv, yk)
        algo = torch.where(converged, algo_conv, c["algo"]).to(i32)
        done = converged
        ret = torch.where(converged, int(ReturnValue.SUCCESSFUL_RETURN),
                          c["ret"]).to(i32)

        # stationary but not complementary -> penalty update (:528-533)
        pen2 = stat_ok & ~compl_ok
        rho = torch.where(pen2, rho * beta, rho)
        g_tilde = lane_where(pen2, data.g + rho[:, None] * data.g_phi,
                             g_tilde)
        outer = (outer + pen2.to(i32)).to(i32)
        inner = torch.where(pen2, 0, inner).to(i32)
        if options.n_dynamic_penalty > 0:
            hist = lane_where(pen2, torch.zeros_like(hist), hist)
            hist_n = torch.where(pen2, 0, hist_n).to(i32)

        # 9./10. failure terminations (:537-542)
        hit_iter = ~done & (total > options.max_iterations)
        ret = torch.where(hit_iter, int(ReturnValue.MAX_ITERATIONS_REACHED),
                          ret).to(i32)
        done = done | hit_iter
        hit_rho = ~done & (rho > options.max_penalty_parameter)
        ret = torch.where(hit_rho, int(ReturnValue.MAX_PENALTY_REACHED),
                          ret).to(i32)
        done = done | hit_rho

        # 11.-14. next-step computation (:545-558) for lanes still going.
        go = run & ~done
        gk2 = rho[:, None] * mv(data.C, xk) + g_tilde
        st = admm.ADMMState(c["st_x"], c["st_z"], c["st_y"])
        res = inner_solve(ws, gk2, st, cfg, active=go)
        pt_ok = torch.isfinite(res.x).all(-1) & torch.isfinite(res.y).all(-1)
        xnew = lane_where(pt_ok, res.x, xk)
        yk_new = lane_where(pt_ok, -res.y, yk)
        st_next = res.state.select(pt_ok, st)
        pk_c = xnew - xk
        qp_fail_c = qp_failed(res.status)
        keys = c["key"]
        if perturb is not None:
            # perturbStep (:554-555): each lane still going splits its key,
            # draws randint(sub, (n,), -1, 2) and adds it times eps to xk;
            # the others keep their key and xk bit for bit (a running lane
            # that is not going is done, as in the JAX package's done
            # branch; the carry's freeze discards the rest's pass).
            keys, xk = perturb(keys, go, xk)
        qk_val = (pk_c * Qk_mv(rho, pk_c)).sum(-1)
        lk_val = (pk_c * (Qk_mv(rho, xk) + g_tilde)).sum(-1)
        alphak_c = torch.where((qk_val > 0) & (lk_val < 0),
                               torch.clamp_max(-lk_val / qk_val, 1.0),
                               1.0).to(dtype)

        yk = lane_where(done, yk, yk_new)
        pk = lane_where(done, c["pk"], pk_c)
        alphak = torch.where(done, c["alphak"], alphak_c)
        st = st.select(done, st_next)
        sub_iters = torch.where(done, c["sub_iters"],
                                c["sub_iters"] + res.iterations).to(i32)
        qp_flag = torch.where(done, c["qp_flag"], res.status).to(i32)
        qp_iter_k = torch.where(done, c["qp_iter_k"], res.iterations).to(i32)
        qp_fail = ~done & qp_fail_c
        ret = torch.where(qp_fail, int(ReturnValue.SUBPROBLEM_SOLVER_ERROR),
                          ret).to(i32)
        done = done | qp_fail

        # Persistent inner-failure hand-off (tolerant mode only), see the
        # JAX module: stop at the last sane iterate when a run of exhausted
        # inner solves coincides with blown-up stationarity and stalled
        # complementarity.
        if options.tolerate_inner_maxiter:
            exhausted = qp_flag == admm.ADMM_MAX_ITER
            abs_phi = phi_k.abs()
            streak_started = exhausted & (c["qp_streak"] == 0)
            qp_streak = torch.where(
                done, c["qp_streak"],
                torch.where(exhausted, c["qp_streak"] + 1, 0)).to(i32)
            streak_stat0 = torch.where(
                done, c["streak_stat0"],
                torch.where(streak_started, stat_abs,
                            torch.where(exhausted, c["streak_stat0"], inf_)))
            streak_phi0 = torch.where(
                done, c["streak_phi0"],
                torch.where(streak_started, abs_phi,
                            torch.where(exhausted, c["streak_phi0"], inf_)))
            stall = ~done & (qp_streak >= 3) \
                & (stat_abs > 10.0 * torch.clamp_min(streak_stat0, stat_tol)) \
                & (abs_phi >= 0.9 * streak_phi0)
            ret = torch.where(stall, int(ReturnValue.MAX_ITERATIONS_REACHED),
                              ret).to(i32)
            done = done | stall
        else:
            qp_streak = c["qp_streak"]
            streak_stat0 = c["streak_stat0"]
            streak_phi0 = c["streak_phi0"]

        new = dict(
            xk=xk, yk=yk, pk=pk, statk=statk, gk=gk, g_tilde=g_tilde,
            rho=rho, alphak=alphak, st_x=st.x, st_z=st.z, st_y=st.y,
            hist=hist, hist_n=hist_n, inner=inner, outer=outer, total=total,
            sub_iters=sub_iters, qp_flag=qp_flag, qp_iter_k=qp_iter_k,
            done=done, qp_streak=qp_streak, streak_stat0=streak_stat0,
            streak_phi0=streak_phi0, ret=ret, algo=algo, x_best=x_best,
            y_best=y_best, score_best=score_best, key=keys)
        # The keys skip the freeze (hazard C-3): the perturbation kept the
        # key of every lane not going, and go is a subset of run.
        c = {k: new[k] if k == "key" else lane_where(run, new[k], c[k])
             for k in c}

    xk, yk = c["xk"], c["yk"]
    if options.keep_best_iterate:
        # On an iteration-budget failure hand over the best tracked iterate.
        swap = (c["ret"] == int(ReturnValue.MAX_ITERATIONS_REACHED)) \
            & torch.isfinite(c["score_best"])
        xk = lane_where(swap, c["x_best"], xk)
        yk = lane_where(swap, c["y_best"], yk)

    y_A_full = yk[:, :m0]
    y_box = yk[:, m0:]
    y_out = torch.cat([y_box, y_A_full], dim=-1) if options.uses_box_duals \
        else y_A_full

    stats = Stats(
        iter_total=c["total"], iter_outer=c["outer"],
        subproblem_iter=c["sub_iters"], rho_opt=c["rho"],
        solution_status=c["algo"], qp_exit_flag=c["qp_flag"],
        trajectories=Trajectories(**traj) if store else None)
    sol = Solution(x=xk, y=y_out, ret=c["ret"], algo_status=c["algo"],
                   stats=stats)
    return sol.map(lambda a: a.squeeze(0)) if squeeze else sol
