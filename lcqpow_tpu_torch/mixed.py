"""Mixed-precision solve: f32 predictor + compensated-f32 corrector, the
port of ``lcqpow_tpu/mixed.py``.

1. **Predictor (f32):** the homotopy solver (:func:`solver.solve`) in
   float32 with f32-meaningful tolerances (:func:`_predictor_options`); it
   settles the combinatorial part: final ``rho``, active set, branch of
   each complementarity pair.
2. **Corrector (double-word f32):** a bounded continuation of the homotopy
   in which each pass solves the linearized QP's active-set KKT system by
   mixed-precision iterative refinement: a plain-f32 regularized Schur
   complement is the preconditioner, residuals are evaluated in df32
   (:mod:`.ops.df32`) against exactly split problem data.
3. **Certification:** stationarity, complementarity and feasibility in df32
   against the reference-default tolerances; duals transformed
   (``src/LCQProblem.cpp:1381-1409``) and the point S/M/C/W-typed
   (``:1412-1453``).  Only a certified lane reports ``SUCCESSFUL_RETURN``.

Every stage is batched with a leading lane axis and per-lane loop masks
(see :mod:`.solvers.admm`).  The JAX module holds the measurements behind
each constant and branch; they are kept here unchanged.  The corrector's
KKT pass has the same three forms as the polish (uncompressed Schur,
compressed Schur, range space), and :func:`solve_batch_mixed` chunks
medium-shape fleets.  With several processes (``torch.distributed``),
see :func:`_resolve_kkt_form` and :func:`_escalate_failed`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from . import prng
from ._sync import any_, nonzero
from ._trace import span
from .constants import INFTY
from .data import LCQPData
from .ops import df32
from .ops.chol import spd_inverse, spd_inverse_light
from .ops.df32 import DF
from .ops.linalg import absmax as _amax, eye, lane_where, mtv, mv
from .options import Options
from .solver import Solution, _as_batch, _classify, _on_device, solve
from .solvers.admm import _ruiz_equilibrate, compress_rows, compression_cap
from .stats import Stats
from .types import AlgorithmStatus, PrintLevel, ReturnValue

_STAT_TOL_F32 = 5e-5
_COMPL_TOL_F32 = 1e-5
#: Schur regularization of the corrector's f32 preconditioner.
_DELTA = 1e-5
#: Regularization of the preconditioner Hessian inverse.
_DELTA_P = 1e-3
#: df32 refinement steps per KKT solve.
_REFINE_STEPS = 14

_F32 = torch.float32
_SUCCESS = int(ReturnValue.SUCCESSFUL_RETURN)


def _predictor_options(options: Options, m_rows: Optional[int] = None
                       ) -> Options:
    """f32-meaningful tolerances for the predictor, homotopy AND inner ADMM,
    with size-dependent floors (``m_rows`` = stacked constraint rows incl.
    box); identical to the JAX package's."""
    a = options.admm
    eps32 = 1.19209290e-07
    m = 0 if m_rows is None else int(m_rows)
    eps_floor = max(1e-5, 2.0 * eps32 * m)
    stat_floor = max(_STAT_TOL_F32, 4.0 * eps32 * m)
    compl_floor = max(_COMPL_TOL_F32, 2.0 * eps32 * m)
    admm_cfg = dataclasses.replace(
        a,
        eps_abs=max(a.eps_abs, eps_floor),
        eps_rel=max(a.eps_rel, eps_floor),
        # Effective equality-row penalty capped at ~10 in f32.
        rho_eq_scale=min(a.rho_eq_scale, 10.0 / max(a.rho, 1e-6)),
        eps_prim_inf=max(a.eps_prim_inf, 1e-6),
        eps_dual_inf=max(a.eps_dual_inf, 1e-6),
        polish_delta=max(a.polish_delta, 1e-5),
        polish_precond_delta=max(
            a.polish_delta if a.polish_precond_delta is None
            else a.polish_precond_delta, 1e-3),
        max_iter=min(a.max_iter, 250),
        check_interval=max(a.check_interval, 50) if m >= 300
        else a.check_interval,
    )
    return options.replace(
        stationarity_tolerance=max(options.stationarity_tolerance,
                                   stat_floor),
        complementarity_tolerance=max(options.complementarity_tolerance,
                                      compl_floor),
        # f32-meaningful penalty ceiling; the corrector continues the
        # schedule above it.
        max_penalty_parameter=min(options.max_penalty_parameter, 1e4),
        print_level=PrintLevel.NONE,
        tolerate_inner_maxiter=True,
        admm=admm_cfg,
    )


def _seg(a: DF, lo: int, hi: int) -> DF:
    return DF(a.hi[:, lo:hi], a.lo[:, lo:hi])


def _violation(Ax: DF, l: DF, u: DF, has_l, has_u):
    """Worst violation per lane of ``l <= Ax <= u`` over the rows that have
    the bound (``has_l``/``has_u``), never below 0.

    Each difference to a bound is taken in df32 and only then rounded to
    f32.  The JAX package rounds Ax to f32 first (``mixed.py:337-341``),
    which hides a violation below f32's spacing at |Ax| (2.4e-7 at |Ax| =
    2) from the certificate's 1e-9 (1 + max|Ax|) test (ROADMAP C-13)."""
    below, above = df32.sub(l, Ax), df32.sub(Ax, u)
    zero = below.hi.new_zeros(())
    viol = torch.maximum(
        torch.where(has_l, below.hi + below.lo, zero).amax(-1),
        torch.where(has_u, above.hi + above.lo, zero).amax(-1))
    return viol.clamp_min(0.0)


def correct_and_certify(data: LCQPData, options: Options,
                        x32, y32_out, rho, any_penalty_update,
                        pred_ret, pred_qp_flag,
                        n_corrector_iters: int = 25):
    """Compensated-f32 corrector + certifier for a batch of lanes.

    ``data`` is the float64 problem (split exactly into df32 words here);
    ``y32_out`` is in the mode-dependent output layout of
    :class:`solver.Solution`; ``any_penalty_update`` (per lane) selects the
    reference's ``g_tilde`` quirk.  Returns ``(x64, y64_out, ret, algo,
    rho_opt, corrector_steps, certified_stage)``, all per lane.
    """
    B, n = data.g.shape
    nC, nK = data.nC, data.nComp
    m0 = nC + 2 * nK
    m = m0 + n
    Ls, Rs = slice(nC, nC + nK), slice(nC + nK, m0)
    dev = data.Q.device
    beta = options.penalty_update_factor
    stat_tol = options.stationarity_tolerance
    compl_tol = options.complementarity_tolerance

    # ---- exact df32 splits of the problem data (one-time) ------------------
    A_int64 = torch.cat([data.A_full, eye(n, data.Q).expand(B, n, n)], dim=-2)
    l_int64 = torch.cat([data.lbA_full, data.lb], dim=-1).clamp(-INFTY, INFTY)
    u_int64 = torch.cat([data.ubA_full, data.ub], dim=-1).clamp(-INFTY, INFTY)
    Ahi, Alo = df32.split_mat(A_int64)
    Qhi, Qlo = df32.split_mat(data.Q)
    Chi, Clo = df32.split_mat(data.C)
    g_df = df32.from_f64(data.g)
    gphi_df = df32.from_f64(data.g_phi)
    l_df = df32.from_f64(l_int64)
    u_df = df32.from_f64(u_int64)

    l32, u32 = l_df.hi, u_df.hi
    eq = (u_int64 - l_int64) < 1e-12
    # Compare against the f32-cast INFTY (float32(1e20) rounds up).
    inf32 = torch.full((), INFTY, dtype=_F32, device=dev)
    has_l = l32 > -inf32
    has_u = u32 < inf32
    zero = torch.zeros((), dtype=_F32, device=dev)

    # f32 preconditioner pieces (one-time), in Ruiz-scaled space.  Medium
    # shapes in the range form build an n x n operator per pass instead of
    # masking the cached m x m Schur product (see admm._polish_solve).
    Dsc, Esc, csc, Qs, As_sc = _ruiz_equilibrate(Qhi, Ahi, g_df.hi)
    csc = csc[:, None]
    eps32 = torch.finfo(_F32).eps
    use_range = options.admm.kkt_form == "range" and m > n
    k_cap = compression_cap(n, m)
    if use_range:
        d_pen = torch.sqrt(torch.full((), _DELTA_P, dtype=_F32, device=dev)
                           / torch.full((), eps32, dtype=_F32, device=dev))
    else:
        Pinv = spd_inverse(Qs + _DELTA_P * eye(n, Qs))
        Hfull = As_sc @ (Pinv @ As_sc.mT)

    def Qx_df(x: DF) -> DF:
        return df32.split_matvec(Qhi, Qlo, x)

    def Cx_df(x: DF) -> DF:
        return df32.split_matvec(Chi, Clo, x)

    def Ax_df(x: DF) -> DF:
        return df32.split_matvec(Ahi, Alo, x)

    def Aty_df(y: DF) -> DF:
        return df32.split_matvec_t(Ahi, Alo, y)

    def g_tilde_df(rho32, upd):
        with_pen = df32.add(g_df, df32.mul_f32(gphi_df, rho32[:, None]))
        return df32.where(upd[:, None], with_pen, g_df)

    def stat_phi(x: DF, y: DF, rho32, upd):
        Cx = Cx_df(x)
        statk = df32.add(
            df32.sub(df32.add(Qx_df(x), df32.mul_f32(Cx, rho32[:, None])),
                     Aty_df(y)),
            g_tilde_df(rho32, upd))
        stat_norm = df32.max_abs(statk, axis=-1)
        # phi in product form, with slacks below the df32 measurement floor
        # snapped to zero (see the JAX module).
        Axv = Ax_df(x)
        sL = df32.sub(_seg(Axv, nC, nC + nK), _seg(l_df, nC, nC + nK))
        sR = df32.sub(_seg(Axv, nC + nK, m0), _seg(l_df, nC + nK, m0))
        u_snap = 32.0 * 2.0 ** -48
        keep = ((sL.hi + sL.lo).abs() > u_snap * (1.0 + Axv.hi[:, Ls].abs())) \
            & ((sR.hi + sR.lo).abs() > u_snap * (1.0 + Axv.hi[:, Rs].abs()))
        prod = df32.mul(sL, sR)
        phi = df32.sum_(DF(torch.where(keep, prod.hi, zero),
                           torch.where(keep, prod.lo, zero)))
        return stat_norm, phi.hi + phi.lo

    def primal_violation(x: DF):
        """Worst violation of the stacked system (df32), and max|Ax|."""
        Axv = Ax_df(x)
        return (_violation(Axv, l_df, u_df, has_l, has_u),
                _amax(Axv.hi + Axv.lo))

    def kkt_solve_pass(x: DF, y: DF, gk: DF, trust_duals, active):
        """One active-set KKT solve of the linearized QP per lane, via the
        f32 Schur preconditioner + df32 iterative refinement.  Returns the
        contracted-choice and raw final (x, nu) and the initial/best
        refinement residuals."""
        Gx0 = mv(Ahi, x.hi)
        near_low = has_l & ((Gx0 - l32).abs() <= 1e-5 * (1.0 + l32.abs()))
        near_up = has_u & ((Gx0 - u32).abs() <= 1e-5 * (1.0 + u32.abs()))
        viol_low = has_l & (Gx0 < l32)
        viol_up = has_u & (Gx0 > u32)
        y_tol = (1e-5 * (1.0 + _amax(y.hi)))[:, None]
        trust = trust_duals[:, None]
        sig_low = (y.hi > y_tol) & trust
        sig_up = (y.hi < -y_tol) & trust
        low = eq | ((sig_low | near_low | viol_low) & has_l)
        up = (sig_up | near_up | viol_up) & has_u & ~low
        act = low | up
        mf = act.to(_F32)

        G32 = As_sc * mf[:, :, None]
        if use_range:
            # Range-space preconditioner K = Qs + As'(d*mask)As, SPD for any
            # active set.
            dmf = d_pen * mf
            K = Qs + (As_sc * dmf[:, :, None]).mT @ As_sc
            regK = torch.maximum(
                torch.full((), _DELTA_P, dtype=_F32, device=dev),
                8.0 * eps32 * torch.diagonal(K, dim1=-2, dim2=-1))
            Kinv = spd_inverse_light(K + torch.diag_embed(regK))

            def precond(r1, r2):
                """Unscaled residuals in, unscaled corrections out; with
                r1 = Qx - G'nu + g the augmented-Lagrangian correction is
                dx = -Kinv(r1 + G'D r2), dnu = -D(G dx + r2); inactive rows
                carry r2 = nu and come out as dnu = -nu."""
                r1s = csc * Dsc * r1
                r2s_act = Esc * r2 * mf
                dxs = -mv(Kinv, r1s + mtv(As_sc, dmf * r2s_act))
                dnus_act = -(dmf * (mv(G32, dxs) + r2s_act))
                dnus = torch.where(act, dnus_act, -(csc * r2 / Esc))
                return Dsc * dxs, Esc * dnus / csc
        else:
            # f32 Schur preconditioner, compressed to the k_cap rows of
            # highest priority when k_cap < m; rows left out are inactive
            # and keep dnu = -nu.
            if k_cap < m:
                sel, actk, Hk, Gk = compress_rows(k_cap, act, eq, Hfull, G32)
            else:
                sel, actk, Hk, Gk = None, act, Hfull, G32
            mfk = actk.to(_F32)
            H = Hk * (mfk[:, :, None] * mfk[:, None, :])
            reg = torch.clamp_min(
                8.0 * eps32 * torch.diagonal(H, dim1=-2, dim2=-1), _DELTA)
            rvec = torch.where(actk, reg, 1.0)
            Sinv = spd_inverse_light(H + torch.diag_embed(rvec))

            def precond(r1, r2):
                """Unscaled residuals in, unscaled corrections out; the
                solve runs in Ruiz-scaled space, with the null-space dual
                cleanup ``dnus -= Sinv (r * dnus)``."""
                r1s = csc * Dsc * r1
                r2s = torch.where(act, Esc * r2, csc * r2 / Esc)
                r2sk = r2s if sel is None \
                    else torch.take_along_dim(r2s, sel, dim=1)
                t = mv(Gk, mv(Pinv, r1s)) - r2sk
                dnus = mv(Sinv, t)
                dnus = dnus - mv(Sinv, rvec * dnus)
                dxs = mv(Pinv, mtv(Gk, dnus) - r1s)
                if sel is not None:
                    dnus = torch.where(act, zero, -r2s).scatter(1, sel, dnus)
                return Dsc * dxs, Esc * dnus / csc

        b_df = DF(torch.where(low, l_df.hi, torch.where(up, u_df.hi, zero))
                  * mf,
                  torch.where(low, l_df.lo, torch.where(up, u_df.lo, zero))
                  * mf)
        Ghi, Glo = Ahi * mf[:, :, None], Alo * mf[:, :, None]

        nu = DF(y.hi * mf, y.lo * mf)
        xp = x
        big = torch.finfo(_F32).max
        k = torch.zeros(B, dtype=torch.int32, device=dev)
        res = torch.full((B,), big * 0.25, dtype=_F32, device=dev)
        res_prev = torch.full((B,), big, dtype=_F32, device=dev)
        res0 = torch.zeros(B, dtype=_F32, device=dev)
        xb, nub, res_best = xp, nu, res_prev
        # Iterative refinement with a stall exit (per lane): continue while
        # the residual shrank by at least 10% and the budget lasts.
        while True:
            run = active & (k < _REFINE_STEPS + 1) & (res < 0.9 * res_prev)
            if not any_(run):
                break
            r1 = df32.add(df32.sub(Qx_df(xp),
                                   df32.split_matvec_t(Ghi, Glo, nu)), gk)
            r2_act = df32.sub(df32.split_matvec(Ghi, Glo, xp), b_df)
            r1v = r1.hi + r1.lo
            r2v = torch.where(act, r2_act.hi, nu.hi) \
                + torch.where(act, r2_act.lo, nu.lo)
            res_new = torch.maximum(_amax(r1v), _amax(r2v))
            res0_n = torch.where(k == 0, res_new, res0)
            better = run & (res_new < res_best)
            xb = df32.where(better[:, None], xp, xb)
            nub = df32.where(better[:, None], nu, nub)
            res_best = torch.where(better, res_new, res_best)
            dx, dnu = precond(r1v, r2v)
            xp_n = df32.add(xp, df32.from_f32(dx))
            nu_n = df32.add(nu, df32.from_f32(dnu))
            r = run[:, None]
            xp = df32.where(r, xp_n, xp)
            nu = df32.where(r, nu_n, nu)
            res_prev = torch.where(run, res, res_prev)
            res = torch.where(run, res_new, res)
            res0 = torch.where(run, res0_n, res0)
            k = torch.where(run, k + 1, k)
        budget_exit = (res < 0.9 * res_prev)[:, None]
        xc = df32.where(budget_exit, xp, xb)
        nuc = df32.where(budget_exit, nu, nub)
        return xc, nuc, xp, nu, res0, res_best

    # ---- corrector loop -----------------------------------------------------
    x32 = x32.to(_F32)
    x0 = df32.from_f32(x32)
    y32_out = y32_out.to(_F32)
    if options.uses_box_duals:
        y_int32 = torch.cat([y32_out[:, n:], y32_out[:, :n]], dim=-1)
    else:
        y_int32 = torch.cat([y32_out, y32_out.new_zeros((B, n))], dim=-1)
    rho0 = rho.to(_F32)
    # A converged predictor reports transformed duals; undo the transform.
    Ax32 = mv(Ahi, x32)
    pred_conv = pred_ret == _SUCCESS
    yL_un = y_int32[:, Ls] + rho0[:, None] * Ax32[:, Rs]
    yR_un = y_int32[:, Rs] + rho0[:, None] * Ax32[:, Ls]
    y_untr = torch.cat([y_int32[:, :nC], yL_un, yR_un, y_int32[:, m0:]], -1)
    y_int32 = lane_where(pred_conv, y_untr, y_int32)

    x, y = x0, df32.from_f32(y_int32)
    rho32 = rho0
    upd = any_penalty_update.clone()
    k = 0
    false = torch.zeros(B, dtype=torch.bool, device=dev)
    done, conv, pen_fail = false, false, false
    steps = torch.zeros(B, dtype=torch.int32, device=dev)
    phi_prev = torch.full((B,), torch.finfo(_F32).max, dtype=_F32, device=dev)
    trust = ~false

    def drift_ok(xc: DF):
        return _amax(xc.hi - x0.hi) <= 8.0 * (1.0 + _amax(x0.hi))

    def finite(a: DF):
        return torch.isfinite(a.hi).all(-1)

    while True:
        run = ~done
        if not any_(run):
            break
        stat_norm, phi_val = stat_phi(x, y, rho32, upd)
        viol, ax_scale = primal_violation(x)
        feas = viol <= 1e-9 * (1.0 + ax_scale)
        conv_n = (stat_norm < stat_tol) & (phi_val < compl_tol) & feas
        stalled = phi_val.abs() > 0.5 * phi_prev.abs()
        far = phi_val.abs() > 1e4 * compl_tol
        stat_loose = stat_norm < torch.clamp_min(
            1e-5 * (1.0 + _amax(x.hi)), stat_tol)
        pen = feas & ~conv_n & ((stat_norm < stat_tol) & stalled
                                | stat_loose & far)
        rho32_n = torch.where(pen, rho32 * beta, rho32)
        upd_n = upd | pen
        pen_fail_n = rho32_n > options.max_penalty_parameter
        done_n = conv_n | pen_fail_n | (k >= n_corrector_iters)
        steps_n = steps + (~done_n).to(torch.int32)
        phi_prev_n = torch.where(done_n, phi_prev, phi_val)

        go = run & ~done_n
        x_n, y_n, trust_n = x, y, trust
        if any_(go):
            gk = df32.add(df32.mul_f32(Cx_df(x), rho32_n[:, None]),
                          g_tilde_df(rho32_n, upd_n))
            xn, yn, xf, yf, res0, resN = kkt_solve_pass(x, y, gk, trust, go)
            scale = 1.0 + _amax(x.hi)
            contracted = resN <= 0.9 * res0 + 1e-10
            ok_c = contracted & (_amax(xn.hi - x.hi) <= scale) & drift_ok(xn) \
                & finite(xn) & finite(yn)
            # Exact merit line search on the raw candidate
            # (getOptimalStepLength, src/LCQProblem.cpp:1217-1237).
            p = df32.sub(xf, x)
            pv = p.hi + p.lo
            r_ = rho32_n[:, None]
            Qkp = Qx_df(p).hi + r_ * Cx_df(p).hi
            qk_val = (pv * Qkp).sum(-1)
            gt = g_tilde_df(rho32_n, upd_n)
            lk_val = (pv * (Qx_df(x).hi + r_ * Cx_df(x).hi + gt.hi)).sum(-1)
            alpha = torch.where((qk_val > 0) & (lk_val < 0),
                                torch.clamp_max(-lk_val / qk_val, 1.0), 1.0)
            xf = df32.add(x, df32.mul_f32(p, alpha[:, None]))
            sn_new, _ = stat_phi(xf, yf, rho32_n, upd_n)
            sn_base, _ = stat_phi(x, y, rho32_n, upd_n)
            within = sn_new <= torch.clamp_min(100.0 * sn_base, stat_tol)
            ok_f = ~ok_c & within & (_amax(xf.hi - x.hi) <= scale) \
                & drift_ok(xf) & finite(xf) & finite(yf)
            oc, of = ok_c[:, None], ok_f[:, None]
            xo = df32.where(oc, xn, df32.where(of, xf, x))
            yo = df32.where(oc, yn, df32.where(of, yf, y))
            to = torch.where(ok_c | ok_f, trust, ~trust)
            g = go[:, None]
            x_n = df32.where(g, xo, x)
            y_n = df32.where(g, yo, y)
            trust_n = torch.where(go, to, trust)

        r = run[:, None]
        x, y = df32.where(r, x_n, x), df32.where(r, y_n, y)
        trust = torch.where(run, trust_n, trust)
        rho32 = torch.where(run, rho32_n, rho32)
        upd = torch.where(run, upd_n, upd)
        conv = torch.where(run, conv_n, conv)
        pen_fail = torch.where(run, pen_fail_n, pen_fail)
        steps = torch.where(run, steps_n, steps)
        phi_prev = torch.where(run, phi_prev_n, phi_prev)
        done = torch.where(run, done_n, done)
        k += 1
    certified = conv

    # ---- dual transform + stationarity typing (df32) -----------------------
    Ax = Ax_df(x)
    Lx = _seg(Ax, nC, nC + nK)
    Rx = _seg(Ax, nC + nK, m0)
    yL_t = df32.sub(_seg(y, nC, nC + nK), df32.mul_f32(Rx, rho32[:, None]))
    yR_t = df32.sub(_seg(y, nC + nK, m0), df32.mul_f32(Lx, rho32[:, None]))
    Lx_v, Rx_v = Lx.hi + Lx.lo, Rx.hi + Rx.lo
    yL_v, yR_v = yL_t.hi + yL_t.lo, yR_t.hi + yR_t.lo
    weak = (Lx_v <= compl_tol) & (Rx_v <= compl_tol)
    prod = yL_v * yR_v
    mn = torch.minimum(yL_v, yR_v)
    s_fail = weak & (mn < 0)
    mc_fail = weak & (prod.abs() >= compl_tol) & (mn <= 0)
    w_flag = mc_fail & (prod <= compl_tol)
    algo = _classify(w_flag.any(-1), s_fail.any(-1), mc_fail.any(-1))
    algo = torch.where(certified, algo,
                       int(AlgorithmStatus.PROBLEM_NOT_SOLVED)).to(torch.int32)

    # ---- recombine to f64 outputs -------------------------------------------
    x64 = df32.to_f64(x)
    y64 = df32.to_f64(y)
    cert = certified[:, None]
    yL64 = torch.where(cert, df32.to_f64(yL_t), y64[:, Ls])
    yR64 = torch.where(cert, df32.to_f64(yR_t), y64[:, Rs])
    y64 = torch.cat([y64[:, :nC], yL64, yR64, y64[:, m0:]], dim=-1)
    y_out = torch.cat([y64[:, m0:], y64[:, :m0]], dim=-1) \
        if options.uses_box_duals else y64[:, :m0]

    # A predictor MAX_PENALTY_REACHED that only hit the internal f32 rho
    # ceiling is a budget exhaustion.
    pred_ret_adj = torch.where(
        (pred_ret == int(ReturnValue.MAX_PENALTY_REACHED))
        & (rho32 <= options.max_penalty_parameter),
        int(ReturnValue.MAX_ITERATIONS_REACHED), pred_ret)
    ret = torch.where(
        certified, _SUCCESS,
        torch.where(pen_fail, int(ReturnValue.MAX_PENALTY_REACHED),
                    torch.where(pred_ret_adj != _SUCCESS, pred_ret_adj,
                                int(ReturnValue.MAX_ITERATIONS_REACHED)))
    ).to(torch.int32)
    stage = torch.where(certified, torch.where(steps == 0, 1, 2),
                        0).to(torch.int32)
    return x64, y_out, ret, algo, rho32.to(torch.float64), steps, stage


#: kkt_form="range" is admitted when the row-normalized constraint system's
#: lambda_max stays below this.
_RANGE_LAMBDA_MAX = 10.0


def _resolve_kkt_form(data: LCQPData, options: Options) -> Options:
    """Resolve ``ADMMOptions.kkt_form == "auto"`` from the problem structure
    (lane 0 of a batch): "schur" for m <= 64 or m <= n, else a power
    iteration on the row-normalized constraint system decides.  With a
    process group of several ranks it is "schur", as in the JAX package
    with several processes: each rank holds other lanes, and an estimate
    from each rank's lane 0 could give the ranks different forms."""
    if options.admm.kkt_form != "auto":
        return options
    n = data.nV
    m = data.nC + 2 * data.nComp + n
    if m <= 64 or m <= n or (dist.is_available() and dist.is_initialized()
                             and dist.get_world_size() > 1):
        return options.replace(admm=dataclasses.replace(
            options.admm, kkt_form="schur"))
    A = data.A_full.detach().to("cpu", torch.float64).numpy()
    if A.ndim == 3:
        A = A[0]
    form = "schur"
    if np.all(np.isfinite(A)):
        stacked = np.concatenate([A, np.eye(n)], axis=0)
        rn = np.linalg.norm(stacked, axis=1)
        rn[rn == 0] = 1.0
        An = stacked / rn[:, None]
        v = np.full(An.shape[0], An.shape[0] ** -0.5)
        lam = 0.0
        for _ in range(20):
            w = An @ (An.T @ v)
            lam = float(np.linalg.norm(w))
            if lam == 0.0:
                break
            v = w / lam
        form = "range" if lam <= _RANGE_LAMBDA_MAX else "schur"
    return options.replace(admm=dataclasses.replace(options.admm,
                                                    kkt_form=form))


def solve_mixed(data: LCQPData, options: Options = Options(),
                x0: Optional[torch.Tensor] = None,
                y0: Optional[torch.Tensor] = None,
                key=None,
                n_corrector_iters: int = 25) -> Solution:
    """Mixed-precision solve of a batch of LCQPs (leading lane axis on every
    field of ``data`` and on ``x0``/``y0``), or of one unbatched instance,
    on the device of ``data``.  Same contract as :func:`solver.solve`, the
    step-perturbation ``key`` included (it goes to the f32 predictor): an
    unbatched instance gets a lane axis for the solve, and every field of
    the :class:`Solution` loses it again."""
    x0, y0 = _on_device(data, x0), _on_device(data, y0)
    data, squeeze = _as_batch(data)
    if squeeze:
        x0 = None if x0 is None else x0.unsqueeze(0)
        y0 = None if y0 is None else y0.unsqueeze(0)
        sol = solve_mixed(data, options, x0=x0, y0=y0, key=key,
                          n_corrector_iters=n_corrector_iters)
        return sol.map(lambda a: a.squeeze(0))
    options = _resolve_kkt_form(data, options)
    data32 = data.map(lambda a: a.to(_F32))
    m_rows = data.nC + 2 * data.nComp + data.nV
    with span("predictor"):
        pred = solve(data32, _predictor_options(options, m_rows),
                     x0=None if x0 is None else x0.to(_F32),
                     y0=None if y0 is None else y0.to(_F32),
                     key=key)

    data64 = data.map(lambda a: a.to(torch.float64))
    updated = pred.stats.iter_outer > 0
    with span("corrector"):
        x, y_out, ret, algo, rho_opt, corr_steps, stage = \
            correct_and_certify(data64, options, pred.x, pred.y,
                                pred.stats.rho_opt, updated, pred.ret,
                                pred.stats.qp_exit_flag,
                                n_corrector_iters=n_corrector_iters)

    stats = Stats(
        iter_total=pred.stats.iter_total,
        iter_outer=pred.stats.iter_outer,
        subproblem_iter=pred.stats.subproblem_iter,
        rho_opt=rho_opt,
        solution_status=algo,
        qp_exit_flag=pred.stats.qp_exit_flag,
        trajectories=pred.stats.trajectories,
        corrector_steps=corr_steps,
        certified_stage=stage,
    )
    return Solution(x=x, y=y_out, ret=ret, algo_status=algo, stats=stats)


#: Auto-chunk budget of the JAX package: lanes * m^3 per chunk, just above
#: 32 * 505^3, so the circle shape (m = 503) chunks to 32 and the warm-up
#: shape (m = 14) is never chunked.
_AUTO_CHUNK_BUDGET = 4.2e9


def auto_chunk(batch: int, m: int) -> Optional[int]:
    """Chunk width :func:`solve_batch_mixed` picks when given none: at most
    32, and ``None`` (full width) when ``4.2e9 / m^3`` covers the batch.
    The JAX package sized it for its compiler; it is kept because a
    lockstep chunk runs as long as its slowest lane, on the card too."""
    cap = int(_AUTO_CHUNK_BUDGET / max(m, 1) ** 3)
    return max(1, min(32, cap)) if cap < batch else None


def solve_batch_mixed(data: LCQPData, options: Options = Options(),
                      x0: Optional[torch.Tensor] = None,
                      y0: Optional[torch.Tensor] = None,
                      key=None,
                      n_corrector_iters: int = 25,
                      escalate: int = 1,
                      chunk: Optional[int] = None) -> Solution:
    """Batched mixed-precision solve (leading lane axis on every field of
    ``data`` and on ``x0``/``y0``), with up to ``escalate`` host-side retry
    rounds of the uncertified lanes (:func:`_escalate_failed`).  Runs on
    the device of ``data``.  The root ``key`` (default
    ``PRNGKey(options.seed)``) is split over the fleet's lanes, as the JAX
    package splits it: a lane's key depends only on the root key and the
    lane's index.

    ``chunk``: solve the fleet ``chunk`` lanes at a time
    (:func:`batch.chunked_call`); ``None`` picks :func:`auto_chunk`'s
    width, ``0`` forces full width.  The keys are split over the whole
    fleet before it is cut into chunks, so a chunked solve draws what a
    full-width one draws."""
    from .batch import chunked_call

    with span("call"):
        options = options.replace(print_level=PrintLevel.NONE)
        options = _resolve_kkt_form(data, options)
        batch = data.Q.shape[0]
        key = prng.root_key(key, options.seed, data.Q.device)
        keys = prng.fleet_keys(key, options.seed, batch, data.Q.device)
        if chunk is None:
            chunk = auto_chunk(batch, data.nC + 2 * data.nComp + data.nV)

        def fn(d, k, x, y):
            return solve_mixed(d, options, x0=x, y0=y, key=k,
                               n_corrector_iters=n_corrector_iters)

        if chunk is not None and 0 < chunk <= batch:
            sol = chunked_call(fn, (data, keys, x0, y0), batch, chunk)
        else:
            sol = fn(data, keys, x0, y0)
        if escalate > 0:
            sol = _escalate_failed(sol, data, options, x0, y0, key,
                                   n_corrector_iters, escalate, chunk=chunk)
        return sol


def _merge_retry(sol: Solution, retry: Solution, round_idx: int) -> Solution:
    """Lane-wise merge: lanes uncertified in ``sol`` but certified in
    ``retry`` (same width) take the retry's values and the escalation stage
    code ``2 + round_idx + 1``."""
    fixed = (sol.ret != _SUCCESS) & (retry.ret == _SUCCESS)
    merged = sol.map(lambda old, new: lane_where(fixed, new, old), retry)
    if merged.stats.certified_stage is None:
        return merged
    st = torch.where(fixed, 2 + round_idx + 1,
                     merged.stats.certified_stage).to(torch.int32)
    return dataclasses.replace(
        merged, stats=dataclasses.replace(merged.stats, certified_stage=st))


#: Widest chunk of a chunked fleet's retry (the JAX package's).
RETRY_CHUNK = 8


def _escalate_failed(sol: Solution, data: LCQPData, options: Options,
                     x0, y0, key, n_corrector_iters: int,
                     rounds: int, chunk: Optional[int] = None) -> Solution:
    """Re-solve the uncertified lanes with escalating strategies and merge
    the certified retries back: round 0 a doubled corrector budget and
    fresh perturbation keys; round 1 a restart of the homotopy from the
    failed iterate; round >= 2 the original start with adaptive rho.
    Round ``r`` draws from ``fold_in(key, r + 1)`` of the root ``key``,
    split over the retried lanes, as the JAX package does.

    A chunked fleet retries at chunk width ``min(chunk, RETRY_CHUNK)``, as
    the JAX package does.  The JAX package also pads each retry to a power-of-two
    bucket of repeated lanes so that few shapes compile; nothing compiles
    here, so the retry holds the failed lanes only.  The padding does not
    change a retried lane's key (a split's first keys do not depend on how
    many it makes), so both retries draw alike.

    Several processes (``torch.distributed``): this same branch runs on
    each rank's own lanes.  The JAX package re-solves the whole fleet in
    each round when it runs over several hosts, because a host cannot
    index lanes that live on another host's chips; in torch every lane a
    rank holds is local to it, so the rank gathers its failed lanes as one
    process does.  That costs a retry of the failed lanes only, needs no
    collective (ranks may take different numbers of rounds), and gives each
    rank the result of a one-process solve of its lanes."""
    bad = nonzero(sol.ret != _SUCCESS)
    for r in range(rounds):
        if bad.numel() == 0:
            break
        with span("escalate"):
            take = lambda a: a.index_select(0, bad)
            sub = data.map(take)
            sx0 = None if x0 is None else take(x0)
            sy0 = None if y0 is None else take(y0)
            rbudget = max(25,
                          max(1, n_corrector_iters) * (2 if r == 0 else 1))
            ropts = options
            if r >= 1:
                sx0 = torch.nan_to_num(take(sol.x))
            if r >= 2:
                sx0 = None if x0 is None else take(x0)
                ropts = options.replace(admm=dataclasses.replace(
                    options.admm, adaptive_rho=True))
            retry = solve_batch_mixed(sub, ropts, x0=sx0, y0=sy0,
                                      key=prng.fold_in(key, r + 1),
                                      n_corrector_iters=rbudget, escalate=0,
                                      chunk=None if chunk is None
                                      else min(chunk, RETRY_CHUNK))
            full = sol.map(lambda a, b: a.index_copy(0, bad, b.to(a.dtype)),
                           retry)
            sol = _merge_retry(sol, full, r)
            bad = bad[nonzero(retry.ret != _SUCCESS)]
    return sol
