"""Batched dense ADMM QP engine: the port of ``lcqpow_tpu/solvers/admm.py``.

An OSQP-style ADMM on one dense representation with a polish-first
active-set solve (see the JAX module for the design and its references).
The batch axis is written out: every tensor carries a leading lane axis
``B``, per-lane scalars have shape ``(B,)``.  The JAX package's
``lax.while_loop``/``fori_loop``s become host loops over masked lane state:
a lane whose loop condition is false keeps its carry unchanged
(:func:`lane_where`), as the batching rule of ``while_loop`` does under
``vmap``, so each lane computes what the unbatched solve computes.  The
loops run while any lane of ``active`` still runs; lanes outside ``active``
(finished lanes of an enclosing loop) never extend a loop and their outputs
are meaningless.

Internal constraint row order is ``[A (nC); L; R; box (nV)]``.  Exit flags
follow OSQP's ``status_val``: 1 solved, -2 max-iter, -3 primal infeasible,
-4 dual infeasible.

The active-set KKT solve (:func:`_polish_solve`) has the JAX package's
three forms: the uncompressed Schur form, the Schur form compressed to
``n + 64`` rows (rounded up to 32) when m is larger, and the range-space
form (``kkt_form="range"``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .._sync import any_
from ..constants import INFTY, ZERO
from ..ops.chol import spd_inverse, spd_inverse_light
from ..ops.linalg import absmax as _amax, eye, lane_where, mtv, mv
from ..options import ADMMOptions

ADMM_SOLVED = 1
ADMM_MAX_ITER = -2
ADMM_PRIMAL_INFEASIBLE = -3
ADMM_DUAL_INFEASIBLE = -4

_RHO_MIN = 1e-6
_RHO_MAX = 1e6


@dataclasses.dataclass(frozen=True)
class QPWorkspace:
    """Per-lane precomputed state: scaling, penalties, and the one-time
    KKT-operator inverse reused by every subproblem solve of the homotopy."""

    P: torch.Tensor      # (B, n, n)
    A: torch.Tensor      # (B, m, n)
    l: torch.Tensor      # (B, m)
    u: torch.Tensor      # (B, m)
    D: torch.Tensor      # (B, n)   Ruiz: x = D xs
    E: torch.Tensor      # (B, m)   Ruiz: y = E ys / c
    c: torch.Tensor      # (B,)
    Ps: torch.Tensor     # (B, n, n)
    As: torch.Tensor     # (B, m, n)
    ls: torch.Tensor     # (B, m)
    us: torch.Tensor     # (B, m)
    rho_vec: torch.Tensor   # (B, m)
    rho_inv: torch.Tensor   # (B, m)
    eq_mask: torch.Tensor   # (B, m) bool
    loose_mask: torch.Tensor  # (B, m) bool
    Pinv_d: torch.Tensor    # (B, n, n) inv(Ps + delta I)
    Hfull: torch.Tensor     # (B, m, m) As Pinv_d As'
    Minv: torch.Tensor      # (B, n, n) inv(Ps + sigma I + As' diag(rho) As)


@dataclasses.dataclass(frozen=True)
class ADMMState:
    """Warm-startable iterate (scaled space)."""

    x: torch.Tensor   # (B, n)
    z: torch.Tensor   # (B, m)
    y: torch.Tensor   # (B, m)

    def select(self, mask, other: "ADMMState") -> "ADMMState":
        """Lane-wise ``mask ? self : other``."""
        return ADMMState(*(lane_where(mask, a, b) for a, b in
                           zip(dataclasses.astuple(self),
                               dataclasses.astuple(other))))


@dataclasses.dataclass(frozen=True)
class ADMMResult:
    x: torch.Tensor        # (B, n) unscaled primal solution
    y: torch.Tensor        # (B, m) unscaled dual (OSQP sign convention)
    status: torch.Tensor   # (B,) int32, OSQP status_val convention
    iterations: torch.Tensor  # (B,) int32
    state: ADMMState


def _ruiz_equilibrate(P, A, q_proto, n_iters: int = 10):
    """Modified Ruiz equilibration of [[P, A'], [A, 0]] plus OSQP-style
    cost normalization, per lane.  Returns (D, E, c, Ps, As)."""
    B, n = P.shape[0], P.shape[-1]
    m = A.shape[-2]
    D = P.new_ones((B, n))
    E = P.new_ones((B, m))
    c = P.new_ones((B,))
    Ps, As, qs = P, A, q_proto
    one = P.new_ones(())
    for _ in range(n_iters):
        dnorm = torch.maximum(_amax(Ps, -2), _amax(As, -2))
        enorm = _amax(As, -1)
        dd = torch.where(dnorm > ZERO, 1.0 / torch.sqrt(dnorm), one)
        de = torch.where(enorm > ZERO, 1.0 / torch.sqrt(enorm), one)
        Ps = dd[:, :, None] * Ps * dd[:, None, :]
        As = de[:, :, None] * As * dd[:, None, :]
        qs = dd * qs
        D = D * dd
        E = E * de
        pc = _amax(Ps, -2).mean(-1)
        qn = _amax(qs)
        denom = torch.maximum(pc, qn)
        gamma = torch.where(denom > ZERO, 1.0 / denom, one)
        Ps = gamma[:, None, None] * Ps
        qs = gamma[:, None] * qs
        c = c * gamma
    D = D.clamp(1e-3, 1e3)
    E = E.clamp(1e-3, 1e3)
    c = c.clamp(1e-4, 1e4)
    Ps = c[:, None, None] * D[:, :, None] * P * D[:, None, :]
    As = E[:, :, None] * A * D[:, None, :]
    return D, E, c, Ps, As


def _kkt_operator(ws_Ps, ws_As, rho, sigma):
    n = ws_Ps.shape[-1]
    return ws_Ps + sigma * eye(n, ws_Ps) + (ws_As * rho[..., None]).mT @ ws_As


def factorize(P, A, l, u, cfg: ADMMOptions, q_proto=None) -> QPWorkspace:
    """One-time setup per lane: equilibrate, pick per-row penalties,
    invert the KKT operator (``src/SubsolverQPOASES.cpp:144-160``)."""
    l = l.clamp(-INFTY, INFTY)
    u = u.clamp(-INFTY, INFTY)
    if q_proto is None:
        q_proto = torch.zeros_like(P[..., 0])
    D, E, c, Ps, As = _ruiz_equilibrate(P, A, q_proto)

    ls = E * l
    us = E * u

    loose = (l <= -INFTY) & (u >= INFTY)
    eq = (u - l) < 1e-12
    rho = torch.full_like(l, cfg.rho)
    rho = torch.where(eq, min(max(cfg.rho * cfg.rho_eq_scale, _RHO_MIN),
                              _RHO_MAX), rho)
    rho = torch.where(loose, _RHO_MIN, rho)

    n = P.shape[-1]
    Minv = spd_inverse(_kkt_operator(Ps, As, rho, cfg.sigma))
    dP = cfg.polish_precond_delta
    if dP is None:
        dP = cfg.polish_delta
    Pinv_d = spd_inverse(Ps + dP * eye(n, Ps))
    Hfull = As @ (Pinv_d @ As.mT)

    return QPWorkspace(P=P, A=A, l=l, u=u, D=D, E=E, c=c,
                       Ps=Ps, As=As, ls=ls, us=us,
                       rho_vec=rho, rho_inv=1.0 / rho, eq_mask=eq,
                       loose_mask=loose, Pinv_d=Pinv_d, Hfull=Hfull,
                       Minv=Minv)


def init_state(ws: QPWorkspace, x0=None, y0=None) -> ADMMState:
    """Warm start from an (unscaled, OSQP-sign) primal/dual guess."""
    xs = torch.zeros_like(ws.D) if x0 is None else x0 / ws.D
    ys = torch.zeros_like(ws.E) if y0 is None else y0 * ws.c[:, None] / ws.E
    return ADMMState(x=xs, z=mv(ws.As, xs), y=ys)


def _residuals(ws: QPWorkspace, qs, xs, zs, ys):
    """Unscaled primal/dual residuals and their termination scales."""
    Einv = 1.0 / ws.E
    Dinv = 1.0 / ws.D
    cinv = (1.0 / ws.c)[:, None]
    Ax = Einv * mv(ws.As, xs)
    z_un = Einv * zs
    r_prim = _amax(Ax - z_un)
    Px = Dinv * mv(ws.Ps, xs) * cinv
    Aty = Dinv * mtv(ws.As, ys) * cinv
    q_un = Dinv * qs * cinv
    r_dual = _amax(Px + q_un + Aty)
    prim_scale = torch.maximum(_amax(Ax), _amax(z_un))
    dual_scale = torch.maximum(torch.maximum(_amax(Px), _amax(Aty)),
                               _amax(q_un))
    return r_prim, r_dual, prim_scale, dual_scale


def _infeasibility(ws: QPWorkspace, qs, dxs, dys, cfg: ADMMOptions):
    """OSQP primal/dual infeasibility certificates on unscaled deltas."""
    dy = ws.E * dys / ws.c[:, None]
    dx = ws.D * dxs
    ndy = _amax(dy)
    ndx = _amax(dx)

    Atdy = _amax(mtv(ws.A, dy))
    zero = dy.new_zeros(())
    sup = (torch.where(dy > 0, ws.u * dy, zero)
           + torch.where(dy < 0, ws.l * dy, zero)).sum(-1)
    prim_inf = (ndy > ZERO) & (Atdy <= cfg.eps_prim_inf * ndy) \
        & (sup <= -cfg.eps_prim_inf * ndy)

    Pdx = _amax(mv(ws.P, dx))
    q_un = qs / (ws.D * ws.c[:, None])
    qdx = (q_un * dx).sum(-1)
    Adx = mv(ws.A, dx)
    thr = (cfg.eps_dual_inf * ndx)[:, None]
    up_ok = torch.where(ws.u < INFTY, Adx <= thr, True).all(-1)
    lo_ok = torch.where(ws.l > -INFTY, Adx >= -thr, True).all(-1)
    dual_inf = (ndx > ZERO) & (Pdx <= cfg.eps_dual_inf * ndx) \
        & (qdx <= -cfg.eps_dual_inf * ndx) & up_ok & lo_ok
    return prim_inf, dual_inf


def stable_top_k(prio: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest entries of each row of ``prio``, ties
    taken by lower index: the order of ``lax.top_k``, which the JAX package
    ranks its compression priorities with (``torch.topk`` breaks the ties
    differently, and nearly every priority is tied)."""
    return torch.sort(prio, dim=-1, descending=True,
                      stable=True).indices[..., :k]


def gather_rows(M: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """``M[b, sel[b], ...]`` per lane: rows of a (B, m, ...) tensor."""
    idx = sel.reshape(sel.shape + (1,) * (M.ndim - 2))
    return torch.take_along_dim(M, idx, dim=1)


def compress_rows(k_cap: int, act, eq_mask, Hfull, G):
    """Active-set compression: the ``k_cap`` rows of highest priority per
    lane (active, then equality; ties by lower index, as ``lax.top_k``
    takes them; on overflow active rows beyond the cap are dropped, as in
    the JAX package).  Returns ``(sel, act, Hfull, G)`` restricted to
    them."""
    sel = stable_top_k(act.to(G.dtype) + eq_mask.to(G.dtype), k_cap)
    Hk = torch.take_along_dim(gather_rows(Hfull, sel), sel[:, None, :],
                              dim=2)
    return (sel, torch.take_along_dim(act, sel, dim=1), Hk,
            gather_rows(G, sel))


def compression_cap(n: int, m: int) -> int:
    """Rows kept by the active-set compression: ``n + 64`` rounded up to a
    multiple of 32, at most ``m``.  Compression is on when it is below m."""
    return min(m, -(-(n + 64) // 32) * 32)


def _polish_solve(ws: QPWorkspace, q, low, up, cfg: ADMMOptions):
    """Equality-KKT solve on the masked active set in the Ruiz-scaled space;
    the result is unscaled (``x = D xs``, ``nu = E nus / c``).

    Three forms, chosen as in the JAX package:

    * range (``kkt_form == "range"`` and m > n): the n x n
      augmented-Lagrangian operator ``K = Ps + As'(d*mask)As`` with the
      balanced penalty ``d = sqrt(sig/eps_w)``, ``polish_refine_iter + 3``
      refinement steps from zero;
    * Schur, compressed when ``compression_cap(n, m) < m``: the rows of
      highest priority (active, then equality; ties by lower index) are
      gathered, the k x k masked Schur complement of the cached ``Hfull``
      is solved, and the duals are scattered back to the full layout;
    * Schur, uncompressed otherwise.

    Every Schur form regularizes relative to its diagonal at the working
    precision and refines ``polish_refine_iter`` times."""
    n = ws.Ps.shape[-1]
    m = ws.As.shape[-2]
    dtype = ws.P.dtype
    act = low | up
    mf = act.to(dtype)
    c = ws.c[:, None]
    qs = c * ws.D * q
    zero = mf.new_zeros(())
    b = torch.where(low, ws.ls, torch.where(up, ws.us, zero))
    b = b.clamp(-INFTY, INFTY) * mf
    G = ws.As * mf[:, :, None]
    eps_w = torch.tensor(torch.finfo(dtype).eps, dtype=dtype,
                         device=mf.device)

    if cfg.kkt_form == "range" and m > n:
        dP = cfg.polish_precond_delta
        if dP is None:
            dP = cfg.polish_delta
        sig = torch.tensor(dP, dtype=dtype, device=mf.device)
        dmf = torch.sqrt(sig / eps_w) * mf
        K = ws.Ps + (ws.As * dmf[:, :, None]).mT @ ws.As
        reg = torch.maximum(sig, 8.0 * eps_w
                            * torch.diagonal(K, dim1=-2, dim2=-1))
        Kinv = spd_inverse_light(K + torch.diag_embed(reg))
        x_pol = torch.zeros_like(qs)
        nu = torch.zeros_like(mf)
        for _ in range(cfg.polish_refine_iter + 3):
            r1 = mv(ws.Ps, x_pol) + qs + mtv(G, nu)
            r2 = mv(G, x_pol) - b
            dx = -mv(Kinv, r1 + mtv(ws.As, dmf * r2))
            dnu = dmf * (mv(G, dx) + r2)
            x_pol, nu = x_pol + dx, nu + dnu
        return ws.D * x_pol, torch.where(act, ws.E * nu / c, zero)

    k_cap = compression_cap(n, m)
    if k_cap < m:
        sel, actk, Hk, Gk = compress_rows(k_cap, act, ws.eq_mask, ws.Hfull, G)
        bk = torch.take_along_dim(b, sel, dim=1)
    else:
        sel, actk, Hk, Gk, bk = None, act, ws.Hfull, G, b
    mfk = actk.to(dtype)
    H = Hk * (mfk[:, :, None] * mfk[:, None, :])
    reg = torch.clamp_min(8.0 * torch.finfo(dtype).eps
                          * torch.diagonal(H, dim1=-2, dim2=-1),
                          cfg.polish_delta)
    S = H + torch.diag_embed(torch.where(actk, reg, 1.0))
    Sinv = spd_inverse_light(S)

    nu = mv(Sinv, -(bk + mv(Gk, mv(ws.Pinv_d, qs))))
    x_pol = -mv(ws.Pinv_d, qs + mtv(Gk, nu))

    for _ in range(cfg.polish_refine_iter):
        r1 = mv(ws.Ps, x_pol) + qs + mtv(Gk, nu)
        r2 = mv(Gk, x_pol) - bk
        dnu = mv(Sinv, r2 - mv(Gk, mv(ws.Pinv_d, r1)))
        dx = -mv(ws.Pinv_d, r1 + mtv(Gk, dnu))
        x_pol, nu = x_pol + dx, nu + dnu
    if sel is not None:
        nu = torch.zeros_like(mf).scatter(1, sel, nu)
    return ws.D * x_pol, torch.where(act, ws.E * nu / c, zero)


def _kkt_ok(ws: QPWorkspace, q, x, y, cfg: ADMMOptions):
    """Full KKT acceptance test per lane (unscaled): primal feasibility,
    stationarity, complementary slackness and dual-sign feasibility."""
    Ax = mv(ws.A, x)
    rp = _amax(Ax - torch.clamp(Ax, ws.l, ws.u))
    Px = mv(ws.P, x)
    Aty = mtv(ws.A, y)
    rd = _amax(Px + q + Aty)
    psc = _amax(Ax)
    dsc = torch.maximum(torch.maximum(_amax(Px), _amax(Aty)), _amax(q))
    zero = x.new_zeros(())
    du = torch.where((y > 0) & ~ws.eq_mask,
                     torch.where(ws.u < INFTY, (Ax - ws.u).abs(), 1.0), zero)
    dl = torch.where((y < 0) & ~ws.eq_mask,
                     torch.where(ws.l > -INFTY, (Ax - ws.l).abs(), 1.0), zero)
    rc = (y.abs() * (du + dl)).amax(-1)
    eps_p = cfg.eps_abs + cfg.eps_rel * psc
    eps_d = cfg.eps_abs + cfg.eps_rel * dsc
    eps_c = (cfg.eps_abs + cfg.eps_rel * dsc) * (1.0 + psc)
    finite = torch.isfinite(x).all(-1) & torch.isfinite(y).all(-1)
    return finite & (rp <= eps_p) & (rd <= eps_d) & (rc <= eps_c)


def _polish(ws: QPWorkspace, q, y, cfg: ADMMOptions, rounds=None,
            active: Optional[torch.Tensor] = None):
    """Exact active-set solve seeded from dual signs (OSQP convention: y<0
    lower-active, y>0 upper-active; equality rows always active), with up
    to ``rounds`` (default ``cfg.polish_active_set_rounds``) refinement
    rounds that add violated rows and drop wrong-signed ones per
    ``cfg.polish_drop_rule``, stopping per lane at the first candidate that
    passes :func:`_kkt_ok`."""
    has_l = ws.l > -INFTY
    has_u = ws.u < INFTY
    low = ws.eq_mask | ((y < 0) & has_l)
    up = (y > 0) & has_u & ~low

    x_pol, y_pol = _polish_solve(ws, q, low, up, cfg)
    found = _kkt_ok(ws, q, x_pol, y_pol, cfg)
    if active is None:
        active = torch.ones_like(found)
    rule = cfg.polish_drop_rule
    zero = y.new_zeros(())
    n_rounds = int(cfg.polish_active_set_rounds if rounds is None else rounds)
    lanes = torch.arange(y.shape[0], device=y.device)
    for _ in range(n_rounds):
        run = active & ~found
        if not any_(run):
            break
        Ax = mv(ws.A, x_pol)
        rp = _amax(Ax - torch.clamp(Ax, ws.l, ws.u))
        low_n = (low | (Ax < ws.l - cfg.polish_delta) | ws.eq_mask) & has_l
        up_n = (up | (Ax > ws.u + cfg.polish_delta)) & has_u & ~low_n
        wrong = torch.where(low_n & ~ws.eq_mask, y_pol.clamp_min(0.0), zero) \
            + torch.where(up_n & ~ws.eq_mask, (-y_pol).clamp_min(0.0), zero)
        if rule == "murty":
            drop = wrong > 0
        else:
            feas = rp <= cfg.eps_abs * (1.0 + _amax(Ax))
            worst = torch.argmax(wrong, dim=-1)
            w_worst = wrong[lanes, worst]
            if rule == "single":
                drop = torch.zeros_like(low_n)
                drop[lanes, worst] = feas & (w_worst > 0)
            else:  # hybrid (default)
                y_scale = 1.0 + _amax(y_pol)
                drop = wrong > 1e-4 * y_scale[:, None]
                drop[lanes, worst] = drop[lanes, worst] | (feas & (w_worst > 0))
        low_n = low_n & ~drop
        up_n = up_n & ~drop
        x_n, y_n = _polish_solve(ws, q, low_n, up_n, cfg)
        found_n = _kkt_ok(ws, q, x_n, y_n, cfg)
        x_pol = lane_where(run, x_n, x_pol)
        y_pol = lane_where(run, y_n, y_pol)
        low = lane_where(run, low_n, low)
        up = lane_where(run, up_n, up)
        found = torch.where(run, found_n, found)
    return x_pol, y_pol


def _state_of(ws: QPWorkspace, x, y) -> ADMMState:
    """Scaled ADMM state consistent with an (unscaled) primal/dual point."""
    return ADMMState(x=x / ws.D,
                     z=ws.E * torch.clamp(mv(ws.A, x), ws.l, ws.u),
                     y=y * ws.c[:, None] / ws.E)


def _refactor(ws: QPWorkspace, rho_vec, rho_inv, Minv, rho_new, sigma):
    """Re-invert the KKT operator at ``rho_new`` (loose rows keep their
    penalty); lanes whose new inverse is not finite keep the old one."""
    rho_new = torch.where(ws.loose_mask, rho_vec, rho_new)
    Minv_new = spd_inverse(_kkt_operator(ws.Ps, ws.As, rho_new, sigma))
    ok = torch.isfinite(Minv_new).all(-1).all(-1)
    return (lane_where(ok, rho_new, rho_vec),
            lane_where(ok, 1.0 / rho_new, rho_inv),
            lane_where(ok, Minv_new, Minv))


def solve(ws: QPWorkspace, q, state: ADMMState, cfg: ADMMOptions,
          active: Optional[torch.Tensor] = None) -> ADMMResult:
    """Solve ``min 1/2 x'Px + q'x  s.t.  l <= Ax <= u`` per lane from a
    warm start: a polish-first exact active-set attempt, then ADMM as the
    active-set predictor, checked every ``check_interval`` iterations
    (convergence, infeasibility certificates, a one-round polish), with a
    breakdown restart (10x stiffer rho) and opt-in adaptive rho."""
    dtype = ws.P.dtype
    B = q.shape[0]
    c = ws.c[:, None]
    qs = c * ws.D * q
    sigma = cfg.sigma
    alpha = torch.tensor(cfg.alpha, dtype=dtype, device=q.device)
    K = int(cfg.check_interval)
    if active is None:
        active = torch.ones(B, dtype=torch.bool, device=q.device)
    i32 = torch.int32

    x_un0 = ws.D * state.x
    y_un0 = ws.E * state.y / c

    if cfg.polish:
        x_try, y_try = _polish(ws, q, y_un0, cfg, active=active)
        ok0 = _kkt_ok(ws, q, x_try, y_try, cfg)
        x_out = lane_where(ok0, x_try, x_un0)
        y_out = lane_where(ok0, y_try, y_un0)
        status = torch.where(ok0, ADMM_SOLVED, 0).to(i32)
    else:
        x_out, y_out = x_un0, y_un0
        status = torch.zeros(B, dtype=i32, device=q.device)

    xs, zs, ys = state.x, state.z, state.y
    xp, yp = state.x, state.y
    it = torch.zeros(B, dtype=i32, device=q.device)
    rho_vec, rho_inv, Minv = ws.rho_vec, ws.rho_inv, ws.Minv

    while True:
        run = active & (status == 0) & (it < cfg.max_iter)
        if not any_(run):
            break
        xs_n, zs_n, ys_n = xs, zs, ys
        for _ in range(K):
            rhs = sigma * xs_n - qs + mtv(ws.As, rho_vec * zs_n - ys_n)
            x_t = mv(Minv, rhs)
            z_t = mv(ws.As, x_t)
            x_new = alpha * x_t + (1 - alpha) * xs_n
            z_rel = alpha * z_t + (1 - alpha) * zs_n
            z_new = torch.clamp(z_rel + rho_inv * ys_n, ws.ls, ws.us)
            ys_n = ys_n + rho_vec * (z_rel - z_new)
            xs_n, zs_n = x_new, z_new
        it_n = it + K

        # Breakdown guard with restart: reset non-finite or exploded lanes
        # and make their operator 10x stiffer.
        finite_ok = torch.isfinite(xs_n).all(-1) & torch.isfinite(zs_n).all(-1) \
            & torch.isfinite(ys_n).all(-1)
        exploded = finite_ok & (_amax(xs_n) > 1e6)
        bad = ~finite_ok | exploded
        xs_n = lane_where(bad, torch.zeros_like(xs_n), xs_n)
        zs_n = lane_where(bad, torch.zeros_like(zs_n), zs_n)
        ys_n = lane_where(bad, torch.zeros_like(ys_n), ys_n)
        rho_n, rinv_n, Minv_n = rho_vec, rho_inv, Minv
        stiff = bad & run
        if any_(stiff):
            r, ri, Mi = _refactor(ws, rho_vec, rho_inv, Minv,
                                  (rho_vec * 10.0).clamp(_RHO_MIN, _RHO_MAX),
                                  sigma)
            rho_n = lane_where(bad, r, rho_n)
            rinv_n = lane_where(bad, ri, rinv_n)
            Minv_n = lane_where(bad, Mi, Minv_n)

        x_un = ws.D * xs_n
        y_un = ws.E * ys_n / c

        r_prim, r_dual, psc, dsc = _residuals(ws, qs, xs_n, zs_n, ys_n)
        eps_p = cfg.eps_abs + cfg.eps_rel * psc
        eps_d = cfg.eps_abs + cfg.eps_rel * dsc
        solved_admm = (r_prim <= eps_p) & (r_dual <= eps_d)

        prim_inf, dual_inf = _infeasibility(ws, qs, xs_n - xp, ys_n - yp, cfg)
        prim_inf = prim_inf & ~bad
        dual_inf = dual_inf & ~bad

        if cfg.polish:
            x_po, y_po = _polish(ws, q, y_un, cfg, rounds=1, active=run)
            ok_po = _kkt_ok(ws, q, x_po, y_po, cfg)
        else:
            x_po, y_po = x_un, y_un
            ok_po = torch.zeros_like(run)

        done_ok = ok_po | solved_admm
        x_out_n = lane_where(done_ok, lane_where(ok_po, x_po, x_un), x_out)
        y_out_n = lane_where(done_ok, lane_where(ok_po, y_po, y_un), y_out)
        status_n = torch.where(
            done_ok, ADMM_SOLVED,
            torch.where(prim_inf, ADMM_PRIMAL_INFEASIBLE,
                        torch.where(dual_inf, ADMM_DUAL_INFEASIBLE,
                                    status))).to(i32)

        if cfg.adaptive_rho:
            tol = cfg.adaptive_rho_tolerance
            ratio = torch.sqrt((r_prim / (psc + ZERO) + ZERO)
                               / (r_dual / (dsc + ZERO) + ZERO))
            cur = (rho_n / ws.rho_vec).amax(-1)
            adj = (cur * ratio).clamp(1e-4, 1e4) / cur
            trigger = (status_n == 0) & torch.isfinite(ratio) \
                & ((adj > tol) | (adj < 1.0 / tol)) & run
            if any_(trigger):
                r, ri, Mi = _refactor(
                    ws, rho_n, rinv_n, Minv_n,
                    (rho_n * adj[:, None]).clamp(_RHO_MIN, _RHO_MAX), sigma)
                rho_n = lane_where(trigger, r, rho_n)
                rinv_n = lane_where(trigger, ri, rinv_n)
                Minv_n = lane_where(trigger, Mi, Minv_n)

        xs = lane_where(run, xs_n, xs)
        zs = lane_where(run, zs_n, zs)
        ys = lane_where(run, ys_n, ys)
        xp, yp = xs, ys
        status = torch.where(run, status_n, status)
        it = torch.where(run, it_n, it)
        x_out = lane_where(run, x_out_n, x_out)
        y_out = lane_where(run, y_out_n, y_out)
        rho_vec = lane_where(run, rho_n, rho_vec)
        rho_inv = lane_where(run, rinv_n, rho_inv)
        Minv = lane_where(run, Minv_n, Minv)

    hit_max = status == 0
    status = torch.where(hit_max, ADMM_MAX_ITER, status).to(i32)
    x_out = lane_where(hit_max, ws.D * xs, x_out)
    y_out = lane_where(hit_max, ws.E * ys / c, y_out)

    new_state = _state_of(ws, x_out, y_out).select(
        status == ADMM_SOLVED, ADMMState(x=xs, z=zs, y=ys))
    return ADMMResult(x=x_out, y=y_out, status=status, iterations=it,
                      state=new_state)
