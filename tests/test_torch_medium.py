"""Medium shapes: the sweep inverse, the Cholesky routes, the compression's
row ranking, the range-space and compressed Schur forms of the polish and
of the corrector, and the circle problem end to end: the port against the
JAX package on NumPy-made inputs.

Tolerances, and why:

* Inverses: both packages run the same operations (Jacobi scale, sweep of
  32-blocks each inverted by the block recursion, Newton-Schulz); XLA:CPU
  contracts products into FMAs and orders its sums differently.  f64 to
  1e-12 relative to max|inverse|, f32 to 1e-5.
* Row ranking: exact (both are index lists).
* ``_polish_solve`` and ``correct_and_certify`` on circle N = 30 (n = 62,
  m = 153, compression cap 128): the same f64 linear algebra, to 1e-10 for
  the polish's (x, nu); the corrector's x to 1e-8 (it certifies each lane
  to the df32 stationarity floor, ~1e-10 here).
* The circle end to end: the JAX package's own golden values and
  tolerances (``tests/test_mixed.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import lcqpow_tpu as jl
from lcqpow_tpu import mixed as jmixed
from lcqpow_tpu import solver as jsolver
from lcqpow_tpu.ops import chol as jchol
from lcqpow_tpu.problems import optimize_on_circle as j_circle
from lcqpow_tpu.solvers import admm as jadmm

import lcqpow_tpu_torch as pl_
from lcqpow_tpu_torch import convert
from lcqpow_tpu_torch import mixed as pmixed
from lcqpow_tpu_torch import solver as psolver
from lcqpow_tpu_torch.ops import chol as pchol
from lcqpow_tpu_torch.problems import optimize_on_circle as p_circle
from lcqpow_tpu_torch.solvers import admm as padmm

FIELDS = [f.name for f in dataclasses.fields(jl.LCQPData)]
TOL = {np.float64: 1e-12, np.float32: 1e-5}


def _spd(n, dt, seed, B=2):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, n, n))
    d = np.exp(rng.uniform(-2, 2, size=(B, n)))
    M = A @ A.transpose(0, 2, 1) / n + np.eye(n)
    return (d[:, :, None] * M * d[:, None, :]).astype(dt)


def _rel(p, j):
    p, j = np.asarray(p), np.asarray(j)
    return np.abs(p - j).max() / np.abs(j).max()


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("n", [65, 100, 288])
def test_sweep_and_spd_inverse_match_jax(n, dt):
    M = _spd(n, dt, seed=n)
    jsw = jax.jit(jax.vmap(jchol.sweep_spd_inverse))(M)
    psw = pchol.sweep_spd_inverse(torch.from_numpy(M))
    assert _rel(psw, jsw) <= TOL[dt]
    jinv = jax.jit(jax.vmap(jchol.spd_inverse))(M)
    pinv = pchol.spd_inverse(torch.from_numpy(M))
    assert _rel(pinv, jinv) <= TOL[dt]
    jl_ = jax.jit(jax.vmap(jchol.spd_inverse_light))(M)
    pl_inv = pchol.spd_inverse_light(torch.from_numpy(M))
    assert _rel(pl_inv, jl_) <= TOL[dt]
    # And each is an inverse.
    eye = np.eye(n)
    resid = np.abs(np.asarray(M, np.float64) @ pinv.double().numpy()
                   - eye).max()
    assert resid <= (1e-9 if dt == np.float64 else 5e-2)


@pytest.mark.parametrize("n", [20, 65])
def test_cholesky_routes_match_jax(n):
    M = _spd(n, np.float64, seed=3 * n)
    jW = jax.jit(jax.vmap(jchol.spd_inverse_factor))(M)
    pW = pchol.spd_inverse_factor(torch.from_numpy(M))
    assert _rel(pW, jW) <= 1e-12
    jI = jax.jit(jax.vmap(jchol.spd_inverse_chol))(M)
    pI = pchol.spd_inverse_chol(torch.from_numpy(M))
    assert _rel(pI, jI) <= 1e-12
    assert np.abs(M @ pI.numpy() - np.eye(n)).max() <= 1e-9


def _jax_top_k(prio, k):
    return np.asarray(jax.vmap(lambda p: lax.top_k(p, k)[1])(
        jnp.asarray(prio)))


@pytest.mark.parametrize("case", ["tied", "random", "overflow"])
def test_stable_top_k_selects_like_lax_top_k(case):
    rng = np.random.default_rng(11)
    if case == "tied":
        prio, k = np.array([[0, 1, 2, 1, 0, 2, 1, 0, 0, 2, 1, 0]],
                           np.float64), 8
    elif case == "random":
        # mf + eq on the circle N = 30 row count: mostly tied 0/1/2.
        prio, k = rng.integers(0, 3, size=(16, 153)).astype(np.float32), 128
    else:
        # More active rows (priority >= 1) than the cap: equality rows win,
        # then the lower-index active rows; the rest are dropped (the
        # reference's k_cap overflow, reproduced).
        prio = (rng.uniform(size=(16, 153)) < 0.95).astype(np.float64)
        prio += (rng.uniform(size=(16, 153)) < 0.3)
        k = 128
        assert (np.sum(prio >= 1, axis=1) > k).all()
    sel = padmm.stable_top_k(torch.from_numpy(prio), k).numpy()
    assert np.array_equal(sel, _jax_top_k(prio, k))
    if case == "tied":
        assert sel.tolist() == [[2, 5, 9, 1, 3, 6, 10, 0]]


def _circle(N, dt=np.float64):
    jd, x0 = j_circle(N, as_numpy=True)
    fields = {f: np.asarray(getattr(jd, f), dt) for f in FIELDS}
    return fields, np.asarray(x0, dt)


def _batched(fields, B):
    return {k: np.broadcast_to(v, (B,) + v.shape).copy()
            for k, v in fields.items()}


def test_optimize_on_circle_is_the_jax_problem():
    jd, jx0 = j_circle(30)
    pd, px0 = p_circle(30, device="cpu")
    for f in FIELDS:
        assert np.array_equal(getattr(pd, f).numpy(), np.asarray(getattr(jd, f))), f
    assert np.array_equal(px0.numpy(), jx0)


def _active_sets(B, seed):
    """OSQP-sign duals of a consistent active set per lane: the equality
    rows, lambda_j = 0 at one vertex j (x on its tangent line) and
    theta_i = 0 at every other vertex, as a homotopy pass near a vertex
    seeds them."""
    rng = np.random.default_rng(seed)
    nC, nK, n = 31, 30, 62
    y = np.zeros((B, nC + 2 * nK + n))
    y[:, :nC] = rng.normal(size=(B, nC))
    j = rng.integers(0, nK, size=B)
    y[np.arange(B), nC + j] = -1.0
    theta = np.full((B, nK), -1.0)
    theta[np.arange(B), j] = 0.0
    y[:, nC + nK:nC + 2 * nK] = theta
    return y


@pytest.fixture(scope="module")
def circle30_ws():
    fields, _ = _circle(30)
    B = 4
    fb = _batched(fields, B)
    rng = np.random.default_rng(5)
    fb["g"][:, :2] = -(np.array([0.5, -0.6]) + 0.05 * rng.normal(size=(B, 2))) \
        @ np.array([[17., -15.], [-15., 17.]]).T
    jo = jl.Options()
    jd = jax.tree.map(jnp.asarray, jl.LCQPData(**fb))
    jws = jax.jit(jax.vmap(lambda d: jsolver.build_workspace(d, jo)))(jd)
    pws = psolver.build_workspace(convert.lcqp_from_numpy(fb, "cpu"),
                                  pl_.Options())
    return jws, pws, fb


@pytest.mark.parametrize("form", ["range", "schur"])
def test_polish_solve_medium_forms_match_jax(circle30_ws, form):
    jws, pws, fb = circle30_ws
    B, m = fb["g"].shape[0], 153
    assert padmm.compression_cap(62, m) == 128 < m
    y = _active_sets(B, seed=7)
    low = np.asarray(jws.eq_mask) | ((y < 0) & (np.asarray(jws.l) > -1e20))
    up = (y > 0) & (np.asarray(jws.u) < 1e20) & ~low
    q = fb["g"]
    jcfg = jl.ADMMOptions(kkt_form=form)
    pcfg = pl_.ADMMOptions(kkt_form=form)
    jx, jnu = jax.jit(jax.vmap(
        lambda w, q, lo, u: jadmm._polish_solve(w, q, lo, u, jcfg)))(
        jws, jnp.asarray(q), jnp.asarray(low), jnp.asarray(up))
    px, pnu = padmm._polish_solve(pws, torch.from_numpy(q),
                                  torch.from_numpy(low), torch.from_numpy(up),
                                  pcfg)
    if form == "schur":
        prio = (low | up).astype(np.float64) + np.asarray(jws.eq_mask)
        sel = padmm.stable_top_k(torch.from_numpy(prio), 128).numpy()
        assert np.array_equal(sel, _jax_top_k(prio, 128))
        # Every row left out is inactive, so its dual is exactly 0.
        out = np.ones((B, m), bool)
        np.put_along_axis(out, sel, False, axis=1)
        assert not (low | up)[out].any()
        assert (pnu.numpy()[out] == 0).all()
    np.testing.assert_allclose(px.numpy(), np.asarray(jx), rtol=0, atol=1e-10)
    np.testing.assert_allclose(pnu.numpy(), np.asarray(jnu), rtol=0,
                               atol=1e-10)
    # The point solves its KKT system: active rows on their bounds.
    Ax = np.einsum("bmn,bn->bm", np.asarray(jws.A), px.numpy())
    lo = np.asarray(jws.l)
    assert np.abs((Ax - lo)[low]).max() <= 1e-8


@pytest.mark.parametrize("form", ["range", "schur"])
def test_correct_and_certify_medium_forms_match_jax(form):
    fields, x0 = _circle(30)
    B = 4
    fb = _batched(fields, B)
    rng = np.random.default_rng(3)
    refs = np.array([0.5, -0.6]) + 0.05 * rng.normal(size=(B, 2))
    fb["g"][:, :2] = -(refs @ np.array([[17., -15.], [-15., 17.]]).T)
    x0b = np.tile(x0, (B, 1))
    x0b[:, :2] = refs
    jo = jl.Options(print_level=jl.PrintLevel.NONE, max_iterations=200,
                    stationarity_tolerance=1e-2,
                    qp_solver=jl.QPSolver.OSQP_SPARSE,
                    admm=jl.ADMMOptions(kkt_form=form))
    po = convert.options_from_dict(dataclasses.asdict(jo))
    m_rows = 153
    # One f32 predictor (the JAX package's) feeds both correctors.
    jd = jax.tree.map(jnp.asarray, jl.LCQPData(**fb))
    jd32 = jax.tree.map(lambda a: a.astype(jnp.float32), jd)
    pred = jax.jit(jax.vmap(lambda d, x: jl.solve(
        d, jmixed._predictor_options(jo, m_rows), x0=x)))(
        jd32, jnp.asarray(x0b, jnp.float32))
    args = (pred.x, pred.y, pred.stats.rho_opt, pred.stats.iter_outer > 0,
            pred.ret, pred.stats.qp_exit_flag)
    j = jax.jit(jax.vmap(lambda d, *a: jmixed.correct_and_certify(
        d, jo, *a, n_corrector_iters=25)))(jd, *args)
    p = pmixed.correct_and_certify(
        convert.lcqp_from_numpy(fb, "cpu"), po,
        *(torch.from_numpy(np.array(a)) for a in args),
        n_corrector_iters=25)
    jx, jret = np.asarray(j[0]), np.asarray(j[2])
    assert np.array_equal(p[2].numpy(), jret)
    assert (jret == 0).all()
    np.testing.assert_allclose(p[0].numpy(), jx, rtol=0, atol=1e-8)


def test_solve_mixed_circle_n20_golden():
    # Golden of tests/test_mixed.py::test_mixed_circle_n20_matches_f64.
    data, x0 = p_circle(20, device="cpu")
    opts = pl_.Options(print_level=pl_.PrintLevel.NONE,
                       stationarity_tolerance=1e-2, max_iterations=200,
                       qp_solver=pl_.QPSolver.OSQP_SPARSE)
    sol = pl_.solve_mixed(pl_.stack_lcqps([data]), opts, x0=x0[None])
    assert int(sol.ret[0]) == pl_.ReturnValue.SUCCESSFUL_RETURN
    np.testing.assert_allclose(sol.x[0, :2].numpy(), [0.19728666, -0.9873599],
                               atol=1e-5)


def test_solve_mixed_circle_n100_reference_solution():
    # tests/test_mixed.py::test_mixed_circle_n100_reference_solution: the
    # compressed Schur form (m = 503 > 288) with sweep inverses throughout.
    data, x0 = p_circle(100, device="cpu")
    opts = pl_.Options(print_level=pl_.PrintLevel.NONE,
                       stationarity_tolerance=1e-2, max_iterations=200,
                       qp_solver=pl_.QPSolver.OSQP_SPARSE)
    batch = pl_.stack_lcqps([data])
    assert pmixed._resolve_kkt_form(batch, opts).admm.kkt_form == "schur"
    sol = pl_.solve_mixed(batch, opts, x0=x0[None])
    assert int(sol.ret[0]) == pl_.ReturnValue.SUCCESSFUL_RETURN
    x2 = sol.x[0, :2].numpy()
    assert (np.allclose(x2, [0.1811, -0.9835], atol=2e-3)
            or np.allclose(x2, [0.9764, -0.2183], atol=2e-3)), x2
    audit = pl_.audit_solution(batch, sol, opts)
    assert audit["audited"] == 1 and audit["phi_ok"]
    assert audit["max_violation"] <= 1e-9
