"""The block-pivot active-set (PAS) inner engine of the port
(``lcqpow_tpu_torch/solvers/pas.py``), modelled on ``tests/test_pas.py``:
the engine against the JAX package's, the homotopy with
``inner_solver="pas"`` against the JAX package's, and the reference's
oracles (LCQPow ``test/RunUnitTests.cpp:505-551`` and its example sweeps).

Tolerances, and why:

* Engine: each pivot branches on signs at rounding level (``y < 0``,
  ``Ax < l - delta``), and XLA contracts products into FMAs inside a
  compiled loop while eager PyTorch never does; so the reference is the
  JAX engine run eagerly lane by lane (``jax.disable_jit``).  Pivot counts
  and statuses equal; f64 iterates to 1e-10.
* Homotopy, f64, ``perturb_step=False``: same iteration, same f64
  inverses; returns and iteration counts equal, iterates to 1e-10.
* Oracles: the JAX package's test tolerances.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lcqpow_tpu as jl
from lcqpow_tpu import solver as jsolver
from lcqpow_tpu.problems import random_lcqp as j_random_lcqp
from lcqpow_tpu.solvers import admm as jadmm
from lcqpow_tpu.solvers import pas as jpas

import lcqpow_tpu_torch as lt
from lcqpow_tpu_torch import convert
from lcqpow_tpu_torch import solver as psolver
from lcqpow_tpu_torch.problems import (optimize_on_circle, random_lcqp,
                                       warm_up, warmup_fleet)
from lcqpow_tpu_torch.solvers import admm, pas

FIELDS = [f.name for f in dataclasses.fields(jl.LCQPData)]
B = 16


def _opts(**kw):
    kw.setdefault("print_level", lt.PrintLevel.NONE)
    kw.setdefault("inner_solver", "pas")
    return lt.Options(**kw)


def _jax_fleet(B):
    rng = np.random.default_rng(0)
    problems = [j_random_lcqp(rng, nV=8, nC=2, nComp=2, as_numpy=True)
                for _ in range(64)]
    base = jax.tree.map(lambda *xs: np.stack(xs), *problems)
    batch = jax.tree.map(lambda x: x[:B], base)
    return dataclasses.replace(batch, g=batch.g + 0.01 * rng.normal(size=(B, 8)))


def test_pas_engine_unit():
    # min 1/2 x'I x - x  s.t. 0 <= x <= [0.25, 2], from a cold start.
    cfg = lt.Options().admm
    P = torch.eye(2, dtype=torch.float64)[None]
    q = torch.tensor([[-1.0, -1.0]], dtype=torch.float64)
    ws = admm.factorize(P, P.clone(), torch.zeros(1, 2, dtype=torch.float64),
                        torch.tensor([[0.25, 2.0]], dtype=torch.float64), cfg,
                        q_proto=q)
    res = pas.solve(ws, q, admm.init_state(ws), cfg)
    assert int(res.status[0]) == admm.ADMM_SOLVED
    np.testing.assert_allclose(res.x[0].numpy(), [0.25, 1.0], atol=1e-10)
    # Active upper bound carries a positive multiplier (OSQP sign).
    assert float(res.y[0, 0]) > 0


@pytest.mark.parametrize("cold", [False, True], ids=["warm", "cold"])
def test_pas_engine_matches_jax_eager(cold):
    jb = _jax_fleet(B)
    fields = {f: np.asarray(getattr(jb, f)) for f in FIELDS}
    jo = jl.Options()
    jd = jax.tree.map(jnp.asarray, jb)
    jws = jax.jit(jax.vmap(lambda d: jsolver.build_workspace(d, jo)))(jd)
    pws = psolver.build_workspace(convert.lcqp_from_numpy(fields, "cpu"),
                                  lt.Options())
    rng = np.random.default_rng(4)
    q = fields["g"] + (0.5 * rng.normal(size=(B, 8)) if cold else 0.0)
    # Cold: random duals, so the seed is often wrong and the engine pivots.
    y0 = rng.normal(size=(B, 14)) if cold else np.zeros((B, 14))
    cfg = jl.ADMMOptions()
    with jax.disable_jit():
        lanes = []
        for i in range(B):
            w = jax.tree.map(lambda a: a[i], jws)
            lanes.append(jpas.solve(w, jnp.asarray(q[i]),
                                    jadmm.init_state(w, None,
                                                     jnp.asarray(y0[i])),
                                    cfg))
    j = jax.tree.map(lambda *xs: np.stack(xs), *lanes)
    p = pas.solve(pws, torch.from_numpy(q),
                  admm.init_state(pws, None, torch.from_numpy(y0)),
                  lt.ADMMOptions())
    assert np.array_equal(p.status.numpy(), np.asarray(j.status))
    assert np.array_equal(p.iterations.numpy(), np.asarray(j.iterations))
    if cold:
        assert p.iterations.max() > 1
    for a, b in ((p.x, j.x), (p.y, j.y), (p.state.x, j.state.x),
                 (p.state.z, j.state.z), (p.state.y, j.state.y)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-10)


def test_pas_homotopy_matches_jax():
    jo = jl.Options(print_level=jl.PrintLevel.NONE, max_iterations=200,
                    perturb_step=False, inner_solver="pas")
    po = convert.options_from_dict(dataclasses.asdict(jo))
    j = jax.jit(jax.vmap(lambda d: jl.solve(d, jo)))(
        jax.tree.map(jnp.asarray, _jax_fleet(B)))
    p = lt.solve(warmup_fleet(B, device="cpu"), po)
    assert np.array_equal(p.ret.numpy(), np.asarray(j.ret))
    assert (p.ret.numpy() == 0).all()
    assert np.array_equal(p.stats.iter_total.numpy(),
                          np.asarray(j.stats.iter_total))
    assert np.array_equal(p.stats.iter_outer.numpy(),
                          np.asarray(j.stats.iter_outer))
    assert np.array_equal(p.stats.subproblem_iter.numpy(),
                          np.asarray(j.stats.subproblem_iter))
    assert np.array_equal(p.algo_status.numpy(), np.asarray(j.algo_status))
    np.testing.assert_allclose(p.x.numpy(), np.asarray(j.x), rtol=0,
                               atol=1e-10)


def _one(data, opts, x0=None):
    sol = lt.solve(data, opts, x0=x0)
    return sol, sol.x.numpy()


def test_pas_warm_up():
    sol, x = _one(warm_up(device="cpu"), _opts())
    assert int(sol.ret) == lt.ReturnValue.SUCCESSFUL_RETURN
    assert min(np.linalg.norm(x - [1, 0]), np.linalg.norm(x - [0, 1])) < 1e-8
    assert int(sol.algo_status) == lt.AlgorithmStatus.S_STATIONARY_SOLUTION
    # Stationarity 2x - 2 - y_box - y_compl ~ 0 (qpOASES layout
    # [box; A; L; R] under the default QPOASES_DENSE mode).
    y = sol.y.numpy()
    resid = 2 * x - 2 - y[:2] - np.array([y[2], y[3]])
    assert np.max(np.abs(resid)) < 1e-8


def test_pas_warm_up_with_A():
    sol, x = _one(lt.make_lcqp(Q=[[2., 0.], [0., 2.]], g=[-2., -2.],
                               L=[[1., 0.]], R=[[0., 1.]], A=[[1., 1.]],
                               lbA=[-1e20], ubA=[2.], device="cpu"), _opts())
    assert int(sol.ret) == lt.ReturnValue.SUCCESSFUL_RETURN
    assert min(np.linalg.norm(x - [1, 0]), np.linalg.norm(x - [0, 1])) < 1e-8


def test_pas_shifted_bounds():
    sol, x = _one(lt.make_lcqp(Q=[[2., 0.], [0., 2.]], g=[-2., -2.],
                               L=[[1., 0.]], R=[[0., 1.]], lbL=[1.], lbR=[1.],
                               device="cpu"), _opts())
    assert int(sol.ret) == lt.ReturnValue.SUCCESSFUL_RETURN
    Lx, Rx = x[0] - 1.0, x[1] - 1.0
    assert Lx >= -1e-9 and Rx >= -1e-9
    assert abs(Lx * Rx) < 1e-9


def test_pas_box_constraints():
    sol, x = _one(lt.make_lcqp(Q=[[2., 0.], [0., 2.]], g=[-2., -2.],
                               L=[[1., 0.]], R=[[0., 1.]], lb=[0.5, 0.0],
                               ub=[2.0, 2.0], device="cpu"), _opts())
    assert int(sol.ret) == lt.ReturnValue.SUCCESSFUL_RETURN
    # x1 >= 0.5 forces the (1, 0) branch.
    assert np.linalg.norm(x - [1, 0]) < 1e-8


def test_pas_infeasible_qp_reports_subsolver_error():
    sol, _ = _one(lt.make_lcqp(Q=[[2., 0.], [0., 2.]], g=[-2., -2.],
                               L=[[1., 0.]], R=[[0., 1.]],
                               A=[[1., 0.], [1., 0.]], lbA=[1.0, -2.0],
                               ubA=[2.0, -1.0], device="cpu"), _opts())
    assert int(sol.ret) == lt.ReturnValue.SUBPROBLEM_SOLVER_ERROR
    assert int(sol.stats.qp_exit_flag) <= 0


def test_pas_matches_admm_on_random_family():
    # Same family and seed as tests/test_pas.py: both engines certify, and
    # PAS lands on a stationary point at least as good.
    rng = np.random.default_rng(7)
    for _ in range(5):
        data = random_lcqp(rng, nV=6, nC=2, nComp=2, device="cpu")
        s_admm = lt.solve(data, _opts(inner_solver="admm"))
        s_pas = lt.solve(data, _opts())
        assert int(s_admm.ret) == lt.ReturnValue.SUCCESSFUL_RETURN
        assert int(s_pas.ret) == lt.ReturnValue.SUCCESSFUL_RETURN
        Q, g = data.Q.numpy(), data.g.numpy()

        def obj(x):
            return 0.5 * x @ Q @ x + g @ x

        assert obj(s_pas.x.numpy()) <= obj(s_admm.x.numpy()) + 1e-6


def test_pas_circle():
    data, x0 = optimize_on_circle(20, device="cpu")
    sol, x = _one(data, _opts(stationarity_tolerance=1e-2), x0=x0)
    assert int(sol.ret) == lt.ReturnValue.SUCCESSFUL_RETURN
    assert abs(np.linalg.norm(x[:2]) - 1.0) < 2e-2


def test_pas_mixed_precision_tier():
    # tests/test_pas.py::test_pas_mixed_precision_tier: the f32 PAS
    # predictor inside the mixed pipeline, on the warm-up LCQP, the random
    # family and the circle-N20 golden point.
    opts = _opts()
    sol = lt.solve_mixed(lt.stack_lcqps([warm_up(device="cpu")]), opts)
    assert int(sol.ret[0]) == lt.ReturnValue.SUCCESSFUL_RETURN
    assert np.allclose(np.sort(sol.x[0].numpy()), [0, 1], atol=1e-10)
    fleet = lt.stack_lcqps([random_lcqp(seed, nV=6, nC=2, nComp=2,
                                        device="cpu") for seed in range(3)])
    assert (lt.solve_mixed(fleet, opts).ret == 0).all()
    data, x0 = optimize_on_circle(20, device="cpu")
    s = lt.solve_mixed(lt.stack_lcqps([data]),
                       opts.replace(stationarity_tolerance=1e-2,
                                    max_iterations=200,
                                    qp_solver=lt.QPSolver.OSQP_SPARSE),
                       x0=x0[None])
    assert int(s.ret[0]) == lt.ReturnValue.SUCCESSFUL_RETURN
    np.testing.assert_allclose(s.x[0, :2].numpy(), [0.19728666, -0.9873599],
                               atol=1e-5)
