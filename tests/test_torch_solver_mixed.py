"""The slice as a whole: the warm-up fleet of the JAX package's headline
benchmark (``bench.py:121-137``) at B = 16 lanes through the homotopy
solver and the mixed-precision pipeline of both packages.

Tolerances, and why:

* ``solver.solve`` in f64 with ``perturb_step=False``: both packages run
  the same iteration with the same f64 inverses (block recursion); only the
  summation order of small matmuls differs.  Returns, iteration counts and
  final penalties are equal; iterates agree to 1e-12 (measured 4.4e-16).
* ``solve_batch_mixed``: the f32 predictor differs in summation order and
  in its inverse (the CPU port's plain Gauss-Jordan, JAX-on-CPU's block
  recursion), and the step perturbation draws from different generators,
  so the predictors' paths differ in the last f32 bits.  The combinatorial
  outcome (return code, certification) must be equal, and certified points
  agree to 1e-9: both certify stationarity to ~2.2e-10 and complementarity
  to ~2.2e-13 in df32 on the same branch (measured 8.9e-15).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lcqpow_tpu as jl
from lcqpow_tpu.problems import random_lcqp as j_random_lcqp

import lcqpow_tpu_torch as pl_
from lcqpow_tpu_torch import convert, mixed as pmixed
from lcqpow_tpu_torch.problems import warm_up, warmup_fleet

B = 16


def _jax_fleet(B):
    rng = np.random.default_rng(0)
    problems = [j_random_lcqp(rng, nV=8, nC=2, nComp=2, as_numpy=True)
                for _ in range(64)]
    base = jax.tree.map(lambda *xs: np.stack(xs), *problems)
    reps = -(-B // 64)
    batch = jax.tree.map(
        lambda x: np.tile(x, (reps,) + (1,) * (x.ndim - 1))[:B], base)
    batch = dataclasses.replace(batch, g=batch.g + 0.01 * rng.normal(size=(B, 8)))
    return jax.tree.map(jnp.asarray, batch)


def _opts(**kw):
    j = jl.Options(print_level=jl.PrintLevel.NONE, max_iterations=200, **kw)
    return j, convert.options_from_dict(dataclasses.asdict(j))


@pytest.fixture(scope="module")
def homotopy():
    jo, po = _opts(perturb_step=False)
    j = jax.jit(jax.vmap(lambda d: jl.solve(d, jo)))(_jax_fleet(B))
    p = pl_.solve(warmup_fleet(B, device="cpu"), po)
    return j, p


@pytest.fixture(scope="module")
def mixed():
    jo, po = _opts()
    j = jl.solve_batch_mixed(_jax_fleet(B), jo, n_corrector_iters=6,
                             escalate=1)
    p = pl_.solve_batch_mixed(warmup_fleet(B, device="cpu"), po,
                              n_corrector_iters=6, escalate=1)
    return j, p


def test_homotopy_matches_jax(homotopy):
    j, p = homotopy
    assert np.array_equal(p.ret.numpy(), np.asarray(j.ret))
    assert np.array_equal(p.algo_status.numpy(), np.asarray(j.algo_status))
    assert np.array_equal(p.stats.iter_total.numpy(),
                          np.asarray(j.stats.iter_total))
    assert np.array_equal(p.stats.iter_outer.numpy(),
                          np.asarray(j.stats.iter_outer))
    np.testing.assert_allclose(p.stats.rho_opt.numpy(),
                               np.asarray(j.stats.rho_opt), rtol=1e-15)
    np.testing.assert_allclose(p.x.numpy(), np.asarray(j.x), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(p.y.numpy(), np.asarray(j.y), rtol=0,
                               atol=1e-10)


def test_mixed_matches_jax(mixed):
    j, p = mixed
    jret, pret = np.asarray(j.ret), p.ret.numpy()
    assert np.array_equal(pret, jret)
    assert int((pret == 0).sum()) == int((jret == 0).sum()) == B
    both = (pret == 0) & (jret == 0)
    np.testing.assert_allclose(p.x.numpy()[both], np.asarray(j.x)[both],
                               rtol=0, atol=1e-9)
    assert np.array_equal(p.algo_status.numpy(), np.asarray(j.algo_status))
    assert np.array_equal(p.stats.certified_stage.numpy() > 0,
                          np.asarray(j.stats.certified_stage) > 0)


def test_escalation_rescues_like_jax():
    # A zero corrector budget certifies nothing in the first pass, so every
    # lane goes through escalation round 0 (budget 25, fresh seed) and is
    # merged back with stage code 3, in both packages.
    jo, po = _opts()
    j = jl.solve_batch_mixed(_jax_fleet(8), jo, n_corrector_iters=0,
                             escalate=1)
    p = pl_.solve_batch_mixed(warmup_fleet(8, device="cpu"), po,
                              n_corrector_iters=0, escalate=1)
    assert np.array_equal(p.ret.numpy(), np.asarray(j.ret))
    assert np.array_equal(p.stats.certified_stage.numpy(),
                          np.asarray(j.stats.certified_stage))
    np.testing.assert_allclose(p.x.numpy(), np.asarray(j.x), rtol=0, atol=1e-9)


def test_merge_retry_takes_only_newly_certified_lanes():
    po = _opts()[1]
    sol = pl_.solve_batch_mixed(warmup_fleet(4, device="cpu"), po,
                                n_corrector_iters=6, escalate=0)
    failed = dataclasses.replace(sol, ret=torch.tensor([0, 200, 201, 0],
                                                       dtype=torch.int32))
    retry = dataclasses.replace(sol, x=sol.x + 1.0,
                                ret=torch.tensor([0, 0, 201, 0],
                                                 dtype=torch.int32))
    merged = pmixed._merge_retry(failed, retry, 0)
    assert merged.ret.tolist() == [0, 0, 201, 0]
    assert torch.equal(merged.x[1], sol.x[1] + 1.0)
    assert torch.equal(merged.x[[0, 2, 3]], sol.x[[0, 2, 3]])
    assert merged.stats.certified_stage[1].item() == 3


def test_warm_up_single_instance():
    po = _opts()[1]
    for solve in (pl_.solve, pl_.solve_mixed):
        data = warm_up(device="cpu")
        sol = solve(data if solve is pl_.solve else pl_.stack_lcqps([data]),
                    po)
        x = sol.x.reshape(-1).numpy()
        assert int(sol.ret.reshape(-1)[0]) == 0
        assert int(sol.algo_status.reshape(-1)[0]) \
            == pl_.AlgorithmStatus.S_STATIONARY_SOLUTION
        assert min(np.abs(x - [1, 0]).max(), np.abs(x - [0, 1]).max()) < 1e-10


def test_predictor_options_and_kkt_form_match_jax():
    from lcqpow_tpu import mixed as jmixed

    jo, po = _opts()
    for m in (None, 14, 505):
        assert dataclasses.asdict(pmixed._predictor_options(po, m)) \
            == dataclasses.asdict(jmixed._predictor_options(jo, m))
    jd = _jax_fleet(2)
    pd = warmup_fleet(2, device="cpu")
    assert dataclasses.asdict(pmixed._resolve_kkt_form(pd, po)) \
        == dataclasses.asdict(jmixed._resolve_kkt_form(jd, jo))


@pytest.mark.parametrize("kw,start", [
    (dict(store_steps=True, qp_solver=jl.QPSolver.OSQP_SPARSE,
          solve_zero_penalty_first=False), "x0"),
    (dict(n_dynamic_penalty=0, keep_best_iterate=False,
          tolerate_inner_maxiter=True), "y0"),
], ids=["trajectories_osqp_x0", "no_leyffer_y0"])
def test_homotopy_options_match_jax(kw, start):
    # Same f64 iteration as test_homotopy_matches_jax, under the options
    # the main path leaves at their defaults, with warm starts.
    jo, po = _opts(perturb_step=False, **kw)
    n, m0 = 8, 6
    rng = np.random.default_rng(11)
    x0 = 0.1 * rng.normal(size=(8, n))
    y0 = 0.1 * rng.normal(size=(8, n + m0))   # reference layout [box; A; L; R]
    jd = _jax_fleet(8)
    pd = warmup_fleet(8, device="cpu")
    if start == "x0":
        j = jax.jit(jax.vmap(lambda d, x: jl.solve(d, jo, x0=x)))(
            jd, jnp.asarray(x0))
        p = pl_.solve(pd, po, x0=torch.from_numpy(x0))
    else:
        j = jax.jit(jax.vmap(lambda d, y: jl.solve(d, jo, y0=y)))(
            jd, jnp.asarray(y0))
        p = pl_.solve(pd, po, y0=torch.from_numpy(y0))
    assert np.array_equal(p.ret.numpy(), np.asarray(j.ret))
    assert np.array_equal(p.stats.iter_total.numpy(),
                          np.asarray(j.stats.iter_total))
    assert p.y.shape == np.asarray(j.y).shape
    np.testing.assert_allclose(p.x.numpy(), np.asarray(j.x), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(p.y.numpy(), np.asarray(j.y), rtol=0,
                               atol=1e-10)
    if kw.get("store_steps"):
        jt, pt = j.stats.trajectories, p.stats.trajectories
        for f in dataclasses.fields(jt):
            a, b = getattr(pt, f.name).numpy(), np.asarray(getattr(jt, f.name))
            assert a.shape == b.shape, f.name
            # alpha = -l/q of the merit line search: near convergence l is a
            # dot product of a ~1e-6 step with a near-stationary gradient,
            # which cancels and lifts summation-order differences to ~5e-7
            # (measured); the iterates it scales still agree to 1e-12.
            atol = 2e-6 if f.name == "step_length" else 1e-12
            np.testing.assert_allclose(a, b, rtol=1e-9, atol=atol,
                                       equal_nan=True, err_msg=f.name)
