"""The port's one-call API (``api.py``: ``options_from_params`` with its
disposition tables, ``lcqpow``), the unbatched mixed-precision solve and
``Stats.trim``, held to the JAX package on the same NumPy-built inputs on
the CPU.  The object API is in ``test_torch_compat.py``.

Tolerances, and why (the iterate comparisons run with
``perturb_step=False``, and ``test_lcqpow_perturbed_matches_jax`` with it
on: an unbatched solve draws from ``PRNGKey(seed)`` in both packages, the
same bits, so the same tolerances hold):

* the f64 homotopy (``lcqpow``): the same iteration in both packages, only
  the summation order of small matmuls differs; x and y to 1e-9, integer
  statistics equal, trajectories to 1e-12 (the line-search step to 2e-6,
  see ``test_torch_solver_mixed.py``);
* the mixed pipeline (``solve_mixed`` on one instance, ``lcqpow(...,
  mixed=True)``): the f32 predictors differ in the last bits; the
  certified points agree to 1e-9 and ``ret``/``algo_status`` are equal
  (and, for ``lcqpow``, the integer statistics).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import lcqpow_tpu as jl
from lcqpow_tpu.api import lcqpow as j_lcqpow
from lcqpow_tpu.api import options_from_params as j_options_from_params
from lcqpow_tpu.problems import random_lcqp as j_random_lcqp
from lcqpow_tpu.problems import warm_up as j_warm_up

import lcqpow_tpu_torch as pl_
from lcqpow_tpu_torch import api as papi
from lcqpow_tpu_torch.api import lcqpow as p_lcqpow
from lcqpow_tpu_torch.problems import random_lcqp as p_random_lcqp
from lcqpow_tpu_torch.problems import warm_up as p_warm_up

WARM_UP = dict(Q=[[2., 0.], [0., 2.]], g=[-2., -2.],
               L=[[1., 0.]], R=[[0., 1.]])
INT_STATS = ("iters_total", "iters_outer", "iters_subproblem", "exit_flag",
             "solution_type", "qp_exit_flag")


def _opts(**kw):
    kw = dict(print_level=0, perturb_step=False) | kw
    return jl.Options(**kw), pl_.Options(**kw)


# ------------------------------------------------ solve_mixed, one instance
def test_solve_mixed_takes_one_instance():
    # The call that raised "not enough values to unpack" before the port's
    # solve_mixed took unbatched data.
    sol = pl_.solve_mixed(p_warm_up(device="cpu"),
                          pl_.Options(print_level=pl_.PrintLevel.NONE))
    assert sol.x.shape == (2,) and sol.y.shape == (4,)
    assert sol.ret.ndim == 0 and sol.stats.certified_stage.ndim == 0
    assert int(sol.ret) == 0
    assert int(sol.algo_status) == pl_.AlgorithmStatus.S_STATIONARY_SOLUTION
    x = sol.x.numpy()
    assert min(np.abs(x - [1, 0]).max(), np.abs(x - [0, 1]).max()) < 1e-10


@pytest.fixture(scope="module")
def jax_solve_mixed():
    return jax.jit(jl.solve_mixed, static_argnums=(1,))


@pytest.mark.parametrize("case", ["warm_up", "random_3", "random_4"])
def test_solve_mixed_one_instance_matches_jax(case, jax_solve_mixed):
    jo, po = _opts()
    if case == "warm_up":
        jd, pd = j_warm_up(), p_warm_up(device="cpu")
    else:
        seed = int(case.split("_")[1])
        jd = j_random_lcqp(seed, nV=8, nC=2, nComp=2)
        pd = p_random_lcqp(seed, nV=8, nC=2, nComp=2, device="cpu")
    j = jax_solve_mixed(jd, jo)
    p = pl_.solve_mixed(pd, po)
    assert int(p.ret) == int(j.ret) == 0
    assert int(p.algo_status) == int(j.algo_status)
    assert p.x.shape == np.asarray(j.x).shape
    np.testing.assert_allclose(p.x.numpy(), np.asarray(j.x), rtol=0,
                               atol=1e-9)


# ----------------------------------------------------- options from params
PARAMS = {
    "stationarityTolerance": 1e-9, "complementarityTolerance": 1e-12,
    "initialPenaltyParameter": 0.05, "penaltyUpdateFactor": 3.0,
    "maxRho": 1e7, "solveZeroPenaltyFirst": False, "perturbStep": False,
    "maxIterations": 321, "nDynamicPenalty": 5, "etaDynamicPenalty": 0.8,
    "printLevel": 1, "storeSteps": True, "qpSolver": 2,
    "innerSolver": "pas", "seed": 7, "x0": [1.0, 2.0], "y0": [0.5, 0.25],
    "OSQP_options": {"rho": 0.2, "sigma": 1e-7, "alpha": 1.5,
                     "eps_abs": 3e-7, "eps_rel": 4e-7, "max_iter": 1234,
                     "polish": True, "delta": 1e-7, "check_termination": 10,
                     "adaptive_rho": True, "adaptive_rho_tolerance": 4.0,
                     "verbose": True, "scaling": 10, "warm_start": True},
    "qpOASES_options": {"printLevel": 5, "enableRamping": False,
                        "terminationTolerance": 1e-9},
}


def test_options_from_params_matches_jax():
    jo, jx0, jy0 = j_options_from_params(PARAMS)
    po, px0, py0 = papi.options_from_params(PARAMS)
    assert dataclasses.asdict(po) == dataclasses.asdict(jo)
    np.testing.assert_array_equal(px0, jx0)
    np.testing.assert_array_equal(py0, jy0)
    assert po.admm.max_iter == 1234 and po.admm.polish_delta == 1e-7


def test_disposition_tables_equal_jax():
    from lcqpow_tpu import api as japi

    assert papi._PARAM_MAP == japi._PARAM_MAP
    assert papi._OSQP_FIELD_MAP == japi._OSQP_FIELD_MAP
    assert set(papi._OSQP_FIELDS_IGNORED) == set(japi._OSQP_FIELDS_IGNORED)
    assert papi._QPOASES_FIELDS_IGNORED == japi._QPOASES_FIELDS_IGNORED
    assert len(papi._QPOASES_FIELDS_IGNORED) == 29


@pytest.mark.parametrize("params", [
    {"definitelyNotAKnob": 1},
    {"OSQP_options": {"not_a_field": 1}},
    {"qpOASES_options": {"notAKnob": 1}},
], ids=["param", "osqp", "qpoases"])
def test_unknown_keys_raise(params):
    with pytest.raises(KeyError):
        j_options_from_params(params)
    with pytest.raises(KeyError):
        papi.options_from_params(params)


# ------------------------------------------------------------ lcqpow
@pytest.mark.parametrize("mixed", [False, True], ids=["f64", "mixed"])
def test_lcqpow_matches_jax(mixed):
    params = {"printLevel": 0, "perturbStep": False}
    jx, jy, js = j_lcqpow(**WARM_UP, params=params, mixed=mixed)
    px, py, ps = p_lcqpow(**WARM_UP, params=params, mixed=mixed,
                          device="cpu")
    assert isinstance(px, np.ndarray) and isinstance(py, np.ndarray)
    assert px.shape == jx.shape and py.shape == jy.shape
    np.testing.assert_allclose(px, jx, rtol=0, atol=1e-9)
    np.testing.assert_allclose(py, jy, rtol=0, atol=1e-9)
    assert set(ps) == set(js)
    assert {k: ps[k] for k in INT_STATS} == {k: js[k] for k in INT_STATS}
    assert ps["elapsed_time_compile"] == 0.0
    assert ps["elapsed_time_solve"] == ps["elapsed_time"] > 0.0


@pytest.mark.parametrize("mixed", [False, True], ids=["f64", "mixed"])
def test_lcqpow_perturbed_matches_jax(mixed):
    # Integer statistics are equal, except the mixed pipeline's on the
    # warm-up: its f32 predictor runs along the symmetric saddle x1 = x2,
    # where the packages' f32 inner solves differ by an ulp before the
    # first draw (x 0.99999994 against 1.0) and rounding, not the draws,
    # picks the pass a penalty update fires (iters_outer 12 against 13 at
    # seed 3, the same iters_total).
    params = {"printLevel": 0, "seed": 3}
    for name, problem in (("warm_up", WARM_UP),
                          ("random_4", _random_arrays(4))):
        jx, jy, js = j_lcqpow(**problem, params=params, mixed=mixed)
        px, py, ps = p_lcqpow(**problem, params=params, mixed=mixed,
                              device="cpu")
        assert ps["exit_flag"] == js["exit_flag"] == 0, name
        assert ps["solution_type"] == js["solution_type"], name
        np.testing.assert_allclose(px, jx, rtol=0, atol=1e-9, err_msg=name)
        np.testing.assert_allclose(py, jy, rtol=0, atol=1e-9, err_msg=name)
        if not (mixed and name == "warm_up"):
            assert {k: ps[k] for k in INT_STATS} \
                == {k: js[k] for k in INT_STATS}, name


def _random_arrays(seed):
    d = j_random_lcqp(seed, nV=8, nC=2, nComp=2, as_numpy=True)
    return {k: np.asarray(getattr(d, k))
            for k in ("Q", "g", "L", "R", "A", "lbA", "ubA")}


def test_lcqpow_store_steps_and_warm_start_match_jax():
    # On a random instance: the warm-up's trajectory is degenerate (its
    # steps shrink geometrically to a corner, where the line search's step
    # length cancels), so rounding moves its iterates far above 1e-12.
    params = {"printLevel": 0, "perturbStep": False, "storeSteps": True,
              "solveZeroPenaltyFirst": False, "x0": 0.1 * np.ones(8)}
    problem = _random_arrays(5)
    jx, jy, js = j_lcqpow(**problem, params=params)
    px, py, ps = p_lcqpow(**problem, params=params, device="cpu")
    assert ps["exit_flag"] == 0
    np.testing.assert_allclose(px, jx, rtol=0, atol=1e-9)
    np.testing.assert_allclose(py, jy, rtol=0, atol=1e-9)
    assert set(ps) == set(js)
    assert {k: ps[k] for k in INT_STATS} == {k: js[k] for k in INT_STATS}
    for k in ("xSteps", "innerIters", "subproblemIters",
              "accuSubproblemIters", "stepLength", "stepSize", "statVals",
              "objVals", "phiVals", "meritVals"):
        assert ps[k].shape == js[k].shape and ps[k].shape[0] \
            == ps["iters_total"], k
        atol = 2e-6 if k == "stepLength" else 1e-12
        np.testing.assert_allclose(ps[k], js[k], rtol=1e-9, atol=atol,
                                   err_msg=k)


def test_stats_trim_batched():
    # A batched solve cuts the time axis to its longest lane.
    from lcqpow_tpu_torch.problems import warmup_fleet

    po = pl_.Options(print_level=0, store_steps=True, max_iterations=200)
    st = pl_.solve(warmup_fleet(4, device="cpu"), po).stats
    t = st.trim().trajectories
    n = int(st.iter_total.max())
    assert t.x_steps.shape == (4, n, 8) and t.phi_vals.shape == (4, n)
    torch.testing.assert_close(t.phi_vals, st.trajectories.phi_vals[:, :n],
                               rtol=0, atol=0, equal_nan=True)
    assert st.map(lambda a: a[0]).trim().trajectories.phi_vals.shape \
        == (int(st.iter_total[0]),)
