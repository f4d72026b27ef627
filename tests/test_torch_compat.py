"""The port's object API (``compat.LCQProblem``), held to the JAX
package's on the same NumPy-built inputs on the CPU: the f64 homotopy
through ``load_lcqp``/``run_solver`` (dense, with a box in ``ADMM_TPU``
mode, with ``store_steps`` and ``Stats.trim``) and every return code of the
reference's load and dense/sparse mode protocol.  The sparse and file loads
are in ``test_torch_io_csc_messages.py``.

Tolerances, as in ``test_torch_api.py``: ``perturb_step=False``, x and y to
1e-9, integer statistics equal, trajectories to 1e-12 (the line-search step
to 2e-6); return codes equal.
"""

import dataclasses

import numpy as np
import pytest

import lcqpow_tpu as jl
from lcqpow_tpu.problems import random_lcqp as j_random_lcqp

import lcqpow_tpu_torch as pl_

WARM_UP = dict(Q=[[2., 0.], [0., 2.]], g=[-2., -2.],
               L=[[1., 0.]], R=[[0., 1.]])


def _opts(**kw):
    kw = dict(print_level=0, perturb_step=False) | kw
    return jl.Options(**kw), pl_.Options(**kw)


def _random_arrays(seed):
    d = j_random_lcqp(seed, nV=8, nC=2, nComp=2, as_numpy=True)
    return {k: np.asarray(getattr(d, k))
            for k in ("Q", "g", "L", "R", "A", "lbA", "ubA")}


# ------------------------------------------------------------ LCQProblem
def _both_problems(nV, nC, nComp):
    return jl.LCQProblem(nV, nC, nComp), \
        pl_.LCQProblem(nV, nC, nComp, device="cpu")


@pytest.mark.parametrize("case", ["dense", "box_admm_tpu"])
def test_lcqproblem_matches_jax(case):
    kw = {}
    if case == "box_admm_tpu":
        opts = _opts(qp_solver=int(jl.QPSolver.ADMM_TPU))
        kw = dict(lb=[-1.0, -1.0], ub=[0.75, 2.0])
    else:
        opts = _opts()
    outs = []
    for lcqp, o in zip(_both_problems(2, 0, 1), opts):
        lcqp.set_options(o)
        assert lcqp.load_lcqp(**WARM_UP, **kw) == 0
        assert lcqp.run_solver() == 0
        outs.append(lcqp)
    j, p = outs
    jx, px = j.get_primal_solution(), p.get_primal_solution()
    assert px.shape == jx.shape == (2,)
    np.testing.assert_allclose(px, jx, rtol=0, atol=1e-9)
    np.testing.assert_allclose(p.get_dual_solution(), j.get_dual_solution(),
                               rtol=0, atol=1e-9)
    assert p.get_number_of_duals() == j.get_number_of_duals()
    js, ps = j.get_output_statistics(), p.get_output_statistics()
    for getter in ("getIterTotal", "getIterOuter", "getSubproblemIter",
                   "getSolutionStatus", "getQPSolverExitFlag"):
        assert getattr(ps, getter)() == getattr(js, getter)(), getter
    assert p.elapsed_time_compile == 0.0 and p.elapsed_time > 0.0
    if case == "box_admm_tpu":
        assert np.all(px <= np.array([0.75, 2.0]) + 1e-10)
        assert abs(px[0] * px[1]) < 1e-10


def test_lcqproblem_store_steps_trim_matches_jax():
    opts = _opts(store_steps=True, max_iterations=60)
    outs = []
    for lcqp, o in zip(_both_problems(8, 2, 2), opts):
        lcqp.set_options(o)
        assert lcqp.load_lcqp(**_random_arrays(6)) == 0
        assert lcqp.run_solver() == 0
        outs.append(lcqp.get_output_statistics())
    js, ps = outs
    n = ps.get_iter_total()
    assert n == js.get_iter_total()
    jt, pt = js.trajectories, ps.trajectories
    for f in dataclasses.fields(jt):
        a, b = getattr(pt, f.name).numpy(), np.asarray(getattr(jt, f.name))
        assert a.shape == b.shape and a.shape[0] == n, f.name
        assert np.all(np.isfinite(a)), f.name
        atol = 2e-6 if f.name == "step_length" else 1e-12
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=atol,
                                   err_msg=f.name)


# ------------------------------------------------------- the mode protocol
def _protocol_case(lt, new, case):
    """One step of the reference's load/mode protocol on a problem made by
    ``new(nV, nC, nComp)``; returns its code."""
    lcqp = new(2, 0, 1)
    opts = lambda qps: lt.Options(print_level=lt.PrintLevel.NONE,
                                  qp_solver=qps)
    if case == "not_set_up_load":
        return new(0, 0, 0).load_lcqp(**WARM_UP)
    if case == "not_set_up_run":
        return new(0, 0, 0).run_solver()
    if case == "switch_sparse_empty":
        return lcqp.switch_to_sparse_mode()
    if case == "switch_dense_empty":
        return lcqp.switch_to_dense_mode()
    if case == "no_L":
        return lcqp.load_lcqp(WARM_UP["Q"], WARM_UP["g"], None, WARM_UP["R"])
    if case == "no_A":
        return new(2, 1, 1).load_lcqp(**WARM_UP)
    if case == "wrong_dims":
        return new(3, 0, 1).load_lcqp(**WARM_UP)
    if case == "unbounded_lbL":
        return lcqp.load_lcqp(**WARM_UP, lbL=[-np.inf])
    if case == "bad_file":
        return new(0, 0, 0).load_lcqp_from_files("no/such/directory")
    if case.startswith("sparse_load"):
        import scipy.sparse as sp
        assert lcqp.load_lcqp(sp.csc_matrix(WARM_UP["Q"]), WARM_UP["g"],
                              sp.csc_matrix(WARM_UP["L"]),
                              sp.csc_matrix(WARM_UP["R"])) == 0
        lcqp.set_options(opts(lt.QPSolver.QPOASES_DENSE))
        if case == "sparse_load_dense_solver":
            return lcqp.run_solver()
        assert lcqp.switch_to_dense_mode() == 0
        lcqp.set_options(opts(lt.QPSolver.OSQP_SPARSE))
        return lcqp.run_solver()
    assert lcqp.load_lcqp(**WARM_UP, lb=[0.0, 0.0], ub=[5.0, 5.0]) == 0
    if case == "dense_load_qpoases_sparse":
        lcqp.set_options(opts(lt.QPSolver.QPOASES_SPARSE))
    elif case == "dense_load_osqp_sparse":
        lcqp.set_options(opts(lt.QPSolver.OSQP_SPARSE))
    elif case == "switched_qpoases_dense":
        assert lcqp.switch_to_sparse_mode() == 0
        lcqp.set_options(opts(lt.QPSolver.QPOASES_DENSE))
    elif case == "osqp_box":
        assert lcqp.switch_to_sparse_mode() == 0
        lcqp.set_options(opts(lt.QPSolver.OSQP_SPARSE))
    return lcqp.run_solver()


PROTOCOL = {
    "not_set_up_load": "LCQPOBJECT_NOT_SETUP",
    "not_set_up_run": "LCQPOBJECT_NOT_SETUP",
    "switch_sparse_empty": "FAILED_SWITCH_TO_SPARSE",
    "switch_dense_empty": "FAILED_SWITCH_TO_DENSE",
    "no_L": "INVALID_COMPLEMENTARITY_MATRIX",
    "no_A": "INVALID_CONSTRAINT_MATRIX",
    "wrong_dims": "INVALID_ARGUMENT",
    "unbounded_lbL": "INVALID_LOWER_COMPLEMENTARITY_BOUND",
    "bad_file": "UNABLE_TO_READ_FILE",
    "sparse_load_dense_solver": "DENSE_SPARSE_MISSMATCH",
    "sparse_load_switched_dense_osqp": "DENSE_SPARSE_MISSMATCH",
    "dense_load_qpoases_sparse": "DENSE_SPARSE_MISSMATCH",
    "dense_load_osqp_sparse": "DENSE_SPARSE_MISSMATCH",
    "switched_qpoases_dense": "DENSE_SPARSE_MISSMATCH",
    "osqp_box": "INVALID_OSQP_BOX_CONSTRAINTS",
}


@pytest.mark.parametrize("case", sorted(PROTOCOL))
def test_mode_protocol_codes_match_jax(case):
    jret = _protocol_case(jl, jl.LCQProblem, case)
    pret = _protocol_case(
        pl_, lambda *dims: pl_.LCQProblem(*dims, device="cpu"), case)
    assert isinstance(pret, pl_.ReturnValue)
    assert pret.name == jret.name == PROTOCOL[case]
    assert int(pret) == int(jret)
