"""The torch examples (``examples_torch/``) run in-process on the CPU
(``--device cpu``), the reference's model of examples as integration tests
(``test.sh:14-21``), as ``tests/test_examples.py`` runs ``examples/``; and
the OptimizeOnCircle oracle of that file through the port's object API at
N = 20 here (N = 100, the reference's size, is marked ``slow``; the card
runs it in ``chip_smoke.py``).
"""

import os
import runpy
import sys

import numpy as np
import pytest

import lcqpow_tpu_torch as lt
from chip_smoke import EXAMPLE_SCRIPTS, circle_oracle
from lcqpow_tpu_torch import io
from lcqpow_tpu_torch.problems import optimize_on_circle, warm_up

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples_torch")

def run_example(name, *args):
    argv = sys.argv
    sys.argv = [os.path.join(EXAMPLES, name + ".py"), *args]
    try:
        runpy.run_path(sys.argv[0], run_name="__main__")
    finally:
        sys.argv = argv


# EXAMPLE_SCRIPTS: the scripts tests/test_examples.py runs, each with a
# line it must print; chip_smoke.py runs the same list on the card.
@pytest.mark.parametrize("name", sorted(EXAMPLE_SCRIPTS))
def test_example_runs_on_cpu(name, capsys):
    run_example(name, "--device", "cpu")
    assert EXAMPLE_SCRIPTS[name] in capsys.readouterr().out


def test_batch_sweep_runs_on_cpu(capsys):
    run_example("batch_sweep", "16", "--device", "cpu")
    out = capsys.readouterr().out
    assert "devices: ['cpu']" in out and "'total': 16" in out


def test_solve_lcqp_from_file_example(tmp_path, capsys):
    data = warm_up(device="cpu")
    for k in ("Q", "g", "L", "R"):
        io.write_vector(str(tmp_path / f"{k}.txt"), getattr(data, k).numpy())
    run_example("solve_lcqp_from_file", str(tmp_path), "--device", "cpu")
    out = capsys.readouterr().out
    assert "nV=2, nC=0, nComp=1" in out and "ret = SUCCESSFUL_RETURN" in out
    with pytest.raises(SystemExit) as exit_:
        run_example("solve_lcqp_from_file", str(tmp_path / "missing"))
    assert "no problem data" in str(exit_.value.code)


def test_solve_lcqp_from_reference_files():
    # The reference's OCP instance (examples/solve_lcqp_from_file.cpp:
    # nV=151, nC=50, nComp=100), when its data is in the repository.
    d = os.path.join(ROOT, "examples", "example_data")
    if not os.path.isfile(os.path.join(d, "g.txt")):
        pytest.skip("reference example_data is not in the repository")
    data = io.load_lcqp_from_files(d, device="cpu")
    assert (data.nV, data.nC, data.nComp) == (151, 50, 100)
    sol = lt.solve(data, lt.Options(print_level=lt.PrintLevel.NONE,
                                    qp_solver=lt.QPSolver.QPOASES_SPARSE),
                   x0=io.load_x0_from_files(d))
    assert int(sol.ret) == 0
    assert int(sol.algo_status) == lt.AlgorithmStatus.S_STATIONARY_SOLUTION


def _circle_through_lcqproblem(N):
    import scipy.sparse as sp

    data, x0 = optimize_on_circle(N, as_numpy=True)
    lcqp = lt.LCQProblem(data.nV, data.nC, data.nComp, device="cpu")
    lcqp.set_options(lt.Options(print_level=lt.PrintLevel.NONE,
                                qp_solver=lt.QPSolver.OSQP_SPARSE,
                                stationarity_tolerance=1e-2))
    csc = lambda a: sp.csc_matrix(np.asarray(a))
    assert lcqp.load_lcqp(csc(data.Q), data.g, csc(data.L), csc(data.R),
                          A=csc(data.A), lbA=data.lbA, ubA=data.ubA,
                          x0=x0) == 0
    assert lcqp.run_solver() == 0
    return lcqp.get_primal_solution()


def test_optimize_on_circle_n20_through_lcqproblem():
    # At N = 20 the feasible set is the 20-gon whose edges touch the unit
    # circle (cos_i x1 + sin_i x2 <= 1), so the oracle's 5e-3 does not hold:
    # the solution lies on an edge, near the N = 100 global solution.
    x = _circle_through_lcqproblem(20)[:2]
    t = 2 * np.pi * np.arange(20) / 20
    edge = np.cos(t) * x[0] + np.sin(t) * x[1]
    assert abs(edge.max() - 1.0) < 1e-8
    assert np.linalg.norm(x - [0.1811, -0.9835]) < 2e-2


@pytest.mark.slow
def test_optimize_on_circle_n100_through_lcqproblem():
    assert circle_oracle(_circle_through_lcqproblem(100))
