"""Warm-up with generalized (shifted) complementarity bounds on
lcqpow_tpu_torch (the torch version of ``examples/warm_up_binary.py``;
reference ``interfaces/python/examples/warm_up_binary.py`` /
``test/examples/warm_up_binary.cpp:37-46``):

    0 <= x1 + x2       ⟂  -x2 >= 0
    0 <= x2            ⟂   x1 >= -0.5      (lbR = -0.5)

Solved twice like the reference: once from the origin with defaults, once
from a far start with ``solve_zero_penalty_first=False`` and a large initial
penalty.

Usage: python examples_torch/warm_up_binary.py [--device cpu]
"""

import argparse

import numpy as np

import lcqpow_tpu_torch as lt


def main(argv=None):
    p = argparse.ArgumentParser(description="warm-up with shifted bounds")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)

    Q = [[2.0, 0.0], [0.0, 2.0]]
    g = [-2.0, -2.0]
    L = [[1.0, 1.0], [0.0, 0.0]]
    R = [[0.0, -1.0], [1.0, 0.0]]
    lbL = [0.0, 0.0]
    lbR = [0.0, -0.5]

    lcqp = lt.LCQProblem(nV=2, nC=0, nComp=2, device=args.device)
    lcqp.set_options(lt.Options(
        print_level=lt.PrintLevel.INNER_LOOP_ITERATES,
        qp_solver=lt.QPSolver.QPOASES_DENSE))
    ret = lcqp.load_lcqp(Q=Q, g=g, L=L, R=R, lbL=lbL, lbR=lbR,
                         x0=np.zeros(2))
    assert ret == lt.ReturnValue.SUCCESSFUL_RETURN
    ret = lcqp.run_solver()
    print("first solve:", lt.ReturnValue(int(ret)).name)

    # Second solve: far initial guess, no zero-penalty first QP, rho0 = 10.
    lcqp.set_options(lt.Options(
        print_level=lt.PrintLevel.INNER_LOOP_ITERATES,
        solve_zero_penalty_first=False,
        initial_penalty_parameter=10.0))
    lcqp.load_lcqp(Q=Q, g=g, L=L, R=R, lbL=lbL, lbR=lbR,
                   x0=np.array([0.0, 3000.0]))
    ret = lcqp.run_solver()
    print("second solve:", lt.ReturnValue(int(ret)).name)

    stats = lcqp.get_output_statistics()
    print("xOpt =", lcqp.get_primal_solution())
    print("yOpt =", lcqp.get_dual_solution())
    print("i =", stats.get_iter_total())
    print("k =", stats.get_iter_outer())
    print("rho =", stats.get_rho_opt())
    print("WSR =", stats.get_subproblem_iter())


if __name__ == "__main__":
    main()
