"""Warm-up with an extra general linear constraint on lcqpow_tpu_torch
(the torch version of ``examples/warm_up_w_A.py``; reference
``interfaces/python/examples/warm_up_w_A.py`` /
``test/examples/warm_up_w_A.cpp:35-37``):

    min  ||x - (1,1)||^2   s.t.  0 <= x1 ⟂ x2 >= 0,   x1 - x2 >= -0.5

Usage: python examples_torch/warm_up_w_A.py [--device cpu]
"""

import argparse

import numpy as np

import lcqpow_tpu_torch as lt


def main(argv=None):
    p = argparse.ArgumentParser(description="warm-up with a linear row")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)

    lcqp = lt.LCQProblem(nV=2, nC=1, nComp=1, device=args.device)
    lcqp.set_options(lt.Options(
        print_level=lt.PrintLevel.INNER_LOOP_ITERATES))
    ret = lcqp.load_lcqp(
        Q=[[2.0, 0.0], [0.0, 2.0]], g=[-2.0, -2.0],
        L=[[1.0, 0.0]], R=[[0.0, 1.0]],
        A=[[1.0, -1.0]], lbA=[-0.5], ubA=[np.inf])
    assert ret == lt.ReturnValue.SUCCESSFUL_RETURN
    ret = lcqp.run_solver()
    assert ret == lt.ReturnValue.SUCCESSFUL_RETURN, ret
    print("xOpt =", lcqp.get_primal_solution())
    print("yOpt =", lcqp.get_dual_solution())


if __name__ == "__main__":
    main()
