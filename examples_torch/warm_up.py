"""Warm-up LCQP on lcqpow_tpu_torch (the torch version of
``examples/warm_up.py``; reference ``examples/warm_up.cpp``):

    min  x1^2 + x2^2 - 2 x1 - 2 x2   s.t.  0 <= x1  ⟂  x2 >= 0

Two S-stationary solutions exist: (1,0) and (0,1).

Usage: python examples_torch/warm_up.py [--device cpu]
(runs on the CUDA card unless ``--device`` says otherwise).
"""

import argparse

import numpy as np

import lcqpow_tpu_torch as lt


def main(argv=None):
    p = argparse.ArgumentParser(description="warm-up LCQP")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)

    data = lt.make_lcqp(
        Q=[[2.0, 0.0], [0.0, 2.0]],
        g=[-2.0, -2.0],
        L=[[1.0, 0.0]],
        R=[[0.0, 1.0]],
        device=args.device,
    )

    options = lt.Options(print_level=lt.PrintLevel.INNER_LOOP_ITERATES)
    sol = lt.solve(data, options, x0=np.array([1.0, 1.0]), y0=np.zeros(4))

    stats = sol.stats
    print(f"\nxOpt = [ {float(sol.x[0]):g}, {float(sol.x[1]):g} ];  "
          f"yOpt = [ {float(sol.y[0]):g}, {float(sol.y[1]):g}, "
          f"{float(sol.y[2]):g}, {float(sol.y[3]):g} ]; "
          f"i = {int(stats.iter_total)}; k = {int(stats.iter_outer)}; "
          f"rho = {float(stats.rho_opt):g}; "
          f"WSR = {int(stats.subproblem_iter)}\n")
    print("status:", lt.AlgorithmStatus(int(sol.algo_status)).name)


if __name__ == "__main__":
    main()
