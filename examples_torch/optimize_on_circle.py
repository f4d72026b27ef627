"""Unit-circle optimization on lcqpow_tpu_torch (the torch version of
``examples/optimize_on_circle.py``; reference
``examples/OptimizeOnCircle.cpp``): project a reference point onto the unit
circle discretized into N = 100 vertices, with a complementarity constraint
selecting the active vertex.

Usage: python examples_torch/optimize_on_circle.py [--device cpu]
"""

import argparse

import lcqpow_tpu_torch as lt
from lcqpow_tpu_torch.problems import optimize_on_circle


def main(argv=None):
    p = argparse.ArgumentParser(description="OptimizeOnCircle, N = 100")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)

    data, x0 = optimize_on_circle(N=100, device=args.device)

    options = lt.Options(
        print_level=lt.PrintLevel.INNER_LOOP_ITERATES,
        qp_solver=lt.QPSolver.OSQP_SPARSE,
        stationarity_tolerance=10e-3,
    )
    sol = lt.solve(data, options, x0=x0)

    stats = sol.stats
    print(f"\nxOpt = [ {float(sol.x[0]):g}, {float(sol.x[1]):g} ];  "
          f"i = {int(stats.iter_total)}; k = {int(stats.iter_outer)}; "
          f"rho = {float(stats.rho_opt):g}; "
          f"WSR = {int(stats.subproblem_iter)}\n")
    print("For reference: Global solution is at:  [ 0.1811, -0.9835 ]")
    print("               Another local solution: [ 0.9764, -0.2183 ]")


if __name__ == "__main__":
    main()
