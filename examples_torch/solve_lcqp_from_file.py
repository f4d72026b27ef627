"""Solve an LCQP loaded from whitespace-separated ``.txt`` files on
lcqpow_tpu_torch (the torch version of ``examples/solve_lcqp_from_file.py``;
reference ``examples/solve_lcqp_from_file.cpp``).

Usage: python examples_torch/solve_lcqp_from_file.py [data_dir] [--device cpu]

The directory must contain ``Q.txt g.txt L.txt R.txt`` and may contain
``lbL ubL lbR ubR A lbA ubA lb ub x0``: the layout of the reference's
``examples/example_data`` (an OCP instance, nV=151, nC=50, nComp=100).  The
default is ``examples/example_data`` beside this directory; the script exits
with a message when the data is not there.
"""

import argparse
import os
import sys

import lcqpow_tpu_torch as lt
from lcqpow_tpu_torch import io

DEFAULT_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples", "example_data")


def main(argv=None):
    p = argparse.ArgumentParser(description="solve an LCQP from text files")
    p.add_argument("data_dir", nargs="?", default=DEFAULT_DIR)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    d = args.data_dir
    if not os.path.isfile(os.path.join(d, "g.txt")):
        sys.exit(f"solve_lcqp_from_file: no problem data in {d!r} (needs "
                 "Q.txt g.txt L.txt R.txt; the reference's "
                 "examples/example_data has that layout)")
    data = io.load_lcqp_from_files(d, device=args.device)
    x0 = io.load_x0_from_files(d)
    print(f"Loaded LCQP: nV={data.nV}, nC={data.nC}, nComp={data.nComp}")

    options = lt.Options(print_level=lt.PrintLevel.INNER_LOOP_ITERATES,
                         qp_solver=lt.QPSolver.QPOASES_SPARSE)
    sol = lt.solve(data, options, x0=x0)

    stats = sol.stats
    print(f"\nret = {lt.ReturnValue(int(sol.ret)).name}; "
          f"status = {lt.AlgorithmStatus(int(sol.algo_status)).name}; "
          f"i = {int(stats.iter_total)}; rho = {float(stats.rho_opt):g}")
    print("x[:6] =", [round(float(v), 6) for v in sol.x[:6]])


if __name__ == "__main__":
    main()
