"""OptimizeOnCircle with per-iterate trajectory tracking on
lcqpow_tpu_torch (the torch version of
``examples/optimize_on_circle_store_steps.py``; reference
``interfaces/python/examples/OptimizeOnCircleStoreSteps.py``):
``Options.store_steps`` is the reference's ``storeSteps``
(``include/OutputStatistics.hpp:217-226``).

Usage: python examples_torch/optimize_on_circle_store_steps.py [--device cpu]
"""

import argparse

import lcqpow_tpu_torch as lt
from lcqpow_tpu_torch.problems import optimize_on_circle


def main(argv=None):
    p = argparse.ArgumentParser(description="OptimizeOnCircle, store steps")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)

    N = 20
    data, x0 = optimize_on_circle(N, device=args.device)
    opts = lt.Options(print_level=lt.PrintLevel.NONE, max_iterations=200,
                      stationarity_tolerance=1e-2,
                      qp_solver=lt.QPSolver.OSQP_SPARSE,
                      store_steps=True)
    sol = lt.solve(data, opts, x0=x0)
    assert int(sol.ret) == lt.ReturnValue.SUCCESSFUL_RETURN, int(sol.ret)
    t = sol.stats.trim().trajectories
    n = int(sol.stats.iter_total)
    print(f"solved in {n} iterations; x* = {sol.x[:2].cpu().numpy()}")
    print("iter |   stat     |    phi     |   merit    | alpha")
    for i in range(n):
        print(f"{i:4d} | {float(t.stat_vals[i]):10.3e} | "
              f"{float(t.phi_vals[i]):10.3e} | "
              f"{float(t.merit_vals[i]):10.3e} | "
              f"{float(t.step_length[i]):6.3f}")


if __name__ == "__main__":
    main()
