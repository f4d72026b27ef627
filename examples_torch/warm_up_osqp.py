"""Warm-up via the OSQP-semantics mode with custom inner-solver settings on
lcqpow_tpu_torch (the torch version of ``examples/warm_up_osqp.py``;
reference ``interfaces/python/examples/warm_up_osqp.py`` /
``test/examples/warm_up_OSQP_options.cpp:56-63``).

``QPSolver.OSQP_SPARSE`` keeps the reference's observable semantics: the
dual vector drops the box block, and box constraints are rejected.  The
embedded :class:`~lcqpow_tpu_torch.ADMMOptions` plays the role of the
reference's ``OSQPSettings`` passthrough.

Usage: python examples_torch/warm_up_osqp.py [--device cpu]
"""

import argparse

import numpy as np

import lcqpow_tpu_torch as lt


def main(argv=None):
    p = argparse.ArgumentParser(description="warm-up in OSQP mode")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)

    lcqp = lt.LCQProblem(nV=2, nC=0, nComp=1, device=args.device)
    lcqp.set_options(lt.Options(
        print_level=lt.PrintLevel.OUTER_LOOP_ITERATES,
        qp_solver=lt.QPSolver.OSQP_SPARSE,
        admm=lt.ADMMOptions(rho=0.05, sigma=1e-6, eps_abs=1e-9,
                            eps_rel=1e-9, max_iter=8000)))
    ret = lcqp.load_lcqp(
        Q=[[2.0, 0.0], [0.0, 2.0]], g=[-2.0, -2.0],
        L=[[1.0, 0.0]], R=[[0.0, 1.0]], x0=np.array([1.0, 1.0]))
    assert ret == lt.ReturnValue.SUCCESSFUL_RETURN
    lcqp.switch_to_sparse_mode()          # required protocol for sparse enums
    ret = lcqp.run_solver()
    assert ret == lt.ReturnValue.SUCCESSFUL_RETURN, ret
    print("xOpt =", lcqp.get_primal_solution())
    print("yOpt =", lcqp.get_dual_solution())   # [y_A; y_L; y_R] — no box


if __name__ == "__main__":
    main()
