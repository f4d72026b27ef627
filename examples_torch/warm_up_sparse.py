"""Warm-up loaded from scipy.sparse CSC matrices on lcqpow_tpu_torch (the
torch version of ``examples/warm_up_sparse.py``; reference
``interfaces/python/examples/warm_up_sparse.py``).  A sparse load puts the
object in sparse mode, as the reference's CSC overload does; without scipy
the dense load and ``switch_to_sparse_mode`` stand in.

Usage: python examples_torch/warm_up_sparse.py [--device cpu]
"""

import argparse

import numpy as np

import lcqpow_tpu_torch as lt


def main(argv=None):
    p = argparse.ArgumentParser(description="warm-up from CSC matrices")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    try:
        import scipy.sparse as sp
    except ImportError:
        print("scipy not available; using dense + switch_to_sparse_mode")
        sp = None

    Q = [[2.0, 0.0], [0.0, 2.0]]
    L = [[1.0, 0.0]]
    R = [[0.0, 1.0]]
    if sp is not None:
        Q, L, R = sp.csc_matrix(Q), sp.csc_matrix(L), sp.csc_matrix(R)

    lcqp = lt.LCQProblem(nV=2, nC=0, nComp=1, device=args.device)
    lcqp.set_options(lt.Options(
        print_level=lt.PrintLevel.INNER_LOOP_ITERATES,
        qp_solver=lt.QPSolver.QPOASES_SPARSE))
    ret = lcqp.load_lcqp(Q=Q, g=[-2.0, -2.0], L=L, R=R,
                         x0=np.array([1.0, 1.0]))
    assert ret == lt.ReturnValue.SUCCESSFUL_RETURN
    if sp is None:
        lcqp.switch_to_sparse_mode()
    ret = lcqp.run_solver()
    assert ret == lt.ReturnValue.SUCCESSFUL_RETURN, ret
    print("xOpt =", lcqp.get_primal_solution())


if __name__ == "__main__":
    main()
