"""Batched LCQP sweep over every card on lcqpow_tpu_torch (the torch
version of ``examples/batch_sweep.py``): a fleet of randomized
warm-up-class LCQPs solved in lockstep, split over the devices of
:func:`lcqpow_tpu_torch.parallel.make_mesh`.

Usage: python examples_torch/batch_sweep.py [batch_size] [--device cpu]
"""

import argparse
import time

import numpy as np
import torch

import lcqpow_tpu_torch as lt
from lcqpow_tpu_torch.parallel import (fleet_summary, make_mesh,
                                       solve_batch_sharded)
from lcqpow_tpu_torch.problems import random_lcqp


def main(argv=None):
    p = argparse.ArgumentParser(description="batched sweep")
    p.add_argument("batch_size", nargs="?", type=int, default=1024)
    p.add_argument("--device", default=None,
                   help="torch device (default: every CUDA card)")
    args = p.parse_args(argv)
    B = args.batch_size
    rng = np.random.default_rng(0)
    mesh = make_mesh(None if args.device is None else [args.device])
    # Built on the host; solve_batch_sharded moves each slice to its device
    # and gathers the lanes back here.
    problems = [random_lcqp(rng, nV=8, nC=2, nComp=2, device="cpu")
                for _ in range(B)]
    batch = lt.stack_lcqps(problems)
    print(f"devices: {[str(d) for d in mesh]}")

    def sync():
        for d in mesh:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    opts = lt.Options(print_level=lt.PrintLevel.NONE)
    t0 = time.perf_counter()
    sol = solve_batch_sharded(batch, opts, mesh=mesh)
    sync()
    dt = time.perf_counter() - t0
    print(f"first call: {dt:.2f}s")

    t0 = time.perf_counter()
    sol = solve_batch_sharded(batch, opts, mesh=mesh)
    sync()
    dt = time.perf_counter() - t0
    print(f"second call: {B} solves in {dt * 1e3:.1f} ms "
          f"-> {B / dt:.0f} solves/s")
    print(fleet_summary(sol))


if __name__ == "__main__":
    main()
