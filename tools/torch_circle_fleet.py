#!/usr/bin/env python3
"""Solve the benchmark's circle fleet with the port once and print its
outcome: the floor that ``chip_smoke.py``'s circle-N20-512 path holds.

Run from the root of a checkout::

    python3 tools/torch_circle_fleet.py --device cpu        # N = 20, B = 512
    python3 tools/torch_circle_fleet.py --N 20 --batch 512  # on the card

The fleet is ``problems.circle_fleet(batch, N=N)`` (``bench.py:139-154``),
solved as ``chip_smoke.py`` solves it: ``solve_batch_mixed`` with
stationarity 1e-2, ``OSQP_SPARSE``, the lifted start, no chunk,
``escalate=3``, on bench.py's root key ``PRNGKey(1)``.  Prints one JSON
line: the device, wall seconds, certified lanes, lanes by certification
stage, the ``iter_total`` sum, the GJ inverse's calls by (B, m) (counted
at the wrapper, so on the CPU too) and the f64 audit.
"""

import argparse
import collections
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

import lcqpow_tpu_torch as lt  # noqa: E402
import lcqpow_tpu_torch.ops.chol as chol  # noqa: E402
from lcqpow_tpu_torch import prng  # noqa: E402
from lcqpow_tpu_torch.problems import circle_fleet  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--N", type=int, default=20)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--device", default=None,
                    help="cpu, or the card when not given")
    args = ap.parse_args()
    calls = collections.Counter()
    inverse = chol.gj_inverse

    def counted(S):
        calls[f"{S.shape[0]},{S.shape[-1]}"] += 1
        return inverse(S)

    chol.gj_inverse = counted
    opts = lt.Options(print_level=lt.PrintLevel.NONE, max_iterations=200,
                      stationarity_tolerance=1e-2,
                      qp_solver=lt.QPSolver.OSQP_SPARSE)
    fleet, x0 = circle_fleet(args.batch, device=args.device, N=args.N)
    dev = fleet.Q.device
    t = time.perf_counter()
    sol = lt.solve_batch_mixed(fleet, opts, x0=x0,
                               key=prng.prng_key(1, dev), chunk=0,
                               escalate=3)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t
    stages = torch.unique(sol.stats.certified_stage.cpu(),
                          return_counts=True)
    print(json.dumps({
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "N": args.N, "batch": args.batch, "wall_s": wall,
        "certified": int((sol.ret == 0).sum()),
        "stages": {int(k): int(v) for k, v in zip(*stages)},
        "iter_total_sum": int(sol.stats.iter_total.sum()),
        "gj_calls_by_shape": dict(sorted(calls.items())),
        "audit": lt.audit_solution(fleet, sol, opts)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
