#!/usr/bin/env python3
"""Stress the teardown of lcqpow_tpu_torch's gloo process groups on the CPU.

Run from the root of a checkout::

    python3 tools/torch_gloo_teardown.py [--pairs 6] [--rounds 3] [--raw]

Each round starts ``--pairs`` two-rank groups at once.  Each rank joins
its group through ``parallel.distributed.initialize`` (or, with
``--raw``, through a bare ``torch.distributed.init_process_group`` that
nothing tears down, as ``initialize`` did before it registered
``shutdown``), solves two warm-up lanes through ``solve_batch_sharded``,
adds the ranks' counts with ``fleet_summary`` and exits.  Prints one line
per failed rank process (its exit code and last stderr line) and a last
line with the failures out of the rank processes started.
"""

import argparse
import os
import socket
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import json, sys
rank, port, raw = int(sys.argv[1]), sys.argv[2], sys.argv[3] == "raw"
import torch
import torch.distributed as dist
import lcqpow_tpu_torch as lt
from lcqpow_tpu_torch.parallel import (fleet_summary, make_mesh,
                                       solve_batch_sharded)
from lcqpow_tpu_torch.parallel.distributed import initialize
from lcqpow_tpu_torch.problems import warmup_fleet

url = f"tcp://localhost:{port}"
if raw:
    dist.init_process_group("gloo", init_method=url, world_size=2,
                            rank=rank)
else:
    initialize(url, world_size=2, rank=rank, device="cpu")
opts = lt.Options(print_level=lt.PrintLevel.NONE, max_iterations=100)
sol = solve_batch_sharded(warmup_fleet(2, device="cpu"), opts,
                          mesh=make_mesh(["cpu"]))
print(json.dumps({"rank": rank, "summary": fleet_summary(sol)}))
"""


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--pairs", type=int, default=6)
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--raw", action="store_true")
    args = p.parse_args()
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    mode = "raw" if args.raw else "initialize"
    failed = started = 0
    for _ in range(args.rounds):
        procs = []
        for _ in range(args.pairs):
            port = str(free_port())
            procs += [subprocess.Popen(
                [sys.executable, "-c", WORKER, str(r), port, mode], cwd=ROOT,
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True) for r in range(2)]
        try:
            for proc in procs:
                _, err = proc.communicate(timeout=300)
                started += 1
                if proc.returncode != 0:
                    failed += 1
                    last = (err.strip().splitlines() or [""])[-1]
                    print(f"rank exit {proc.returncode}: {last}", flush=True)
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
    print(f"[teardown] mode={mode} failed={failed} of {started} rank "
          f"processes ({args.pairs} pairs x {args.rounds} rounds)",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
