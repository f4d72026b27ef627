#!/usr/bin/env python3
"""Check lcqpow_tpu_torch.parallel across several devices and processes.

Run from the root of a checkout::

    python3 tools/torch_multicard.py                # every visible card
    python3 tools/torch_multicard.py --device cpu --procs 4   # rehearsal

1. One process: ``solve_batch_sharded`` of ``warmup_fleet(B)`` over
   ``make_mesh()`` (every card, or ``--procs`` CPU "devices"), with
   ``perturb_step=False`` (each slice draws from its own generator):
   bit for bit ``solve_batch`` of each slice on its device, gathered in
   order; and against ``solve_batch`` of the whole fleet on the first
   device, the same return codes and x to 1e-9 (a slice is solved at its
   own width, and cuBLAS may sum a narrower batch in another order).
2. ``--procs`` processes (default: one per card) joined by
   ``distributed.initialize`` (NCCL on the cards, gloo with ``--device
   cpu``): each rank takes its lanes of the same fleet
   (``host_local_batch_to_global``), solves them with ``solve_batch_mixed``
   and compares them with the single-process solve of its lanes, and
   ``fleet_summary`` adds the ranks' counts with ``all_reduce``: every
   rank must get the same summary, whose counts are the sums of the
   ranks' own.

Prints one line per step with its wall seconds (a rank's: its solve after
a small warm-up solve); exits non-zero when a check fails.
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import lcqpow_tpu_torch as lt  # noqa: E402
from lcqpow_tpu_torch.parallel import (fleet_summary, make_mesh,  # noqa: E402
                                       shard_batch, solve_batch_sharded)
from lcqpow_tpu_torch.problems import warmup_fleet  # noqa: E402

OPTS = lt.Options(print_level=lt.PrintLevel.NONE, max_iterations=200)


def sync():
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


def same(a, b):
    return all(torch.equal(x.cpu(), y.cpu()) for x, y in (
        (a.x, b.x), (a.y, b.y), (a.ret, b.ret),
        (a.stats.iter_total, b.stats.iter_total)))


def one_process(args):
    mesh = make_mesh(None if args.device is None
                     else [args.device] * args.procs)
    fleet = warmup_fleet(args.batch, device=mesh[0])
    opts = OPTS.replace(perturb_step=False)
    t0 = time.perf_counter()
    a = solve_batch_sharded(fleet, opts, mesh=mesh)
    sync()
    t1 = time.perf_counter()
    parts = [lt.solve_batch(d, opts) for d in shard_batch(fleet, mesh)]
    by_slice = parts[0].map(
        lambda *xs: torch.cat([x.to(mesh[0]) for x in xs]), *parts[1:])
    sync()
    t2 = time.perf_counter()
    whole = lt.solve_batch(fleet, opts)
    sync()
    t3 = time.perf_counter()
    ok_slices = same(a, by_slice)
    dx = float((a.x - whole.x).abs().max())
    ok_whole = torch.equal(a.ret, whole.ret) and dx <= 1e-9
    print(f"[sharded] mesh={[str(d) for d in mesh]} B={args.batch} "
          f"bitwise_by_slice={ok_slices} same_ret_as_whole="
          f"{torch.equal(a.ret, whole.ret)} max_abs_dx_vs_whole={dx:.3e} "
          f"solved={int((a.ret == 0).sum())} sharded_s={t1 - t0:.3f} "
          f"slices_s={t2 - t1:.3f} whole_s={t3 - t2:.3f}", flush=True)
    return ok_slices and ok_whole


def rank_main(args):
    from lcqpow_tpu_torch.parallel.distributed import (
        host_local_batch_to_global, initialize)

    initialize(f"tcp://localhost:{args.port}", world_size=args.procs,
               rank=args.rank, device=args.device)
    fleet = warmup_fleet(args.batch, device="cpu")
    per = args.batch // args.procs
    mine = fleet.map(lambda a: a[args.rank * per:(args.rank + 1) * per])
    dev = torch.device(args.device) if args.device else None
    hb = host_local_batch_to_global(mine, device=dev)
    # A small solve first, so device set-up stays out of the timed one.
    lt.solve_batch_mixed(hb.data.map(lambda a: a[:8]), OPTS,
                         n_corrector_iters=6)
    sync()
    t0 = time.perf_counter()
    sol = lt.solve_batch_mixed(hb.data, OPTS, n_corrector_iters=6,
                               escalate=1)
    sync()
    wall = time.perf_counter() - t0
    ref = lt.solve_batch_mixed(mine.map(lambda a: a.to(hb.data.Q.device)),
                               OPTS, n_corrector_iters=6, escalate=1)
    stages = torch.bincount(sol.stats.certified_stage.cpu()).tolist()
    print(json.dumps({"rank": args.rank, "offset": hb.offset,
                      "total": hb.total, "same": same(sol, ref),
                      "device": str(hb.data.Q.device), "wall_s": wall,
                      "solved": int((sol.ret == 0).sum()),
                      "stages": {s: c for s, c in enumerate(stages) if c},
                      "summary": fleet_summary(sol)}), flush=True)


def many_processes(args):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    cmd = [sys.executable, os.path.abspath(__file__), "--rank", "{r}",
           "--port", str(port), "--procs", str(args.procs),
           "--batch", str(args.batch)]
    if args.device:
        cmd += ["--device", args.device]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([c.format(r=r) for c in cmd], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(args.procs)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600) + (p.returncode,))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    wall = time.perf_counter() - t0
    if any(rc != 0 for _, _, rc in outs):
        for out, err, rc in outs:
            print(f"rank exit {rc}\n{out}\n{err}", file=sys.stderr)
        return False
    res = [json.loads(o.strip().splitlines()[-1]) for o, _, _ in outs]
    for r in sorted(res, key=lambda r: r["rank"]):
        print(f"[rank {r['rank']}] device={r['device']} offset={r['offset']} "
              f"same_as_one_process={r['same']} wall_s={r['wall_s']:.3f}",
              flush=True)
    # Every rank gets the same summary: the sums of the ranks' own counts.
    agree = all(r["summary"] == res[0]["summary"] for r in res)
    got = res[0]["summary"]
    stages = {}
    for r in res:
        for k, c in r["stages"].items():
            stages[k] = stages.get(k, 0) + c
    ok = (agree and all(r["same"] for r in res)
          and [r["offset"] for r in sorted(res, key=lambda r: r["rank"])]
          == [i * (args.batch // args.procs) for i in range(args.procs)]
          and got["solved"] == sum(r["solved"] for r in res)
          and got["total"] == args.batch
          and got["certified_by_stage"] == stages)
    print(f"[distributed] procs={args.procs} ok={ok} summary={got} "
          f"wall_s={wall:.3f}", flush=True)
    return ok


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None)
    p.add_argument("--procs", type=int, default=None)
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--rank", type=int, default=None)
    p.add_argument("--port", type=int, default=None)
    args = p.parse_args()
    if args.rank is not None:
        return rank_main(args)
    if args.procs is None:
        args.procs = torch.cuda.device_count()
    if args.device is None:
        from lcqpow_tpu_torch import _build

        _build.build_all()          # once, before the ranks load it
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip(), flush=True)
    ok = one_process(args) and many_processes(args)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
