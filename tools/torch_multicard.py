#!/usr/bin/env python3
"""Check lcqpow_tpu_torch.parallel across several devices and processes.

Run from the root of a checkout::

    python3 tools/torch_multicard.py                # every visible card
    python3 tools/torch_multicard.py --device cpu --procs 4   # rehearsal

1. One process: ``solve_batch_sharded`` of ``warmup_fleet(B)`` over
   ``make_mesh()`` (every card, or ``--procs`` CPU "devices"), with
   ``perturb_step=False`` (the setting its recorded walls were taken at): its
   slices run at once, one worker thread a device.  After a small solve on
   every device and a small sharded solve (CUDA context, cuBLAS handles,
   the workers' streams: first-use costs stay out of the walls), three
   walls in turns, twice each: the sharded call, ``solve_batch`` of the
   slices one after the other (each slice's wall too), and ``solve_batch``
   of the whole fleet on the first device.  Checks: the sharded call is
   bit for bit ``solve_batch`` of each slice on its device, gathered in
   order; against the whole fleet, the same return codes and x to 1e-9 (a
   slice is solved at its own width, and cuBLAS may sum a narrower batch
   in another order).  ``--ablate-baton`` adds, in turns with the rest,
   sharded calls whose workers hand their baton
   (``lcqpow_tpu_torch._sync.Baton``) over at every host sync, and
   sharded calls whose workers have none (the GIL changes hands on every
   op), two of each.  With
   ``--trace PATH``, one more sharded call runs
   under ``torch.profiler``: a line gives each device's kernel count and
   time and each thread's PyTorch ops, against the call's wall, and a
   40 ms window of its Chrome trace goes to ``PATH`` (gzipped).
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
import contextlib
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


def timed(fn):
    sync()
    t = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t


def serial_slices(fleet, opts, mesh):
    """``solve_batch`` of each slice in turn, gathered on the first device;
    with each slice's wall."""
    parts, walls = [], []
    for d in shard_batch(fleet, mesh):
        sol, wall = timed(lambda: lt.solve_batch(d, opts))
        parts.append(sol)
        walls.append(wall)
    return parts[0].map(lambda *xs: torch.cat([x.to(mesh[0]) for x in xs]),
                        *parts[1:]), walls


def trace_sharded(fleet, opts, mesh, path, window_ms=40.0):
    """One sharded call under ``torch.profiler``.  Prints the call's wall,
    each device's kernels (count, seconds) and each thread's top-level
    PyTorch ops (count, seconds); writes to ``path`` (gzipped Chrome
    trace) the events of a ``window_ms`` window from the middle of the
    call, where every worker thread is launching."""
    import gzip
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    try:        # newer PyTorch: ops of every thread, not only this one's
        extra = {"experimental_config": torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)}
    except (AttributeError, TypeError):
        extra = {}
    with profile(activities=acts, **extra) as prof:
        _, wall = timed(lambda: solve_batch_sharded(fleet, opts, mesh=mesh))
    devices, threads = {}, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            acc = devices.setdefault(e.device_index, [0, 0.0])
        elif e.cpu_parent is None:
            acc = threads.setdefault(e.thread, [0, 0.0])
        else:
            continue
        acc[0] += 1
        acc[1] += e.time_range.elapsed_us() / 1e6
    raw = path + ".tmp.json"
    prof.export_chrome_trace(raw)
    with open(raw) as f:
        trace = json.load(f)
    os.remove(raw)
    timed_events = [e for e in trace["traceEvents"] if "ts" in e]
    t0 = min(float(e["ts"]) for e in timed_events)
    t1 = max(float(e["ts"]) for e in timed_events)
    lo = (t0 + t1) / 2
    hi = lo + window_ms * 1e3
    trace["traceEvents"] = [e for e in trace["traceEvents"]
                            if "ts" not in e or lo <= float(e["ts"]) < hi]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with gzip.open(path, "wt") as f:
        json.dump(trace, f)
    fmt = lambda d: {k: (n, round(s, 4)) for k, (n, s) in sorted(d.items())}
    print(f"[trace] wall_s={wall:.3f} device_kernels(count,s)={fmt(devices)} "
          f"thread_ops(count,s)={sorted(fmt(threads).values())} "
          f"window_ms={window_ms} trace={path}", flush=True)


class _NoBaton:
    def held(self):
        return contextlib.nullcontext()


@contextlib.contextmanager
def baton_variant(variant):
    """The sharded solve's workers with another baton (an ablation):
    ``"none"``, or ``"every_sync"`` (handed over at every host sync)."""
    from lcqpow_tpu_torch import _sync
    from lcqpow_tpu_torch.parallel import sharding

    real = sharding.Baton
    sharding.Baton = (_NoBaton if variant == "none"
                      else lambda: _sync.Baton(hold_s=0.0))
    try:
        yield
    finally:
        sharding.Baton = real


def one_process(args):
    mesh = make_mesh(None if args.device is None
                     else [args.device] * args.procs)
    fleet = warmup_fleet(args.batch, device=mesh[0])
    opts = OPTS.replace(perturb_step=False)
    for dev in dict.fromkeys(mesh):
        lt.solve_batch(warmup_fleet(8, device=dev), opts)
    solve_batch_sharded(warmup_fleet(8 * len(mesh), device=mesh[0]), opts,
                        mesh=mesh)
    kinds = ["sharded", "slices", "whole", "whole", "slices", "sharded"]
    if args.ablate_baton:
        kinds[3:3] = ["every_sync", "none", "none", "every_sync"]
    walls = {kind: [] for kind in kinds}
    slice_walls = []
    runs = {}
    for kind in kinds:
        if kind == "sharded":
            sol, wall = timed(lambda: solve_batch_sharded(fleet, opts,
                                                          mesh=mesh))
        elif kind in ("every_sync", "none"):
            with baton_variant(kind):
                sol, wall = timed(lambda: solve_batch_sharded(fleet, opts,
                                                              mesh=mesh))
        elif kind == "slices":
            (sol, per), wall = timed(lambda: serial_slices(fleet, opts, mesh))
            slice_walls.append(per)
        else:
            sol, wall = timed(lambda: lt.solve_batch(fleet, opts))
        walls[kind].append(wall)
        runs.setdefault(kind, []).append(sol)
    by_slice = runs["slices"][0]
    ok_slices = all(same(a, by_slice) for kind, sols in runs.items()
                    for a in (sols[1:] if kind == "slices" else sols)
                    if kind != "whole")
    whole = runs["whole"][0]
    a = runs["sharded"][0]
    dx = float((a.x - whole.x).abs().max())
    ok_whole = torch.equal(a.ret, whole.ret) and dx <= 1e-9
    fmt = lambda ws: "/".join(f"{w:.3f}" for w in ws)
    print(f"[sharded] mesh={[str(d) for d in mesh]} B={args.batch} "
          f"bitwise_by_slice={ok_slices} same_ret_as_whole="
          f"{torch.equal(a.ret, whole.ret)} max_abs_dx_vs_whole={dx:.3e} "
          f"solved={int((a.ret == 0).sum())} "
          f"concurrent_s={fmt(walls['sharded'])} "
          f"serial_s={fmt(walls['slices'])} whole_s={fmt(walls['whole'])} "
          f"baton_every_sync_s={fmt(walls.get('every_sync', [])) or '-'} "
          f"no_baton_s={fmt(walls.get('none', [])) or '-'} "
          f"slice_s={[fmt(w) for w in slice_walls]}", flush=True)
    if args.trace:
        trace_sharded(fleet, opts, mesh, args.trace)
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
    p.add_argument("--ablate-baton", action="store_true",
                   help="also time sharded calls with other batons")
    p.add_argument("--trace", default=None,
                   help="write a gzipped Chrome trace of one sharded call")
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
