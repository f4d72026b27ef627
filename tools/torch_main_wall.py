#!/usr/bin/env python3
"""Time chip_smoke.py's main path in several checkouts, in turns, and count
its ops.

Run from the root of a checkout, with one NVIDIA card visible::

    python3 tools/torch_main_wall.py --reps 5 --ops PARENT . . PARENT
    python3 tools/torch_main_wall.py --reps 5 --modes perturb \
        PARENT . PARENT . PARENT . PARENT .

or, to count ops on the CPU (walls there say nothing of the card)::

    python3 tools/torch_main_wall.py --device cpu --reps 0 --ops PARENT .

Each TREE argument (a directory holding ``lcqpow_tpu_torch/``, e.g. a
``git archive`` of another commit) gets a fresh Python process of its own,
in the order given.  The process imports that tree's package, builds its
kernels, and for each mode of ``--modes``, the step perturbation on
("perturb") and off ("plain"), runs one small solve (set-up) and times
``reps`` calls of the main path: ``solve_batch_mixed`` of ``warmup_fleet(4096)`` with
``max_iterations=200``, ``n_corrector_iters=6``, ``escalate=1`` and
``Options(seed=1)``, each wall on the host clock ending in
``torch.cuda.synchronize()``.  With ``seed=1`` a tree that draws
``jax.random``'s bits draws from ``PRNGKey(1)``, bench.py's key and
chip_smoke.py's pinned path; an older tree seeds its own generator with 1.
With the perturbation off, every tree takes the same iterations, so the
difference in walls and ops is the per-pass work a tree adds.  Before
each timed call a probe times 2000 back-to-back one-element adds on the
device (``probe_us``, microseconds per op): the host's speed at launching
small ops, which sets this host-bound path's wall and drifts with the
shared host, so walls of two trees compare as they stand and as
wall / probe.

With ``--ops``, one more call per mode runs under ``torch.profiler`` (host
ops only) and counts the ops it dispatches, by name; and a tree that has
``lcqpow_tpu_torch.prng`` also times, on the main path's
own tensors, what it adds per call (``micro``, ms per call, 200 calls,
CUDA events on the card): the pass's whole step perturbation as that
tree's solver runs it (``perturb_pass``: one ``prng.perturbation`` step
where the tree has it, else ``prng.perturb_step`` with the cast, scale,
add and the two ``lane_where`` of iterate and keys around it), also as
host microseconds per pass (``perturb_pass_host_us``: ``perf_counter``
over 200 passes, then one ``synchronize``), against the ``torch.randint``
a tree before the key discipline drew with; the certificate's feasibility
in df32 (``mixed._violation``) against the f32-first form it replaced;
the split of the root key over the fleet; and the ``lane_where`` of the
carried keys; with the number of ``_violation`` calls in one main call.

One JSON line per process: the tree, per mode the walls, probes, certified
lanes, iteration sum and, with ``--ops``, the op count and the Threefry
kernel's launches of the profiled call; then, with ``--ops``, per mode the
ops whose counts differ most between the first two distinct trees; then a
summary per tree and mode (the walls' median, least and most, and the
median of wall / probe); then the card's name and power limit as
``nvidia-smi`` prints them.  Exits non-zero when a process fails, or
without a card unless ``--device cpu``.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

_CHILD = r"""
import json, sys, time
sys.path.insert(0, ".")
import torch
import lcqpow_tpu_torch as lt
from lcqpow_tpu_torch import _build
from lcqpow_tpu_torch.problems import warmup_fleet

reps, device, modes = int(sys.argv[1]), sys.argv[2], sys.argv[3].split(",")
count_ops = sys.argv[4] == "1"
cuda = device == "cuda"
try:
    from lcqpow_tpu_torch import prng
except ImportError:
    prng = None


def sync():
    if cuda:
        torch.cuda.synchronize()


def main_call(data, opts):
    return lt.solve_batch_mixed(data, opts, n_corrector_iters=6, escalate=1)


def op_counts(data, opts):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        main_call(data, opts)
        sync()
    return {e.key: e.count for e in prof.key_averages()
            if e.key.startswith("aten::")}


def per_call_ms(fn, calls=200):
    fn()
    sync()
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / calls
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    return (time.perf_counter() - t) * 1e3 / calls


def host_us(fn, calls=200):
    fn()
    sync()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    sync()
    return (time.perf_counter() - t) * 1e6 / calls


def probe_us(ops=2000):
    a = torch.zeros(1, device=device)
    sync()
    t = time.perf_counter()
    for _ in range(ops):
        a.add_(1.0)
    sync()
    return (time.perf_counter() - t) * 1e6 / ops


def micro(data, opts):
    # The main path's own tensors: the fleet's keys and, captured from its
    # first call, the certificate's feasibility arguments.
    from lcqpow_tpu_torch import mixed, solver
    from lcqpow_tpu_torch.ops.linalg import lane_where

    fleet_keys = getattr(prng, "fleet_keys", None) or solver.fleet_keys

    seen = []
    orig = mixed._violation

    def record(*args):
        seen.append(args)
        return orig(*args)

    mixed._violation = record
    try:
        main_call(data, opts)
    finally:
        mixed._violation = orig
    Ax, l, u, has_l, has_u = seen[0]
    zero = Ax.hi.new_zeros(())

    def f32_first():
        ax = Ax.hi + Ax.lo
        below = torch.where(has_l, (l.hi + l.lo) - ax, zero)
        above = torch.where(has_u, ax - (u.hi + u.lo), zero)
        return torch.maximum(below.amax(-1), above.amax(-1)).clamp_min(0.0)

    B, n = data.Q.shape[0], data.nV
    keys = fleet_keys(None, 1, B, data.Q.device)
    go = torch.ones(B, dtype=torch.bool, device=data.Q.device)
    done = ~go
    xk = torch.randn((B, n), device=data.Q.device)
    eps = torch.finfo(xk.dtype).eps
    g = torch.Generator(device=data.Q.device).manual_seed(1)
    if hasattr(prng, "perturbation"):
        step = prng.perturbation(keys, xk, eps)
        perturb_pass = lambda: step(keys, go, xk)
    else:
        def perturb_pass():
            k, r = prng.perturb_step(keys, go, n)
            x = lane_where(done, xk, xk + r.to(xk.dtype) * eps)
            return lane_where(go, k, keys), x
    before = prng.launch_count
    out = dict(
        perturb_pass=per_call_ms(perturb_pass),
        perturb_pass_host_us=host_us(perturb_pass),
        torch_randint=per_call_ms(lambda: torch.randint(
            -1, 2, (B, n), generator=g, device=data.Q.device)),
        violation_df32=per_call_ms(lambda: mixed._violation(
            Ax, l, u, has_l, has_u)),
        violation_f32_first=per_call_ms(f32_first),
        fleet_keys=per_call_ms(lambda: fleet_keys(None, 1, B,
                                                  data.Q.device)),
        lane_where_keys=per_call_ms(lambda: lane_where(go, keys, keys)),
        violation_shape=list(Ax.hi.shape), violation_calls=len(seen))
    prng.launch_count = before
    return out


if cuda:
    _build.build_all()
base = lt.Options(print_level=lt.PrintLevel.NONE, max_iterations=200, seed=1)
data = warmup_fleet(4096, device=device)
res = {"device": torch.cuda.get_device_name(0) if cuda else "cpu"}
for mode in modes:
    opts = base.replace(perturb_step=mode == "perturb")
    main_call(warmup_fleet(64, device=device), opts)
    sync()
    walls, probes = [], []
    sol = None
    for _ in range(reps):
        probes.append(probe_us())
        t = time.perf_counter()
        sol = main_call(data, opts)
        sync()
        walls.append(time.perf_counter() - t)
    res[mode] = {"walls_s": walls, "probe_us": probes}
    if count_ops:
        if prng is not None:
            prng.launch_count = 0
        ops = op_counts(data, opts)
        res[mode].update(
            ops=sum(ops.values()), ops_by_name=ops,
            threefry_launches=None if prng is None else prng.launch_count)
    if sol is None:
        sol = main_call(data, opts)
        sync()
    res[mode].update(certified=int((sol.ret == 0).sum()),
                     iter_total_sum=int(sol.stats.iter_total.sum()))
if count_ops and prng is not None:
    res["micro"] = micro(data, base)
print(json.dumps(res))
"""


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--modes", default="perturb,plain",
                    help="comma-separated: perturb, plain")
    ap.add_argument("--ops", action="store_true",
                    help="count ops by name and time the additions")
    ap.add_argument("--top", type=int, default=15,
                    help="ops listed per mode in the comparison")
    args = ap.parse_args()
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch_main_wall: no CUDA device", file=sys.stderr)
        return 1
    results = []
    for tree in args.trees:
        out = subprocess.run(
            [sys.executable, "-c", _CHILD, str(args.reps), args.device,
             args.modes, "1" if args.ops else "0"],
            cwd=tree, capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            print(out.stdout + out.stderr, file=sys.stderr)
            return 1
        res = json.loads(out.stdout.strip().splitlines()[-1])
        res = {"tree": os.path.normpath(tree)} | res
        results.append(res)
        brief = {k: ({kk: vv for kk, vv in v.items() if kk != "ops_by_name"}
                     if isinstance(v, dict) and "ops_by_name" in v else v)
                 for k, v in res.items()}
        print(json.dumps(brief), flush=True)
    distinct = list({r["tree"]: r for r in results}.values())
    if args.ops and len(distinct) >= 2:
        a, b = distinct[:2]
        for mode in ("perturb", "plain"):
            ca, cb = a[mode]["ops_by_name"], b[mode]["ops_by_name"]
            diff = {k: cb.get(k, 0) - ca.get(k, 0) for k in set(ca) | set(cb)}
            top = sorted(diff.items(), key=lambda kv: -abs(kv[1]))[:args.top]
            print(json.dumps({"ops_diff": mode, "from": a["tree"],
                              "to": b["tree"],
                              "total": b[mode]["ops"] - a[mode]["ops"],
                              "top": dict(top)}), flush=True)
    for tree in dict.fromkeys(r["tree"] for r in results):
        for mode in args.modes.split(","):
            runs = [r[mode] for r in results if r["tree"] == tree]
            walls = [w for m in runs for w in m["walls_s"]]
            ratio = [w / p for m in runs
                     for w, p in zip(m["walls_s"], m["probe_us"])]
            if walls:
                print(json.dumps({"summary": tree, "mode": mode,
                                  "calls": len(walls),
                                  "median_wall_s": statistics.median(walls),
                                  "min_wall_s": min(walls),
                                  "max_wall_s": max(walls),
                                  "median_wall_per_probe": statistics.median(
                                      ratio)}), flush=True)
    if args.device == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True,
                             timeout=60).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
