#!/usr/bin/env python3
"""Where the time of lcqpow_tpu_torch's paths goes, on one CUDA card.

``main`` (the default) solves the 4096-lane warm-up fleet
(``problems.warmup_fleet``) with ``solve_batch_mixed(...,
max_iterations=200, n_corrector_iters=6, escalate=1)``; ``circle`` solves
one 32-lane chunk of the circle fleet (``problems.circle_fleet(32)``,
stationarity tolerance 1e-2, ``chunk=32``, ``escalate=0``).  Each is run
three times without the profiler (host wall clock ending in
``torch.cuda.synchronize()``), then once under ``torch.profiler``, and the
script prints: the unprofiled walls, the device time summed over all
kernels, the device busy share (device time / median unprofiled wall), the
number of kernel launches, and the kernels with the most device time.
Run from the repo root::

    python3 tools/profile_torch_main.py [main|circle]
"""

import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import lcqpow_tpu_torch as lt  # noqa: E402
from lcqpow_tpu_torch.problems import circle_fleet, warmup_fleet  # noqa: E402


def _device_us(evt):
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return getattr(evt, name)
    return 0.0


def main():
    if not torch.cuda.is_available():
        print("profile_torch_main: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip())
    path = sys.argv[1] if len(sys.argv) > 1 else "main"
    opts = lt.Options(print_level=lt.PrintLevel.NONE, max_iterations=200)
    if path == "main":
        data = warmup_fleet(4096)
        run = lambda: lt.solve_batch_mixed(data, opts, n_corrector_iters=6,
                                           escalate=1)
        lt.solve_batch_mixed(warmup_fleet(64), opts, n_corrector_iters=6)
    elif path == "circle":
        opts = opts.replace(stationarity_tolerance=1e-2,
                            qp_solver=lt.QPSolver.OSQP_SPARSE)
        data, x0 = circle_fleet(32)
        run = lambda: lt.solve_batch_mixed(data, opts, x0=x0, chunk=32,
                                           escalate=0)
    else:
        raise SystemExit(f"unknown path {path!r}: main or circle")
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        sol = run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    print(f"walls_s={[round(w, 4) for w in walls]} "
          f"certified={int((sol.ret == 0).sum())}/{sol.ret.shape[0]}")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if _device_us(e) > 0
               and e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(_device_us(e) for e in kernels)
    launches = sum(e.count for e in kernels)
    wall = statistics.median(walls)
    print(f"profiled_wall_s={prof_wall:.4f} device_time_s={dev_us / 1e6:.4f} "
          f"kernel_launches={launches} "
          f"device_busy_share_of_unprofiled_wall={dev_us / 1e6 / wall:.4f}")
    kernels.sort(key=_device_us, reverse=True)
    for e in kernels[:12]:
        print(f"  {_device_us(e) / 1e3:10.3f} ms  {e.count:7d}x  "
              f"{e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
