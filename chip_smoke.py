#!/usr/bin/env python3
"""Drive lcqpow_tpu_torch's main path on one CUDA card and check it.

Run from the root of a checkout, with one NVIDIA card visible::

    python3 chip_smoke.py

Phases, each printing one line with its seconds:

1. device: the card's name and count, then the raw
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` line;
2. build: ``nvcc`` of every kernel source under ``lcqpow_tpu_torch/csrc``,
   and ptxas's registers and spills of the kernels at m = 8, 14, 32, 48;
3. kernel: the Gauss-Jordan kernel against its plain PyTorch version on
   Jacobi-scaled SPD batches at (B, m) in (4096, 8), (4096, 14), (4095, 14),
   (512, 48), (4096, 32), the pas-mixed-1024 path's (1024, 8) and
   (1024, 14) and, for the launch-plus-latency floor of one matrix, (1, 8)
   and (1, 14): bitwise equality (required), and device
   times per call (``torch.profiler``) beside the bound: of the kernel with
   the L2 cache flushed before each call, so that its inputs come from
   device memory as the bound assumes, and with them warm in L2; of the
   plain version and ``torch.linalg.inv`` (a yardstick the port never
   calls), warm; and the kernel's call interval by CUDA events;
4. main: the warm-up fleet (64 ``random_lcqp(nV=8, nC=2, nComp=2)``
   instances tiled to B = 4096, bench.py's headline configuration) through
   ``solve_batch_mixed(..., max_iterations=200, n_corrector_iters=6,
   escalate=1)``: wall seconds, certified lanes, histogram of ``ret``, mean
   iterations, the kernel's launches during the solve (in all and by matrix
   order), and an f64 host audit of the certified lanes.  Lanes, launches
   and iteration totals must equal ``MAIN_EXPECTED``;
5. reference: the warm-up LCQP's known solution, and the first 64 lanes of
   the fleet solved again on the CPU (plain versions) against the card;
6. pas-mixed-1024: the warm-up fleet at B = 1024 through
   ``solve_batch_mixed`` with the PAS inner engine (``inner_solver="pas"``,
   ``n_corrector_iters=6``, ``escalate=0``);
7. pas-warmup-256: the same fleet at B = 256 through the f64 homotopy
   ``solve`` with the PAS engine;
8. circle-N100: ``circle_fleet(CIRCLE_B)`` (OptimizeOnCircle N = 100,
   nV = 202, m = 503: the compressed Schur form and the sweep inverse)
   through ``solve_batch_mixed(chunk=32, escalate=3)`` from the lifted
   start, stationarity tolerance 1e-2.

Each of phases 6-8 prints its wall seconds, certified lanes, stages, mean
iterations, the kernel's launches by matrix order, the resolved KKT form
and the f64 audit (``lcqpow_tpu_torch.audit_solution``), and raises when
the certified lanes fall below the JAX package's count (``PATHS``), when
the audit fails (on the circle: when a certified lane lies outside its
certificate's own bounds in f64, or the audit's max |phi| or max violation
exceeds ``CIRCLE_AUDIT_CEILING``, see ``run_path``), or when a pinned count
differs.

Then one JSON line describing each kernel, and last the line
``{"ok": true, "device": {...}}``.  Any failed check raises, and the script
exits non-zero without printing that line; so it does when no CUDA device
is available or the package is not beside it.
"""

import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

# Peak rates of one H100 SXM (NVIDIA data sheet): HBM3 bytes/s and FP32
# (non-tensor-core) operations/s.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

B_MAIN = 4096
# The shapes the driven paths give the kernel (the main path's 4096 lanes,
# pas-mixed-1024's 1024, at m = 8 and 14), a ragged batch, the largest
# orders, and one matrix.
KERNEL_SHAPES = [(4096, 8), (4096, 14), (4095, 14), (512, 48), (4096, 32),
                 (1, 8), (1, 14), (1024, 8), (1024, 14)]
# Kernel and plain version do the same IEEE float32 operations in the same
# order (the kernel is built with --fmad=false), so the kernel is held to
# bit-for-bit equality with the plain version: tolerance 0.
# The main path's outcome, the same in every run since the port began (the
# kernel is bit for bit its plain version, the rest deterministic): any
# change is a fault.  Sums over the lanes: means 9.3499 and 2.2363.
MAIN_EXPECTED = dict(certified=B_MAIN, launches_by_m={8: 6, 14: 132},
                     iter_total_sum=38297, corrector_steps_sum=9160)
# Paths beside the main one, from bench.py's rows.  ``floor``: the lanes
# the JAX package certified on its TPU run (BENCH_DETAIL.json), which the
# port must reach.  ``pinned``: the outcome of every card run so far
# (certified lanes, lanes by certification stage or, for the plain f64
# solve, by return code, the iteration sum, the kernel's launches by
# order, and for the circle the lanes outside the strict audit), held
# exactly, as MAIN_EXPECTED is.
CIRCLE_B = 128
# The circle's ceiling on the f64 audit's max |phi| and max violation, in
# place of the strict 2.2e-13 and 1e-9 that some of its certified lanes
# miss (see ``run_path``): the certificate's feasibility bound
# 1e-9 (1 + max|Ax|) at this fleet's max|Ax| = 2, above the JAX package's
# reading on its TPU run (BENCH_DETAIL.json circle ``max_phi_sample``
# 2.461e-9).
CIRCLE_AUDIT_CEILING = 3e-9
PATHS = {
    "pas-mixed-1024": dict(floor=1023, pinned=dict(
        certified=1023, stages={0: 1, 2: 1023}, iter_total_sum=9594,
        launches_by_m={8: 3, 14: 89})),
    "pas-warmup-256": dict(floor=256, pinned=dict(
        certified=256, rets={0: 256}, iter_total_sum=2986,
        launches_by_m={})),
    "circle-N100": dict(
        floor=124, audit_ceiling=CIRCLE_AUDIT_CEILING, pinned=dict(
            certified=124, stages={0: 4, 2: 103, 3: 12, 4: 5, 5: 4},
            iter_total_sum=3454, launches_by_m={}, strict_audit_fails=16)),
}
# Written before each timed kernel call to push its inputs out of L2
# (50 MB on an H100): 256 MiB of float32.
FLUSH_FLOATS = 64 * 2 ** 20
PTXAS_ORDERS = (8, 14, 32, 48)


def phase(name, t0, msg):
    print(f"[{name}] {msg} seconds={time.perf_counter() - t0:.3f}", flush=True)


def cuda_ms(fn, reps):
    """Mean milliseconds per call over ``reps`` back-to-back calls, by CUDA
    events: for a call of a few microseconds this is the host's launch
    interval, not the device's time."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps, kernel=None, flush=None, tries=3):
    """Mean device milliseconds per call, summed by ``torch.profiler`` over
    ``reps`` calls: the time of every kernel the call launches or, given
    ``kernel``, of the kernels whose name holds it.  Given ``flush``,
    ``flush()`` runs before every call and ``kernel`` keeps its time out.
    A trace with no such device time (the profiler dropped its events, seen
    once in several hundred traces) is taken again, up to ``tries`` times."""
    from torch.profiler import ProfilerActivity, profile

    assert flush is None or kernel is not None
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if flush is not None:
                    flush()
                fn()
            torch.cuda.synchronize()
        us = 0.0
        for e in prof.key_averages():
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and (kernel is None or kernel in e.key)):
                us += getattr(e, "self_device_time_total",
                              getattr(e, "self_cuda_time_total", 0.0))
        if us > 0.0:
            return us / reps / 1e3
    raise AssertionError(f"the profiler recorded no device time in {tries} "
                         "traces")


def bound_ms(B, m):
    """Least device time of one (B, m, m) inverse: each input byte read
    and each output byte written once, or 2 m^3 operations a matrix,
    whichever takes longer; and which of the two it is."""
    bytes_ms = 2 * B * m * m * 4 / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * m ** 3 * B / FP32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def ptxas_usage(log, orders):
    """(kernel, m, vector width) -> (registers, spill stores, spill loads)
    from nvcc's ``-Xptxas -v`` output, for the GJ kernels of order in
    ``orders``."""
    usage, key = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            name = re.search(r"(gj_[a-z]+_kernel)ILi(\d+)E(?:Li(\d+)E)?",
                             entry.group(1))
            key = None
            if name and int(name.group(2)) in orders:
                key = (name.group(1), int(name.group(2)),
                       int(name.group(3) or 0))
                usage[key] = [None, None, None]
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        regs = re.search(r"Used (\d+) registers", line)
        if key is not None and spill:
            usage[key][1:] = [int(spill.group(1)), int(spill.group(2))]
        if key is not None and regs:
            usage[key][0] = int(regs.group(1))
    return usage


def same_bits(K, P):
    """Equal values and equal bit patterns (-0 is not +0)."""
    return bool(torch.equal(K, P)) and bool(
        torch.equal(K.view(torch.int32), P.view(torch.int32)))


def spd_batch(B, m, seed):
    """Jacobi-scaled SPD batch, as the solver hands the kernel (chol.py)."""
    from lcqpow_tpu_torch.ops.chol import _jacobi_scale

    g = torch.Generator(device="cuda").manual_seed(seed)
    A = torch.randn((B, m, m), generator=g, device="cuda")
    S = A @ A.mT / m + 0.1 * torch.eye(m, device="cuda")
    return _jacobi_scale(S)[0].contiguous()


def path_outcome(sol):
    """The counts a path pins: certified lanes, lanes per certification
    stage (return codes for a plain solve), the iteration sum and the
    kernel's launches by matrix order."""
    from lcqpow_tpu_torch.ops import gj_inverse as gj

    ret = sol.ret.cpu()
    st = sol.stats.certified_stage
    by = ("rets", ret) if st is None else ("stages", st.cpu())
    return {"certified": int((ret == 0).sum()),
            by[0]: {int(k): int(v) for k, v in zip(*torch.unique(
                by[1], return_counts=True))},
            "iter_total_sum": int(sol.stats.iter_total.sum()),
            "launches_by_m": dict(sorted(gj.launch_counts.items()))}


def strict_audit_failures(lt, data, sol, opts):
    """The certified lanes that fail the strict f64 audit (|phi| above the
    complementarity tolerance or a violation above 1e-9), each as (lane,
    signed phi, violation, max|Ax| over [A; L; R; box])."""
    bad = []
    for i in torch.nonzero(sol.ret == 0).flatten().tolist():
        d = data.map(lambda a: a[i])
        one = sol.map(lambda t: t[i])
        a = lt.audit_solution(d, one, opts)
        if not (a["phi_ok"] and a["max_violation"] <= 1e-9):
            x = one.x.double()
            phi = float(((d.L @ x - d.lbL) * (d.R @ x - d.lbR)).sum())
            ax = float(torch.cat([d.A_full @ x, x]).abs().max())
            bad.append((i, phi, a["max_violation"], ax))
    return bad


def run_path(name, solve, data, opts, floor, pinned, audit_ceiling=None):
    """Drive one path with the kernel's counts set to 0 just before and
    read just after; print and check its outcome (see ``PATHS``).  With no
    ``audit_ceiling`` the f64 audit is the strict one."""
    import lcqpow_tpu_torch as lt
    from lcqpow_tpu_torch.mixed import _resolve_kkt_form
    from lcqpow_tpu_torch.ops import gj_inverse as gj

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    gj.launch_count = 0
    gj.launch_counts.clear()
    t1 = time.perf_counter()
    sol = solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    got = path_outcome(sol)
    aud = lt.audit_solution(data, sol, opts)
    print(f"[{name}] B={sol.ret.shape[0]} wall_s={wall:.3f} outcome={got} "
          f"mean_iter_total={float(sol.stats.iter_total.float().mean()):.4f} "
          f"mean_subproblem_iter="
          f"{float(sol.stats.subproblem_iter.float().mean()):.4f} "
          f"gj_launches={gj.launch_count} "
          f"kkt_form={_resolve_kkt_form(data, opts).admm.kkt_form} "
          f"audit={aud}", flush=True)
    if not bool(torch.isfinite(sol.x[sol.ret == 0]).all()):
        raise AssertionError(f"{name}: non-finite certified x")
    if got["certified"] < floor:
        raise AssertionError(f"{name}: {got['certified']} certified, the "
                             f"JAX package certified {floor}")
    if audit_ceiling is None:
        if not (aud["phi_ok"] and aud["max_violation"] <= 1e-9):
            raise AssertionError(f"{name}: f64 audit failed: {aud}")
    else:
        # The certificate (mixed.correct_and_certify, as in the JAX
        # package) tests phi one-sidedly (phi < tolerance) and feasibility
        # relative to max|Ax| (1e-9 (1 + max|Ax|)): a lane a hair outside a
        # complementarity bound certifies with a negative phi, which the
        # strict audit, on |phi|, rejects.  Each such lane must still meet
        # the certificate's bounds in f64.
        bad = strict_audit_failures(lt, data, sol, opts)
        got["strict_audit_fails"] = len(bad)
        print(f"[{name}] strict-audit failures (lane, phi, violation, "
              f"max|Ax|): {bad}", flush=True)
        tol = opts.complementarity_tolerance
        outside = [b for b in bad if not (b[1] <= tol
                                          and b[2] <= 1e-9 * (1.0 + b[3]))]
        if outside:
            raise AssertionError(f"{name}: lanes outside their certificate: "
                                 f"{outside}")
        if not (aud["max_phi"] <= audit_ceiling
                and aud["max_violation"] <= audit_ceiling):
            raise AssertionError(f"{name}: f64 audit above its ceiling "
                                 f"{audit_ceiling:.1e}: {aud}")
    if got != pinned:
        raise AssertionError(f"{name}: {got}, pinned {pinned}")
    phase(name, t0, f"certified={got['certified']}")


def main():
    t_all = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import lcqpow_tpu_torch as lt
    from lcqpow_tpu_torch import _build
    from lcqpow_tpu_torch.ops import gj_inverse as gj
    from lcqpow_tpu_torch.problems import circle_fleet, warm_up, warmup_fleet

    # 1. device
    t0 = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    smi_line = smi.strip().splitlines()[0]
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    phase("device", t0, f"name={kind!r} count={count}")
    print(smi_line, flush=True)

    # 2. build
    t0 = time.perf_counter()
    paths = _build.build_all()
    usage = ptxas_usage(paths["gj"].with_suffix(".log").read_text(),
                        PTXAS_ORDERS)
    if not usage:
        raise AssertionError("no ptxas report of the GJ kernels")
    for (name, m, vec), (regs, st, ld) in sorted(usage.items()):
        print(f"[ptxas] {name}<{m}{f',{vec}' if vec else ''}> "
              f"registers={regs} spill_stores={st} spill_loads={ld}")
    phase("build", t0, f"nvcc_seconds={_build.last_build_seconds:.3f} "
          f"libs={sorted(p.name for p in paths.values())}")

    # 3. kernel vs plain
    t0 = time.perf_counter()
    rows = {}
    max_err = 0.0
    l2 = torch.empty(FLUSH_FLOATS, device="cuda")
    for B, m in KERNEL_SHAPES:
        S = spd_batch(B, m, seed=m)
        K = gj.gj_inverse(S)
        P = gj.gj_inverse_plain(S)
        torch.cuda.synchronize()
        err = float((K - P).abs().max())
        bitwise = same_bits(K, P)
        eye = torch.eye(m, device="cuda")
        resid = float((K @ S - eye).abs().max())
        if not bitwise:
            raise AssertionError(f"kernel and plain version differ at B={B} "
                                 f"m={m}: max|diff|={err:.3e}")
        if not resid < 1e-3:
            raise AssertionError(f"kernel inverse residual {resid:.3e} "
                                 f"at B={B} m={m}")
        max_err = max(max_err, err)
        call_ms = cuda_ms(lambda: gj.gj_inverse(S), 200)
        ms = device_ms(lambda: gj.gj_inverse(S), 50, kernel="gj_",
                       flush=l2.zero_)
        warm_ms = device_ms(lambda: gj.gj_inverse(S), 50, kernel="gj_")
        plain_ms = device_ms(lambda: gj.gj_inverse_plain(S), 5)
        lib_ms = device_ms(lambda: torch.linalg.inv(S), 20)
        bound, bound_by = bound_ms(B, m)
        rows[(B, m)] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                            bound_ms=bound, bound_by=bound_by)
        print(f"[kernel] B={B} m={m} max_abs_diff={err:.3e} "
              f"bitwise={bitwise} inv_resid={resid:.3e} device_ms: "
              f"kernel={ms:.5f} (L2 flushed) kernel_l2_warm={warm_ms:.5f} "
              f"plain={plain_ms:.5f} linalg_inv={lib_ms:.5f} "
              f"bound={bound:.6g} ({bound_by}) share_of_bound="
              f"{bound / ms:.3f}; kernel_call_ms="
              f"{call_ms:.5f} (events, back-to-back calls)", flush=True)
    phase("kernel", t0, f"shapes={len(KERNEL_SHAPES)} max_abs_diff={max_err:.3e}")

    # 4. main path
    t0 = time.perf_counter()
    opts = lt.Options(print_level=lt.PrintLevel.NONE, max_iterations=200)
    data = warmup_fleet(B_MAIN)
    # One small solve first, so CUDA and cuBLAS set-up stays out of the
    # main run's time.
    lt.solve_batch_mixed(warmup_fleet(64), opts, n_corrector_iters=6)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    gj.launch_count = 0
    gj.launch_counts.clear()
    t1 = time.perf_counter()
    sol = lt.solve_batch_mixed(data, opts, n_corrector_iters=6, escalate=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = gj.launch_count
    launches_by_m = dict(sorted(gj.launch_counts.items()))
    ret = sol.ret.cpu().numpy()
    certified = int((ret == 0).sum())
    got = dict(certified=certified, launches_by_m=launches_by_m,
               iter_total_sum=int(sol.stats.iter_total.sum()),
               corrector_steps_sum=int(sol.stats.corrector_steps.sum()))
    hist = {int(k): int(v) for k, v in zip(*np.unique(ret, return_counts=True))}
    if tuple(sol.x.shape) != (B_MAIN, 8) or not bool(
            torch.isfinite(sol.x[sol.ret == 0]).all()):
        raise AssertionError("main path: bad x shape or non-finite x")
    aud = lt.audit_solution(data, sol, opts)
    max_phi, max_viol = aud["max_phi"], aud["max_violation"]
    print(f"[main] B={B_MAIN} wall_s={wall:.3f} setup_s={t_setup:.3f} "
          f"certified={certified}/{B_MAIN} ret_hist={hist} "
          f"mean_iter_total={float(sol.stats.iter_total.float().mean()):.4f} "
          f"mean_iter_outer={float(sol.stats.iter_outer.float().mean()):.4f} "
          f"mean_corrector_steps="
          f"{float(sol.stats.corrector_steps.float().mean()):.4f} "
          f"stages={torch.bincount(sol.stats.certified_stage).tolist()} "
          f"iter_total_sum={got['iter_total_sum']} corrector_steps_sum="
          f"{got['corrector_steps_sum']} "
          f"gj_launches={launches} gj_launches_by_m={launches_by_m} "
          f"audit_max_phi={max_phi:.3e} "
          f"audit_max_violation={max_viol:.3e}", flush=True)
    if got != MAIN_EXPECTED:
        raise AssertionError(f"main path: {got}, expected {MAIN_EXPECTED}")
    if not (max_phi <= opts.complementarity_tolerance and max_viol <= 1e-9):
        raise AssertionError(f"f64 audit failed: phi={max_phi:.3e} "
                             f"violation={max_viol:.3e}")
    phase("main", t0, f"certified={certified}")

    # 5. reference checks
    t0 = time.perf_counter()
    wu = lt.solve_batch_mixed(lt.stack_lcqps([warm_up()]), opts)
    x = wu.x[0].cpu().numpy()
    if not (int(wu.ret[0]) == 0
            and int(wu.algo_status[0]) == lt.AlgorithmStatus.S_STATIONARY_SOLUTION
            and min(np.abs(x - [1, 0]).max(), np.abs(x - [0, 1]).max()) < 1e-10):
        raise AssertionError(f"warm-up LCQP: x={x} ret={int(wu.ret[0])}")
    sub = data.map(lambda a: a[:64].cpu())
    cpu = lt.solve_batch_mixed(sub, opts, n_corrector_iters=6, escalate=1)
    both = (cpu.ret == 0) & (sol.ret[:64].cpu() == 0)
    dx = float((cpu.x - sol.x[:64].cpu()).abs()[both].max())
    same_ret = int((cpu.ret == sol.ret[:64].cpu()).sum())
    print(f"[reference] warm_up x={x.round(12).tolist()} S-stationary; "
          f"cpu-vs-card lanes=64 same_ret={same_ret} both_certified="
          f"{int(both.sum())} max_abs_dx={dx:.3e}", flush=True)
    if not (same_ret == 64 and dx <= 1e-9):
        raise AssertionError("card and CPU runs of the port disagree")
    phase("reference", t0, "ok")

    # 6.-8. the PAS paths and the circle path
    pas_opts = opts.replace(inner_solver="pas")
    fleet = warmup_fleet(1024)
    run_path("pas-mixed-1024",
             lambda: lt.solve_batch_mixed(fleet, pas_opts,
                                          n_corrector_iters=6, escalate=0),
             fleet, pas_opts, **PATHS["pas-mixed-1024"])
    fleet = warmup_fleet(256)
    run_path("pas-warmup-256", lambda: lt.solve(fleet, pas_opts), fleet,
             pas_opts, **PATHS["pas-warmup-256"])
    circle_opts = opts.replace(stationarity_tolerance=1e-2,
                               qp_solver=lt.QPSolver.OSQP_SPARSE)
    fleet, x0 = circle_fleet(CIRCLE_B)
    run_path("circle-N100",
             lambda: lt.solve_batch_mixed(fleet, circle_opts, x0=x0,
                                          chunk=32, escalate=3),
             fleet, circle_opts, **PATHS["circle-N100"])

    main_row = rows[(4096, 14)]
    print(json.dumps({"kernels": [{
        "name": "gj_inverse",
        "route": "cuda",
        "source": "lcqpow_tpu_torch/csrc/gj_inverse.cu",
        "replaces": "lcqpow_tpu/ops/pallas_inverse.py:40",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shape": [4096, 14, 14],
    }]}))
    print(f"[total] seconds={time.perf_counter() - t_all:.3f}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
