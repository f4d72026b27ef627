#!/usr/bin/env python3
"""Drive lcqpow_tpu_torch's main path on one CUDA card and check it.

Run from the root of a checkout, with one NVIDIA card visible::

    python3 chip_smoke.py

Phases, each printing one line with its seconds:

1. device: the card's name and count, then the raw
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` line;
2. build: ``nvcc`` of every kernel source under ``lcqpow_tpu_torch/csrc``
   (one process a library, all at once), and ptxas's registers and spills
   of the GJ kernels at the orders of ``PTXAS_ORDERS`` (a spill of the
   wide kernel, m = 33-48, fails the run) and of the perturbation kernel
   in float and double;
3. kernel: the Gauss-Jordan kernel against its plain PyTorch version on
   Jacobi-scaled SPD batches at (B, m) in (4096, 8), (4096, 14), (4095, 14),
   (512, 48), (4096, 32), the pas-mixed-1024 path's (1024, 8) and
   (1024, 14), the circle-N20-512 path's (512, 42) and, for the
   launch-plus-latency floor of one matrix and the one-call mixed path of
   phase 9, (1, 2), (1, 4), (1, 8), (1, 14) and (1, 42):
   bitwise equality (required), and device
   times per call (``torch.profiler``) beside the bound: of the kernel with
   the L2 cache flushed before each call, so that its inputs come from
   device memory as the bound assumes, and with them warm in L2; of the
   plain version and ``torch.linalg.inv`` (a yardstick the port never
   calls), warm; and the kernel's call interval by CUDA events.  Then the
   pass's step perturbation (``prng.perturb_apply``: the Threefry draw,
   its add to the iterate and the keys' carry in one launch) against its
   plain PyTorch version at (B, n) in ``THREEFRY_SHAPES``, in float32 and
   float64, with about a third of the lanes not going and -0, subnormals
   and +-1 in the iterate: bitwise equality of the keys and iterates
   (required), the same device times (no library call computes it), and
   the host microseconds per call (``perf_counter`` over 200 calls, then
   one ``synchronize``) of the checked call and of the solver's per-solve
   launcher (``prng.perturbation``);
   Then the batched matvec (``ops.linalg.mv``/``mtv``, the kernel of
   ``csrc/matvec.cu``) at each (m, n, direction) of ``MATVEC_SHAPES``, the
   cells' shapes, at B = ``MATVEC_B``: bitwise equality with
   ``torch.matmul`` on random and pair-probe inputs (required), the
   kernel's device time flushed and warm beside its bound (A, the vector
   and the output moved once at 3.35 TB/s), the plain version's
   (``mv_plain``/``mtv_plain``, the ``torch.matmul`` the wrapper runs
   elsewhere) and a direct ``torch.matmul`` call's, and the host
   microseconds of a call at B = 4096, kernel and plain;
4. main: the warm-up fleet (64 ``random_lcqp(nV=8, nC=2, nComp=2)``
   instances tiled to B = 4096, bench.py's headline configuration) through
   ``solve_batch_mixed(..., max_iterations=200, n_corrector_iters=6,
   escalate=1)``: wall seconds, certified lanes, histogram of ``ret``, mean
   iterations, the GJ kernel's launches during the solve (in all and by
   matrix order) and the perturbation kernel's, and an f64 host audit of the
   certified lanes.  The fleet's root key is bench.py's, ``PRNGKey(1)``
   (``BENCH_KEY``), as on every path below.  Lanes, launches and iteration
   totals must equal ``MAIN_EXPECTED``;
5. reference: the warm-up LCQP's known solution, and the first 64 lanes of
   the fleet solved again on the CPU (plain versions) against the card;
6. pas-mixed-1024: the warm-up fleet at B = 1024 through
   ``solve_batch_mixed`` with the PAS inner engine (``inner_solver="pas"``,
   ``n_corrector_iters=6``, ``escalate=0``);
7. pas-warmup-256: the same fleet at B = 256 through the f64 homotopy
   (``solve_batch``) with the PAS engine;
8. circle-N100: ``circle_fleet(CIRCLE_B)`` (OptimizeOnCircle N = 100,
   nV = 202, m = 503: the compressed Schur form and the sweep inverse)
   through ``solve_batch_mixed(chunk=32, escalate=3)`` from the lifted
   start, stationarity tolerance 1e-2; then circle-N20-512: the same fleet
   construction at N = 20 (``circle_fleet(CIRCLE20_B, N=CIRCLE20_N)``,
   nV = 42, Schur m = 103), B = 512, no chunk, ``escalate=3``, the same
   options: the predictor's f32 inverses are the GJ kernel's order 42
   (the wide design of m = 33-48).

9. api: the reference-compatible surface on the card, one line per step
   with its wall seconds and the kernel's launches by order (counts set to
   0 before each step): OptimizeOnCircle N = 100 through ``LCQProblem``
   from scipy.sparse CSC matrices (``OSQP_SPARSE``, stationarity
   tolerance 1e-2, lifted start, f64) held to the reference's oracle
   (``circle_oracle``); ``lcqpow(..., mixed=True)`` on the warm-up and the
   first 8 ``random_lcqp(nV=8, nC=2, nComp=2)`` of ``default_rng(0)``,
   each certified and equal to the port's CPU run to 1e-9 in x (the
   perturbation on: the card draws the CPU's bits), with more than zero
   launches of each kernel at B = 1; the warm-up
   through the reference text format and ``load_lcqp_from_files``; the
   INNER table ``run_solver`` prints (``check_printed_table``);
   ``solve_batch_sharded`` over ``make_mesh()`` bit for bit
   ``solve_batch`` on ``warmup_fleet(1024)``, and ``fleet_summary`` of the
   main path's solution; ``solve_batch_sharded`` over the card named twice
   (``TWO_STREAMS``: two worker threads, each on a stream of its own), on
   ``warmup_fleet(1024)`` in f64 with its walls against ``solve_batch`` of
   the two slices one after the other, in turns, and on
   ``circle_fleet(CIRCLE_SHARD_B)`` (``CIRCLE_SHARD_ITERS`` iterations),
   whose threads capture and replay the sweep's CUDA graphs at n = 202 at
   the same moment, each slice bit for bit ``solve`` of its lanes with
   their keys of the fleet's split;
   the seven example scripts of ``EXAMPLE_SCRIPTS`` from
   ``examples_torch/``;
10. driven shapes: every (B, m) the GJ kernel was launched at in phases
   4-9 (``gj_inverse.launch_shapes``) and not held in phase 3, held
   bitwise against its plain version; every (B, n) the perturbation
   kernel was launched at there (``prng.launch_shapes``: retries, slices,
   one-instance calls) and not held in phase 3, held bitwise against the
   plain version in both types as there; every (B, m, n, direction) the
   matvec kernel was launched at there (``linalg.matvec_launch_shapes``)
   and not held in phase 3c, held bitwise against ``torch.matmul`` as
   there.

Each path of phases 6-8 prints its wall seconds, certified lanes, stages, mean
iterations, the GJ kernel's launches by matrix order, the perturbation
kernel's and the matvec kernel's launches, the resolved KKT form
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

import contextlib
import io
import json
import os
import re
import runpy
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# Peak rates of one H100 SXM (NVIDIA data sheet): HBM3 bytes/s and FP32
# and FP64 (non-tensor-core) operations/s; and INT32 operations/s (NVIDIA
# H100 white paper, SXM5, non-tensor, an IMAD counted as two).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
FP64_OPS_PER_S = 34e12
INT32_OPS_PER_S = 33.5e12
# Integer operations of one Threefry-2x32 hash (csrc/threefry.cu): 20
# rounds of add, rotate (one funnel shift) and xor, 5 key injections of
# three adds, 2 adds and 2 xors to start.
OPS_PER_HASH = 79

B_MAIN = 4096
# The shapes the driven paths give the kernel (the main path's 4096 lanes,
# pas-mixed-1024's 1024, at m = 8 and 14; circle-N20-512's 512 at m = 42),
# a ragged batch, the largest orders, and one matrix.
KERNEL_SHAPES = [(4096, 8), (4096, 14), (4095, 14), (512, 48), (4096, 32),
                 (1, 8), (1, 14), (1024, 8), (1024, 14), (1, 2), (1, 4),
                 (512, 42), (1, 42)]
# Widths of the driven fleets beside the main one, and the problems' n.
PAS_MIXED_B = 1024
PAS_F64_B = 256
CIRCLE_CHUNK = 32
WARMUP_NV = 8
CIRCLE_NV = 202
# The circle fleet at N = 20 (nV = 42, nC = 21, nComp = 20, Schur m =
# 103), full width: its predictor inverts 42 x 42 f32 matrices by the GJ
# kernel's wide design.
CIRCLE20_N = 20
CIRCLE20_B = 512
CIRCLE20_NV = 42
# The step perturbation at the (B, n) the driven paths give it: the main
# path's, pas-mixed-1024's and pas-warmup-256's fleets (n = 8); the
# circle's chunks and its retries at the retry chunk of 8 lanes and at the
# 5 lanes of its last round (n = 202); one lane (the main path's retry,
# the api phase's LCQProblem circle, the one-call path's warm-up and
# random_lcqp(8, 2, 2)); and a ragged batch.  Every other shape a driven
# path launches it at is held after the paths have run (phase 10).
THREEFRY_SHAPES = [(4096, 8), (1024, 8), (256, 8), (4095, 8), (32, 202),
                   (8, 202), (5, 202), (1, 202), (1, 2), (1, 8)]
# bench.py's root key, jax.random.PRNGKey(1), for every driven path.
BENCH_KEY = 1
# The one-call mixed path (phase 9) launches the kernel on one matrix: at
# orders 2 and 4 on the warm-up, 8 and 14 on random_lcqp(8, 2, 2).
API_SHAPES = [(1, 2), (1, 4), (1, 8), (1, 14)]
# Kernel and plain version do the same IEEE float32 operations in the same
# order (the kernel is built with --fmad=false), so the kernel is held to
# bit-for-bit equality with the plain version: tolerance 0.
# The main path's outcome on bench.py's key, the same in every card run
# since the port draws the JAX package's bits (both kernels are bit for bit
# their plain versions, the rest deterministic): any change is a fault.
# Sums over the lanes: means 9.3611 and 2.2349 (the JAX package's TPU run:
# 9.3567 and 2.2339, the same stages).
MAIN_EXPECTED = dict(certified=B_MAIN, launches_by_m={8: 6, 14: 131},
                     iter_total_sum=38343, corrector_steps_sum=9154,
                     stages={2: B_MAIN - 1, 3: 1}, threefry_launches=55)
# Paths beside the main one, from bench.py's rows.  ``floor``: the lanes
# the JAX package certified on its TPU run (BENCH_DETAIL.json), which the
# port must reach (circle-N20-512: the port's CPU run).  ``pinned``: the
# outcome of every card run since the port draws the JAX package's bits
# (certified lanes, lanes by certification stage or, for the plain f64
# solve, by return code, the iteration sum, the GJ kernel's launches by
# order, the Threefry kernel's launches, and for the circles the lanes
# outside the strict audit), held
# exactly, as MAIN_EXPECTED is.
CIRCLE_B = 128
# The circle fleet that two threads solve at once on the card (phase 9),
# cut to a few homotopy iterations (every one of them inverts by the
# graphed sweep), so the step stays near 20 s.
CIRCLE_SHARD_B = 8
CIRCLE_SHARD_ITERS = 6
TWO_STREAMS = ["cuda:0", "cuda:0"]
# The circle's ceiling on the f64 audit's max |phi| and max violation, in
# place of the strict 2.2e-13 and 1e-9 that some of its certified lanes
# miss (see ``run_path``): the certificate's feasibility bound
# 1e-9 (1 + max|Ax|) at this fleet's max|Ax| = 2, above the JAX package's
# reading on its TPU run (BENCH_DETAIL.json circle ``max_phi_sample``
# 2.461e-9).
CIRCLE_AUDIT_CEILING = 3e-9
PATHS = {
    "pas-mixed-1024": dict(floor=1023, pinned=dict(
        certified=1023, stages={0: 1, 2: 1023}, iter_total_sum=9565,
        launches_by_m={8: 3, 14: 90}, threefry_launches=43)),
    "pas-warmup-256": dict(floor=256, pinned=dict(
        certified=256, rets={0: 256}, iter_total_sum=2986,
        launches_by_m={}, threefry_launches=49)),
    "circle-N100": dict(
        floor=124, audit_ceiling=CIRCLE_AUDIT_CEILING, pinned=dict(
            certified=124, stages={0: 4, 2: 101, 3: 16, 4: 6, 5: 1},
            iter_total_sum=3470, launches_by_m={}, threefry_launches=533,
            strict_audit_fails=15)),
    # No TPU run of this fleet: the floor is the port's own CPU run
    # (tools/torch_circle_fleet.py --device cpu: 512 certified).
    "circle-N20-512": dict(
        floor=512, audit_ceiling=CIRCLE_AUDIT_CEILING, pinned=dict(
            certified=512, stages={2: 512}, iter_total_sum=8914,
            launches_by_m={42: 555}, threefry_launches=29,
            strict_audit_fails=2)),
}
# The example scripts tests/test_examples.py runs, each with a line it
# must print.
EXAMPLE_SCRIPTS = {
    "warm_up": "status: S_STATIONARY_SOLUTION",
    "warm_up_binary": "second solve: SUCCESSFUL_RETURN",
    "warm_up_w_A": "xOpt =",
    "warm_up_osqp": "yOpt =",
    "warm_up_sparse": "S-Stationary solution found",
    "test_max_penalty": "expected failure reproduced",
    "optimize_on_circle_store_steps": "solved in",
}
# Written before each timed kernel call to push its inputs out of L2
# (50 MB on an H100): 256 MiB of float32.
FLUSH_FLOATS = 64 * 2 ** 20
PTXAS_ORDERS = (8, 14, 32, 33, 40, 42, 48)
# The batched matvec at the benchmark cells' shapes and width: (m, n,
# transposed), mv of A (B, m, n) or mtv.
MATVEC_SHAPES = [(2, 8, False), (8, 8, False), (14, 8, False),
                 (14, 8, True), (14, 14, False)]
MATVEC_B = 262144


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


def device_ms(fn, reps, kernel=None, flush=None, tries=8):
    """Mean device milliseconds per call, summed by ``torch.profiler`` over
    ``reps`` calls: the time of every kernel the call launches or, given
    ``kernel``, of the kernels whose name holds it.  Given ``flush``,
    ``flush()`` runs before every call and ``kernel`` keeps its time out.
    A trace with no such device time, or given ``kernel`` with another
    count of its launches than ``reps`` (the profiler dropped events: seen
    once in several hundred traces on some machines, in most runs of the
    smoke on others, and a partial loss reads low), is taken again, up to
    ``tries`` times; the error names what each trace held."""
    from torch.profiler import ProfilerActivity, profile

    assert flush is None or kernel is not None
    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if flush is not None:
                    flush()
                fn()
            torch.cuda.synchronize()
        us, launches = 0.0, 0
        for e in prof.key_averages():
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and (kernel is None or kernel in e.key)):
                us += getattr(e, "self_device_time_total",
                              getattr(e, "self_cuda_time_total", 0.0))
                launches += e.count
        if us > 0.0 and (kernel is None or launches == reps):
            return us / reps / 1e3
        seen.append((launches, round(us, 3)))
    raise AssertionError(f"the profiler recorded no full trace in {tries} "
                         f"traces of {reps} calls (launches, us): {seen}")


def bound_ms(B, m):
    """Least device time of one (B, m, m) inverse: each input byte read
    and each output byte written once, or 2 m^3 operations a matrix,
    whichever takes longer; and which of the two it is."""
    bytes_ms = 2 * B * m * m * 4 / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * m ** 3 * B / FP32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def threefry_bound_ms(B, n, n_active, dtype):
    """Least device time of one ``perturb_apply`` of B lanes, n elements
    of ``dtype``: keys in and out (16 bytes a lane each way), the mask (1
    byte a lane), xk in and x out (an element each way) moved once; or
    (4 + 2n) hashes of ``OPS_PER_HASH`` integer operations and n adds of
    ``dtype`` for each going lane at their peak rates, whichever takes
    longer; and which of the two it is."""
    size = torch.finfo(dtype).bits // 8
    bytes_ms = (B * 33 + 2 * B * n * size) / HBM_BYTES_PER_S * 1e3
    flops = FP64_OPS_PER_S if dtype == torch.float64 else FP32_OPS_PER_S
    ops_ms = (n_active * (4 + 2 * n) * OPS_PER_HASH / INT32_OPS_PER_S
              + n_active * n / flops) * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def threefry_ptxas(log):
    """Type ("f" float, "d" double) -> (registers, spill stores, spill
    loads) of the perturbation kernel from nvcc's ``-Xptxas -v`` output."""
    def key_of(mangled):
        name = re.search(r"perturb_apply_kernelI([fd])E", mangled)
        return name.group(1) if name else None
    usage = ptxas_entries(log, key_of)
    if sorted(usage) != ["d", "f"] or None in sum(usage.values(), []):
        raise AssertionError(f"no full ptxas report of the perturbation "
                             f"kernel: {usage}")
    return usage


def lane_mask(B, seed, device="cuda"):
    """About two thirds of B lanes active, lane 0 always."""
    g = torch.Generator(device=device).manual_seed(seed)
    active = torch.rand(B, generator=g, device=device) < 0.66
    active[0] = True
    return active


def iterate(B, n, dtype, seed, device="cuda"):
    """(B, n) values of ``dtype`` with -0, +0, subnormals of both signs
    and +-1 at every third element among normal draws."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((B, n), generator=g, device=device, dtype=dtype)
    tiny = torch.finfo(dtype).smallest_normal / 2 ** 3
    special = torch.tensor([-0.0, 0.0, tiny, -tiny, 1.0, -1.0], dtype=dtype,
                           device=device)
    flat = x.view(-1)
    flat[::3] = special.repeat(-(-flat[::3].numel() // 6))[
        :flat[::3].numel()]
    return x


THREEFRY_DTYPES = (torch.float32, torch.float64)


def hold_threefry(prng, B, n, dtype, device="cuda"):
    """The perturbation kernel (``prng.perturb_apply``) against its plain
    version at (B, n) in ``dtype``, on keys of a fleet's split, about a
    third of the lanes not going and the special values of
    :func:`iterate`: raises unless keys and iterates are equal bit for bit.
    Returns (keys, go, xk, max |difference|)."""
    keys = prng.split(prng.prng_key(B + n, device), B)
    go = lane_mask(B, seed=B + n, device=device)
    xk = iterate(B, n, dtype, seed=B + n, device=device)
    eps = torch.finfo(dtype).eps
    K, X = prng.perturb_apply(keys, go, xk, eps)
    KP, XP = prng.perturb_apply_plain(keys, go, xk, eps)
    err = float((K - KP).abs().max())
    if X.numel():
        err = max(err, float((X - XP).abs().max()))
    ints = torch.int64 if dtype == torch.float64 else torch.int32
    if not (torch.equal(K, KP) and torch.equal(X.view(ints), XP.view(ints))):
        raise AssertionError(f"perturbation kernel and plain version differ "
                             f"at B={B} n={n} {dtype}: max|diff|={err}")
    return keys, go, xk, err


def host_us(fn, calls=200):
    """Host microseconds per call over ``calls`` back-to-back calls, one
    ``synchronize`` after the last: the launch path's cost on the host for
    a call whose device time is shorter."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e6 / calls


def ptxas_entries(log, key_of):
    """key -> [registers, spill stores, spill loads] from nvcc's
    ``-Xptxas -v`` output, for each entry function whose mangled name
    ``key_of`` maps to a key (None: not reported)."""
    usage, key = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            key = key_of(entry.group(1))
            if key is not None:
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


def ptxas_usage(log, orders):
    """(kernel, m, vector width) -> (registers, spill stores, spill loads)
    from nvcc's ``-Xptxas -v`` output, for the GJ kernels of order in
    ``orders``."""
    def key_of(mangled):
        name = re.search(r"(gj_[a-z]+_kernel)ILi(\d+)E(?:Li(\d+)E)?", mangled)
        if name and int(name.group(2)) in orders:
            return (name.group(1), int(name.group(2)),
                    int(name.group(3) or 0))
        return None
    return ptxas_entries(log, key_of)


def check_wide_ptxas(usage, orders):
    """Raise unless :func:`ptxas_usage`'s ``usage`` reports the wide GJ
    kernel at every order of ``orders`` above 32, none of them spilling
    (a spill to local memory is a fault of that design)."""
    wide = {k: v for k, v in usage.items() if k[0] == "gj_wide_kernel"}
    if sorted(k[1] for k in wide) != sorted(m for m in orders if m > 32):
        raise AssertionError(f"no full ptxas report of the wide GJ kernel: "
                             f"{wide}")
    if any(st or ld for _, st, ld in wide.values()):
        raise AssertionError(f"the wide GJ kernel spills: {wide}")


def matvec_ptxas(log):
    """(kernel, m, n, transposed) -> (registers, spill stores, spill loads)
    of the matvec kernels from nvcc's ``-Xptxas -v`` output: the
    one-thread-a-lane kernel at (2, 8), the tiled kernel at every other
    shape of ``MATVEC_SHAPES``."""
    def key_of(mangled):
        name = re.search(r"(matvec_(?:lane_)?kernel)ILi(\d+)ELi(\d+)E"
                         r"(?:Lb([01])E)?", mangled)
        return (name.group(1), int(name.group(2)), int(name.group(3)),
                name.group(4) == "1") if name else None
    usage = ptxas_entries(log, key_of)
    want = [("matvec_lane_kernel" if s == (2, 8, False) else "matvec_kernel",
             *s) for s in MATVEC_SHAPES]
    if sorted(usage) != sorted(want) or None in sum(usage.values(), []):
        raise AssertionError(f"no full ptxas report of the matvec kernels: "
                             f"{usage}")
    return usage


def matvec_bound_ms(B, m, n, trans):
    """Least device time of one batched matvec: A, the vector and the
    output each moved once at the HBM rate."""
    k, r = (m, n) if trans else (n, m)
    return B * (m * n + k + r) * 4 / HBM_BYTES_PER_S * 1e3


def hold_matvec(linalg, B, m, n, trans, seed):
    """Raise unless ``mv``/``mtv`` gives ``torch.matmul``'s bits on random
    operands (spread exponents, +-0) and on pair probes (+-2^30 among ones,
    which show the sums' grouping); returns the random operands and the
    largest absolute difference from ``torch.matmul`` (0 when the bits
    agree)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    k = m if trans else n

    def draw(shape):
        e = torch.randint(-10, 11, shape, generator=g, device="cuda")
        x = (torch.rand(shape, generator=g, device="cuda") + 1) * torch.exp2(
            e.float())
        x = torch.where(torch.rand(shape, generator=g, device="cuda") < 0.5,
                        -x, x)
        zero = torch.rand(shape, generator=g, device="cuda") < 1 / 16
        return torch.where(zero, x * 0.0, x)
    fn, plain = ((linalg.mtv, linalg.mtv_plain) if trans
                 else (linalg.mv, linalg.mv_plain))
    A, v = draw((B, m, n)), draw((B, k))
    cases = [(A, v)]
    for i, j in [(0, 1), (0, k - 1), (1, k // 2), (3, 7)]:
        P = torch.ones(B, m, n, device="cuda")
        if trans:
            P[:, i, :], P[:, j, :] = 2.0 ** 30, -(2.0 ** 30)
        else:
            P[:, :, i], P[:, :, j] = 2.0 ** 30, -(2.0 ** 30)
        cases.append((P, torch.ones(B, k, device="cuda")))
    err = 0.0
    for a, x in cases:
        before = linalg.matvec_launch_count
        got, want = fn(a, x), plain(a, x)
        torch.cuda.synchronize()
        if linalg.matvec_launch_count != before + 1 or not same_bits(
                got, want):
            raise AssertionError(f"matvec (B={B}, m={m}, n={n}, "
                                 f"trans={trans}): not torch.matmul's bits")
        err = max(err, float((got - want).abs().max()))
    return A, v, err


def same_bits(K, P):
    """Equal values and equal bit patterns (-0 is not +0)."""
    return bool(torch.equal(K, P)) and bool(
        torch.equal(K.view(torch.int32), P.view(torch.int32)))


def hold_gj(gj, B, m):
    """The GJ kernel against its plain version on :func:`spd_batch` (B, m):
    raises unless they are equal bit for bit and the inverse's residual is
    under 1e-3.  Returns (S, max |difference|, residual)."""
    S = spd_batch(B, m, seed=m)
    K = gj.gj_inverse(S)
    P = gj.gj_inverse_plain(S)
    torch.cuda.synchronize()
    err = float((K - P).abs().max())
    if not same_bits(K, P):
        raise AssertionError(f"kernel and plain version differ at B={B} "
                             f"m={m}: max|diff|={err:.3e}")
    resid = float((K @ S - torch.eye(m, device="cuda")).abs().max())
    if not resid < 1e-3:
        raise AssertionError(f"kernel inverse residual {resid:.3e} "
                             f"at B={B} m={m}")
    return S, err, resid


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
    kernel's launches by matrix order, and the Threefry kernel's."""
    from lcqpow_tpu_torch import prng
    from lcqpow_tpu_torch.ops import gj_inverse as gj

    ret = sol.ret.cpu()
    st = sol.stats.certified_stage
    by = ("rets", ret) if st is None else ("stages", st.cpu())
    return {"certified": int((ret == 0).sum()),
            by[0]: {int(k): int(v) for k, v in zip(*torch.unique(
                by[1], return_counts=True))},
            "iter_total_sum": int(sol.stats.iter_total.sum()),
            "launches_by_m": dict(sorted(gj.launch_counts.items())),
            "threefry_launches": prng.launch_count}


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
    """Drive one path with the kernels' counts set to 0 just before and
    read just after; print and check its outcome (see ``PATHS``) and
    return it, with the matvec kernel's launches (``matvec_launches``,
    not pinned).  With no ``audit_ceiling`` the f64 audit is the strict
    one."""
    import lcqpow_tpu_torch as lt
    from lcqpow_tpu_torch import prng
    from lcqpow_tpu_torch.mixed import _resolve_kkt_form
    from lcqpow_tpu_torch.ops import gj_inverse as gj
    from lcqpow_tpu_torch.ops import linalg

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    gj.launch_count = 0
    gj.launch_counts.clear()
    prng.launch_count = 0
    linalg.matvec_launch_count = 0
    t1 = time.perf_counter()
    sol = solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    mv_launches = linalg.matvec_launch_count
    got = path_outcome(sol)
    aud = lt.audit_solution(data, sol, opts)
    print(f"[{name}] B={sol.ret.shape[0]} wall_s={wall:.3f} outcome={got} "
          f"mean_iter_total={float(sol.stats.iter_total.float().mean()):.4f} "
          f"mean_subproblem_iter="
          f"{float(sol.stats.subproblem_iter.float().mean()):.4f} "
          f"gj_launches={gj.launch_count} "
          f"threefry_launches={prng.launch_count} "
          f"matvec_launches={mv_launches} "
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
    return dict(got, matvec_launches=mv_launches)


def circle_oracle(x):
    """The JAX package's OptimizeOnCircle check (``tests/test_examples.py``,
    from ``OptimizeOnCircle.cpp:144-145``): x[:2] within 5e-3 of the global
    solution (0.1811, -0.9835) or the local one (0.9764, -0.2183), and on
    the unit circle to 2e-3."""
    x = np.asarray(x)[:2]
    d = min(np.linalg.norm(x - [0.1811, -0.9835]),
            np.linalg.norm(x - [0.9764, -0.2183]))
    return bool(d < 5e-3 and abs(np.linalg.norm(x) - 1.0) < 2e-3)


def check_printed_table(text, passes):
    """Raise unless ``text`` holds the INNER table of a solve of ``passes``
    passes (its header and one row per pass) and the S-stationary banner;
    return the number of rows."""
    rows = [line for line in text.splitlines()
            if re.fullmatch(r" *\d+ \| +\d+ \|( +\S+ \|){5} +\d+", line)]
    if " outer | inner |  station   |  complem   |" not in text:
        raise AssertionError("iteration table: no header")
    if len(rows) != passes:
        raise AssertionError(f"iteration table: {len(rows)} rows, "
                             f"{passes} passes")
    if "## S-Stationary solution found ##" not in text:
        raise AssertionError("iteration table: no S-stationary banner")
    return len(rows)


def launches_by_m(gj):
    """The GJ kernel's launches by order since its counts were set to 0,
    and the Threefry kernel's (key "threefry"), and set them to 0 again."""
    from lcqpow_tpu_torch import prng

    got = dict(sorted(gj.launch_counts.items()))
    got["threefry"] = prng.launch_count
    gj.launch_count = 0
    gj.launch_counts.clear()
    prng.launch_count = 0
    return got


def two_stream_shard(lt, fleet, opts, x0=None, order="sc"):
    """``solve_batch_sharded`` of ``fleet`` over ``TWO_STREAMS`` ("c")
    and ``solve_batch`` of its two slices one after the other ("s"), in
    the order ``order`` gives; raises unless every concurrent run is bit
    for bit the serial one, slice by slice.  The serial slices take their
    keys of the fleet's split, as the sharded call gives them.  Returns the
    walls by kind."""
    from lcqpow_tpu_torch.parallel import (make_mesh, shard_batch,
                                           solve_batch_sharded)
    from lcqpow_tpu_torch.prng import fleet_keys

    mesh = make_mesh(TWO_STREAMS)
    keys = fleet_keys(None, opts.seed, fleet.Q.shape[0], "cuda")
    walls = {"s": [], "c": []}
    runs = {}
    for kind in order:
        torch.cuda.synchronize()
        t = time.perf_counter()
        if kind == "c":
            sol = solve_batch_sharded(fleet, opts, mesh=mesh, x0=x0)
        else:
            parts = [lt.solve(d, opts, x0=x, key=k) for d, x, k in
                     zip(shard_batch(fleet, mesh), shard_batch(x0, mesh),
                         shard_batch(keys, mesh))]
            sol = parts[0].map(lambda *xs: torch.cat(xs), *parts[1:])
        torch.cuda.synchronize()
        walls[kind].append(time.perf_counter() - t)
        runs.setdefault(kind, []).append(sol)
    want = runs["s"][0]
    for got in runs["c"] + runs["s"][1:]:
        for name in ("x", "y", "ret", "algo_status"):
            if not same_bits(getattr(got, name), getattr(want, name)):
                raise AssertionError(f"two-stream shard differs in {name}")
        if not torch.equal(got.stats.iter_total, want.stats.iter_total):
            raise AssertionError("two-stream shard differs in iter_total")
    return walls, want


def run_api(lt, main_sol, opts, main_stages):
    """Phase 9 (see the module docstring); raises on any failed check."""
    import scipy.sparse as sp

    from lcqpow_tpu_torch.api import lcqpow
    from lcqpow_tpu_torch.ops import gj_inverse as gj
    from lcqpow_tpu_torch.parallel import (fleet_summary, make_mesh,
                                           solve_batch_sharded)
    from lcqpow_tpu_torch.problems import (circle_fleet, optimize_on_circle,
                                           random_lcqp, warmup_fleet)

    t_phase = time.perf_counter()
    wu = dict(Q=[[2.0, 0.0], [0.0, 2.0]], g=[-2.0, -2.0], L=[[1.0, 0.0]],
              R=[[0.0, 1.0]])
    S_POINTS = np.array([[1.0, 0.0], [0.0, 1.0]])

    def start():
        """Set the kernel's counts to 0 and start a step's clock."""
        torch.cuda.synchronize()
        launches_by_m(gj)
        return time.perf_counter()

    def step(name, t0, msg):
        torch.cuda.synchronize()
        print(f"[api] {name} {msg} launches_by_m={launches_by_m(gj)} "
              f"wall_s={time.perf_counter() - t0:.3f}", flush=True)

    # 1. OptimizeOnCircle N = 100 through LCQProblem, from CSC matrices.
    t0 = start()
    data, x0 = optimize_on_circle(100, as_numpy=True)
    csc = lambda a: sp.csc_matrix(np.asarray(a))
    lcqp = lt.LCQProblem(data.nV, data.nC, data.nComp)
    lcqp.set_options(lt.Options(print_level=lt.PrintLevel.NONE,
                                qp_solver=lt.QPSolver.OSQP_SPARSE,
                                stationarity_tolerance=1e-2))
    ret = lcqp.load_lcqp(csc(data.Q), data.g, csc(data.L), csc(data.R),
                         A=csc(data.A), lbA=data.lbA, ubA=data.ubA, x0=x0)
    ret = lcqp.run_solver() if ret == 0 else ret
    x = lcqp.get_primal_solution()
    st = lcqp.get_output_statistics()
    if ret != 0 or x.shape != (202,) or not circle_oracle(x):
        raise AssertionError(f"circle N=100 via LCQProblem: ret={ret!r} "
                             f"x[:2]={None if x is None else x[:2]}")
    step("circle-N100-lcqproblem", t0,
         f"ret={lt.ReturnValue(ret).name} x01={x[:2].round(6).tolist()} "
         f"iter_total={st.get_iter_total()} "
         f"subproblem_iter={st.get_subproblem_iter()} "
         f"solve_s={lcqp.elapsed_time:.3f}")

    # 2. The one-call mixed path, against the port's CPU run.
    t0 = start()
    rng = np.random.default_rng(0)
    problems = [wu] + [
        {k: np.asarray(getattr(d, k))
         for k in ("Q", "g", "L", "R", "A", "lbA", "ubA")}
        for d in (random_lcqp(rng, nV=8, nC=2, nComp=2, as_numpy=True)
                  for _ in range(8))]
    params = {"printLevel": 0}
    launches = {}
    worst = 0.0
    for i, prob in enumerate(problems):
        x, _, st = lcqpow(**prob, params=params, mixed=True)
        for m, c in launches_by_m(gj).items():
            launches[m] = launches.get(m, 0) + c
        xc, _, stc = lcqpow(**prob, params=params, mixed=True, device="cpu")
        worst = max(worst, float(np.abs(x - xc).max()))
        if not (st["exit_flag"] == stc["exit_flag"] == 0
                and np.abs(x - xc).max() <= 1e-9):
            raise AssertionError(f"lcqpow mixed, problem {i}: card {st}, "
                                 f"cpu {stc}, |dx|={np.abs(x - xc).max():.3e}")
    if not (launches.get("threefry") and set(launches) - {"threefry"}):
        raise AssertionError(f"lcqpow mixed: a kernel was not launched: "
                             f"{launches}")
    torch.cuda.synchronize()
    print(f"[api] lcqpow-mixed problems={len(problems)} certified="
          f"{len(problems)} max_abs_dx_vs_cpu={worst:.3e} launches_by_m="
          f"{launches} wall_s="
          f"{time.perf_counter() - t0:.3f}", flush=True)

    # 3. The reference text format.
    t0 = start()
    with tempfile.TemporaryDirectory() as d:
        for k, v in wu.items():
            lt.io.write_vector(os.path.join(d, f"{k}.txt"), np.ravel(v))
        lcqp = lt.LCQProblem()
        ret = lcqp.load_lcqp_from_files(d)
    lcqp.set_options(lt.Options(print_level=lt.PrintLevel.NONE))
    ret = lcqp.run_solver() if ret == 0 else ret
    x = lcqp.get_primal_solution()
    status = int(lcqp.get_solution().algo_status)
    if not (ret == 0 and np.abs(S_POINTS - x).max(1).min() < 1e-8
            and status == lt.AlgorithmStatus.S_STATIONARY_SOLUTION):
        raise AssertionError(f"file load: ret={ret!r} x={x} status={status}")
    step("file", t0, f"x={x.round(12).tolist()} "
         f"status={lt.AlgorithmStatus(status).name}")

    # 4. Iteration printing.
    t0 = start()
    lcqp = lt.LCQProblem(2, 0, 1)
    lcqp.set_options(lt.Options(print_level=lt.PrintLevel.INNER_LOOP_ITERATES))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ret = lcqp.load_lcqp(**wu)
        ret = lcqp.run_solver() if ret == 0 else ret
    if ret != 0:
        raise AssertionError(f"printing run: ret={ret!r}")
    rows = check_printed_table(buf.getvalue(),
                               lcqp.get_output_statistics().get_iter_total())
    step("printing", t0, f"rows={rows} chars={len(buf.getvalue())}")

    # 5. Sharding, and the main path's fleet summary.
    t0 = start()
    fleet = warmup_fleet(1024)
    mesh = make_mesh()
    a = solve_batch_sharded(fleet, opts, mesh=mesh)
    b = lt.solve_batch(fleet, opts)
    for name in ("x", "y", "ret", "algo_status"):
        if not same_bits(getattr(a, name), getattr(b, name)):
            raise AssertionError(f"solve_batch_sharded differs in {name}")
    if not torch.equal(a.stats.iter_total, b.stats.iter_total):
        raise AssertionError("solve_batch_sharded differs in iter_total")
    summary = fleet_summary(main_sol)
    if (summary["solved"], summary["certified_by_stage"]) \
            != (B_MAIN, main_stages):
        raise AssertionError(f"fleet_summary of the main path: {summary}")
    step("sharding", t0, f"mesh={[str(d) for d in mesh]} bitwise=True "
         f"solved={int((a.ret == 0).sum())}/1024 main_summary={summary}")

    # 5a. Two threads on two streams of the card, the warm-up fleet in f64:
    # serial and concurrent in turns.
    t0 = start()
    walls, sol = two_stream_shard(lt, fleet, opts, order="sccs")
    fmt = lambda ws: "/".join(f"{w:.3f}" for w in ws)
    step("sharding-two-streams-warmup", t0,
         f"mesh={TWO_STREAMS} B=1024 bitwise_by_slice=True solved="
         f"{int((sol.ret == 0).sum())}/1024 serial_s={fmt(walls['s'])} "
         f"concurrent_s={fmt(walls['c'])}")

    # 5b. The same on a circle fleet: both threads capture and replay the
    # sweep's graphs at once (concurrent first, so the capture is theirs).
    t0 = start()
    circle, x0 = circle_fleet(CIRCLE_SHARD_B)
    circle_opts = opts.replace(stationarity_tolerance=1e-2,
                               qp_solver=lt.QPSolver.OSQP_SPARSE,
                               max_iterations=CIRCLE_SHARD_ITERS)
    walls, sol = two_stream_shard(lt, circle, circle_opts, x0=x0,
                                  order="cs")
    step("sharding-two-streams-circle", t0,
         f"mesh={TWO_STREAMS} B={CIRCLE_SHARD_B} bitwise_by_slice=True "
         f"ret={sol.ret.tolist()} iter_total={sol.stats.iter_total.tolist()} "
         f"serial_s={fmt(walls['s'])} concurrent_s={fmt(walls['c'])}")

    # 6. The example scripts, on the card.
    t0 = start()
    here = os.path.dirname(os.path.abspath(__file__))
    for name, want in EXAMPLE_SCRIPTS.items():
        path = os.path.join(here, "examples_torch", name + ".py")
        buf = io.StringIO()
        argv = sys.argv
        sys.argv = [path]
        try:
            with contextlib.redirect_stdout(buf):
                runpy.run_path(path, run_name="__main__")
        finally:
            sys.argv = argv
        if want not in buf.getvalue():
            raise AssertionError(f"example {name}: no {want!r} in its output")
    step("examples", t0, f"scripts={len(EXAMPLE_SCRIPTS)}")
    phase("api", t_phase, "ok")


def matvec_phase(linalg, l2):
    """Phase 3c: each shape of ``MATVEC_SHAPES`` at ``MATVEC_B`` held
    bitwise, then timed; one ``[matvec]`` line each.  Returns the rows."""
    rows = {}
    for m, n, trans in MATVEC_SHAPES:
        A, v, err = hold_matvec(linalg, MATVEC_B, m, n, trans, seed=m + n)
        if trans:
            fn = lambda: linalg.mtv(A, v)
            plain = lambda: linalg.mtv_plain(A, v)
            library = lambda: torch.matmul(v[:, None, :], A)
        else:
            fn = lambda: linalg.mv(A, v)
            plain = lambda: linalg.mv_plain(A, v)
            library = lambda: torch.matmul(A, v[:, :, None])
        ms = device_ms(fn, 50, kernel="matvec_", flush=l2.zero_)
        warm_ms = device_ms(fn, 50, kernel="matvec_")
        plain_ms = device_ms(plain, 20)
        lib_ms = device_ms(library, 20)
        bound = matvec_bound_ms(MATVEC_B, m, n, trans)
        A4, v4 = A[:4096], v[:4096]
        host = host_us(lambda: (linalg.mtv if trans else linalg.mv)(A4, v4))
        host_plain = host_us(lambda: (linalg.mtv_plain if trans
                                      else linalg.mv_plain)(A4, v4))
        rows[(m, n, trans)] = dict(ms=ms, warm_ms=warm_ms, plain_ms=plain_ms,
                                   library_ms=lib_ms, bound_ms=bound,
                                   host_us=host, max_abs_err=err)
        print(f"[matvec] {'mtv' if trans else 'mv'} B={MATVEC_B} m={m} n={n} "
              f"bitwise=True device_ms: kernel={ms:.5f} (L2 flushed) "
              f"kernel_l2_warm={warm_ms:.5f} plain={plain_ms:.5f} "
              f"torch_matmul={lib_ms:.5f} bound={bound:.6g} (bytes) "
              f"share_of_bound={bound / ms:.3f} "
              f"warm_share={bound / warm_ms:.3f} max_abs_err={err:.3e}; "
              f"host_us_per_call (B=4096): kernel={host:.2f} "
              f"plain={host_plain:.2f}", flush=True)
    return rows


def main():
    t_all = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import lcqpow_tpu_torch as lt
    from lcqpow_tpu_torch import _build, prng
    from lcqpow_tpu_torch.ops import gj_inverse as gj
    from lcqpow_tpu_torch.ops import linalg
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
    check_wide_ptxas(usage, PTXAS_ORDERS)
    for t, (regs, st, ld) in sorted(threefry_ptxas(
            paths["threefry"].with_suffix(".log").read_text()).items()):
        print(f"[ptxas] perturb_apply_kernel<{dict(f='float', d='double')[t]}>"
              f" registers={regs} spill_stores={st} spill_loads={ld}")
    for (name, m, n, trans), (regs, st, ld) in sorted(matvec_ptxas(
            paths["matvec"].with_suffix(".log").read_text()).items()):
        print(f"[ptxas] {name}<{m},{n},{'mtv' if trans else 'mv'}> "
              f"registers={regs} spill_stores={st} spill_loads={ld}")
    phase("build", t0, f"nvcc_seconds={_build.last_build_seconds:.3f} "
          f"libs={sorted(p.name for p in paths.values())}")

    # 3. kernel vs plain
    t0 = time.perf_counter()
    rows = {}
    max_err = 0.0
    l2 = torch.empty(FLUSH_FLOATS, device="cuda")
    for B, m in KERNEL_SHAPES:
        S, err, resid = hold_gj(gj, B, m)
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
              f"bitwise=True inv_resid={resid:.3e} device_ms: "
              f"kernel={ms:.5f} (L2 flushed) kernel_l2_warm={warm_ms:.5f} "
              f"plain={plain_ms:.5f} linalg_inv={lib_ms:.5f} "
              f"bound={bound:.6g} ({bound_by}) share_of_bound="
              f"{bound / ms:.3f}; kernel_call_ms="
              f"{call_ms:.5f} (events, back-to-back calls)", flush=True)
    phase("kernel", t0, f"shapes={len(KERNEL_SHAPES)} max_abs_diff={max_err:.3e}")

    # 3b. the step perturbation vs plain
    t0 = time.perf_counter()
    tf_rows = {}
    for (B, n), dtype in ((s, d) for s in THREEFRY_SHAPES
                          for d in THREEFRY_DTYPES):
        keys, go, xk, err = hold_threefry(prng, B, n, dtype)
        eps = torch.finfo(dtype).eps
        n_active = int(go.sum())
        step = prng.perturbation(keys, xk, eps)
        apply = lambda: prng.perturb_apply(keys, go, xk, eps)
        plain = lambda: prng.perturb_apply_plain(keys, go, xk, eps)
        call_ms = cuda_ms(apply, 200)
        checked_us = host_us(apply)
        step_us = host_us(lambda: step(keys, go, xk))
        ms = device_ms(apply, 50, kernel="perturb_apply", flush=l2.zero_)
        warm_ms = device_ms(apply, 50, kernel="perturb_apply")
        plain_ms = device_ms(plain, 5)
        plain_call_ms = cuda_ms(plain, 20)
        bound, bound_by = threefry_bound_ms(B, n, n_active, dtype)
        tf_rows[(B, n, dtype)] = dict(ms=ms, plain_ms=plain_ms,
                                      bound_ms=bound, bound_by=bound_by,
                                      max_abs_err=err, host_us=step_us)
        print(f"[threefry] B={B} n={n} dtype={str(dtype)[6:]} "
              f"going={n_active} bitwise=True device_ms: kernel={ms:.5f} "
              f"(L2 flushed) kernel_l2_warm={warm_ms:.5f} plain="
              f"{plain_ms:.5f} bound={bound:.6g} ({bound_by}) "
              f"share_of_bound={bound / ms:.3f}; host_us_per_call: "
              f"solver_step={step_us:.2f} checked={checked_us:.2f}; "
              f"kernel_call_ms={call_ms:.5f} plain_call_ms="
              f"{plain_call_ms:.5f} (events, back-to-back calls)", flush=True)
    phase("threefry", t0, f"shapes={len(THREEFRY_SHAPES)} "
          f"dtypes={len(THREEFRY_DTYPES)} bitwise=True")

    # 3c. the batched matvec vs torch.matmul
    t0 = time.perf_counter()
    mv_rows = matvec_phase(linalg, l2)
    phase("matvec", t0, f"shapes={len(MATVEC_SHAPES)} B={MATVEC_B} "
          f"bitwise=True")

    # 4. main path
    t0 = time.perf_counter()
    opts = lt.Options(print_level=lt.PrintLevel.NONE, max_iterations=200)
    data = warmup_fleet(B_MAIN)
    # One small solve first, so CUDA and cuBLAS set-up stays out of the
    # main run's time.
    lt.solve_batch_mixed(warmup_fleet(64), opts, n_corrector_iters=6)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    key = prng.prng_key(BENCH_KEY, "cuda")
    gj.launch_count = 0
    gj.launch_counts.clear()
    prng.launch_count = 0
    linalg.matvec_launch_count = 0
    # Every shape the driven paths (phases 4-9) launch the kernels at.
    prng.launch_shapes.clear()
    gj.launch_shapes.clear()
    linalg.matvec_launch_shapes.clear()
    t1 = time.perf_counter()
    sol = lt.solve_batch_mixed(data, opts, key=key, n_corrector_iters=6,
                               escalate=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = gj.launch_count
    launches_by_m = dict(sorted(gj.launch_counts.items()))
    tf_launches = prng.launch_count
    mv_launches = linalg.matvec_launch_count
    ret = sol.ret.cpu().numpy()
    certified = int((ret == 0).sum())
    stages = {int(k): int(v) for k, v in zip(*torch.unique(
        sol.stats.certified_stage.cpu(), return_counts=True))}
    got = dict(certified=certified, launches_by_m=launches_by_m,
               iter_total_sum=int(sol.stats.iter_total.sum()),
               corrector_steps_sum=int(sol.stats.corrector_steps.sum()),
               stages=stages, threefry_launches=tf_launches)
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
          f"threefry_launches={tf_launches} matvec_launches={mv_launches} "
          f"audit_max_phi={max_phi:.3e} "
          f"audit_max_violation={max_viol:.3e}", flush=True)
    if not (launches and tf_launches and mv_launches):
        raise AssertionError(f"main path: a kernel was not launched (GJ "
                             f"{launches}, Threefry {tf_launches}, matvec "
                             f"{mv_launches})")
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
    # The first 64 lanes' keys of the fleet's split are the split over 64.
    cpu = lt.solve_batch_mixed(sub, opts, key=prng.prng_key(BENCH_KEY),
                               n_corrector_iters=6, escalate=1)
    both = (cpu.ret == 0) & (sol.ret[:64].cpu() == 0)
    dx = float((cpu.x - sol.x[:64].cpu()).abs()[both].max())
    same_ret = int((cpu.ret == sol.ret[:64].cpu()).sum())
    print(f"[reference] warm_up x={x.round(12).tolist()} S-stationary; "
          f"cpu-vs-card lanes=64 same_ret={same_ret} both_certified="
          f"{int(both.sum())} max_abs_dx={dx:.3e}", flush=True)
    if not (same_ret == 64 and dx <= 1e-9):
        raise AssertionError("card and CPU runs of the port disagree")
    phase("reference", t0, "ok")

    # 6.-8. the PAS paths and the circle paths
    by_path = {"main": dict(got, matvec_launches=mv_launches)}
    pas_opts = opts.replace(inner_solver="pas")
    fleet = warmup_fleet(PAS_MIXED_B)
    by_path["pas-mixed-1024"] = run_path("pas-mixed-1024",
             lambda: lt.solve_batch_mixed(fleet, pas_opts, key=key,
                                          n_corrector_iters=6, escalate=0),
             fleet, pas_opts, **PATHS["pas-mixed-1024"])
    fleet = warmup_fleet(PAS_F64_B)
    by_path["pas-warmup-256"] = run_path("pas-warmup-256",
             lambda: lt.solve_batch(fleet, pas_opts, key=key), fleet,
             pas_opts, **PATHS["pas-warmup-256"])
    circle_opts = opts.replace(stationarity_tolerance=1e-2,
                               qp_solver=lt.QPSolver.OSQP_SPARSE)
    fleet, x0 = circle_fleet(CIRCLE_B)
    by_path["circle-N100"] = run_path("circle-N100",
             lambda: lt.solve_batch_mixed(fleet, circle_opts, x0=x0,
                                          key=key, chunk=CIRCLE_CHUNK,
                                          escalate=3),
             fleet, circle_opts, **PATHS["circle-N100"])
    fleet, x0 = circle_fleet(CIRCLE20_B, N=CIRCLE20_N)
    by_path["circle-N20-512"] = run_path(
        "circle-N20-512",
        lambda: lt.solve_batch_mixed(fleet, circle_opts, x0=x0, key=key,
                                     chunk=0, escalate=3),
        fleet, circle_opts, **PATHS["circle-N20-512"])

    # 9. the reference-compatible surface
    run_api(lt, sol, opts, MAIN_EXPECTED["stages"])

    # 10. the kernels at every other shape the paths launched them at
    t0 = time.perf_counter()
    driven = sorted(gj.launch_shapes)
    late = [s for s in driven if s not in KERNEL_SHAPES]
    for B, m in late:
        hold_gj(gj, B, m)
    phase("gj-driven", t0, f"driven_shapes={driven} held_now={late} "
          f"bitwise=True")
    t0 = time.perf_counter()
    driven = sorted(prng.launch_shapes)
    late = [s for s in driven if s not in THREEFRY_SHAPES]
    for B, n in late:
        for dtype in THREEFRY_DTYPES:
            hold_threefry(prng, B, n, dtype)
    phase("threefry-driven", t0, f"driven_shapes={driven} "
          f"held_now={late} bitwise=True")
    t0 = time.perf_counter()
    driven = sorted(linalg.matvec_launch_shapes)
    late = [s for s in driven
            if not (s[0] == MATVEC_B and s[1:] in MATVEC_SHAPES)]
    mv_err = max(r["max_abs_err"] for r in mv_rows.values())
    for B, m, n, trans in late:
        mv_err = max(mv_err, hold_matvec(linalg, B, m, n, trans,
                                         seed=B + m + n)[2])
    phase("matvec-driven", t0, f"driven_shapes={driven} held_now={late} "
          f"bitwise=True max_abs_err={mv_err:.3e}")

    main_row = rows[(4096, 14)]
    tf_row = tf_rows[(4096, 8, torch.float32)]
    # Each path's launches, its counts set to 0 just before it.
    gj_by_path = {k: sum(v["launches_by_m"].values())
                  for k, v in by_path.items()}
    tf_by_path = {k: v["threefry_launches"] for k, v in by_path.items()}
    mv_by_path = {k: v["matvec_launches"] for k, v in by_path.items()}
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
        "launches_by_path": gj_by_path,
        # The wide design (m = 33-48) at circle-N20-512's shape.
        "order_42": dict(rows[(CIRCLE20_B, CIRCLE20_NV)],
                         shape=[CIRCLE20_B, CIRCLE20_NV, CIRCLE20_NV]),
    }, {
        "name": "threefry_perturb_apply",
        "route": "cuda",
        "source": "lcqpow_tpu_torch/csrc/threefry.cu",
        # No pallas_call: the jax.random draw and its add to the iterate in
        # the JAX package's loop.
        "replaces": "lcqpow_tpu/solver.py:496",
        "launches": tf_launches,
        "max_abs_err": max(r["max_abs_err"] for r in tf_rows.values()),
        "ms": tf_row["ms"],
        "plain_ms": tf_row["plain_ms"],
        "bound_ms": tf_row["bound_ms"],
        "bound_by": tf_row["bound_by"],
        "library_ms": None,
        "host_us": tf_row["host_us"],
        "shape": [4096, 8],
        "dtype": "float32",
        "launches_by_path": tf_by_path,
    }, {
        "name": "matvec",
        "route": "cuda",
        "source": "lcqpow_tpu_torch/csrc/matvec.cu",
        # No pallas_call: the batched A @ x that XLA runs for the JAX
        # package (vmap), which the port sent to cuBLAS gemv.
        "replaces": None,
        "launches": mv_launches,
        "max_abs_err": mv_err,
        "ms": mv_rows[(14, 14, False)]["ms"],
        "plain_ms": mv_rows[(14, 14, False)]["plain_ms"],
        "bound_ms": mv_rows[(14, 14, False)]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": mv_rows[(14, 14, False)]["library_ms"],
        "shape": [MATVEC_B, 14, 14],
        "launches_by_path": mv_by_path,
        "by_shape": {f"{'mtv' if t else 'mv'}_{m}x{n}": r
                     for (m, n, t), r in mv_rows.items()},
    }]}))
    print(f"[total] seconds={time.perf_counter() - t_all:.3f}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
