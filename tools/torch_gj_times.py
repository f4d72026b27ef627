#!/usr/bin/env python3
"""Time the Gauss-Jordan kernel of this tree against the parent commit's,
in turns, in one process, on one card.

Run from the root of a checkout, with one NVIDIA card visible::

    python3 tools/torch_gj_times.py                     # parent: HEAD~
    python3 tools/torch_gj_times.py --parent OLD.cu --shapes 512,42 1,42

``--parent`` is a git revision (default ``HEAD~``), whose
``lcqpow_tpu_torch/csrc/gj_inverse.cu`` is read with ``git show``, or the
path of such a source (a copy without ``.git`` needs the path).  Each
``--variant`` adds another source to the turns.  Every source is built
with the package's nvcc flags (``_build.NVCC_FLAGS``) into
``build/lcqpow_tpu_torch/gj-times/<hash>/`` (git-ignored) and loaded with
ctypes; the tree's own kernel comes from ``_build`` as the package loads
it.  At each (B, m) of ``--shapes`` every kernel is first held bit for bit
against ``gj_inverse_plain``; then the kernels take turns (parent, tree,
tree, parent, each variant after) over ``--reps`` calls each, timed by CUDA
events around each call:

* flushed: a 256 MiB write before each call pushes the inputs out of L2;
* warm: a 20 us spin kernel (``torch.cuda._sleep``) before each call keeps
  the host ahead of the card, with the inputs left in L2.

Prints ptxas's registers and spills of each source's kernels at orders 33,
40, 42 and 48, one JSON line per shape ("B,m" -> source -> flushed and warm
ms of each turn, and each kernel's flushed and warm ms by
``chip_smoke.device_ms``, the profiler's kernel time without the launch
gap that the events include; the bound of ``chip_smoke.bound_ms``; and by
``chip_smoke.device_ms``, warm, the plain version's and
``torch.linalg.inv``'s device ms), and last the card's name and power limit
as ``nvidia-smi`` prints them.  Exits non-zero without a card or when a
kernel differs from the plain version.
"""

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from lcqpow_tpu_torch import _build  # noqa: E402
from lcqpow_tpu_torch.ops import gj_inverse as gj  # noqa: E402

SOURCE = "lcqpow_tpu_torch/csrc/gj_inverse.cu"
DEFAULT_SHAPES = ["512,42", "512,48", "4096,48", "128,42", "1,42"]
PTXAS_ORDERS = (33, 40, 42, 48)
SPIN_CYCLES = 35_000  # about 20 us at the H100's 1.755 GHz boost clock


def parent_source(spec):
    """The text of ``spec``: a file, or the kernel source at a revision."""
    if os.path.isfile(spec):
        return Path(spec).read_text()
    return subprocess.run(["git", "show", f"{spec}:{SOURCE}"], cwd=ROOT,
                          capture_output=True, text=True, check=True).stdout


def build(sources):
    """Compile each name -> source text with the package's flags, all nvcc
    processes at once; return name -> (the C entry point, nvcc's log)."""
    procs = {}
    for name, text in sources.items():
        digest = hashlib.sha256((" ".join(_build.NVCC_FLAGS) + text).encode())
        out = _build.BUILD_ROOT / "gj-times" / digest.hexdigest()[:16]
        lib = out / f"libgj_{name}.so"
        proc = None
        if not lib.exists():
            out.mkdir(parents=True, exist_ok=True)
            src = out / f"gj_{name}.cu"
            src.write_text(text)
            proc = subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                 str(src)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
        procs[name] = (lib, proc)
    built = {}
    for name, (lib, proc) in procs.items():
        if proc is not None:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc for {name} failed:\n{log}")
            lib.with_suffix(".log").write_text(log)
        fn = ctypes.CDLL(str(lib)).gj_inverse_f32
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        built[name] = (fn, lib.with_suffix(".log").read_text())
    return built


def caller(fn, S, out):
    stream = torch.cuda.current_stream().cuda_stream
    args = (S.data_ptr(), out.data_ptr(), S.shape[0], S.shape[-1], stream)

    def call():
        err = fn(*args)
        if err != 0:
            raise RuntimeError(f"launch failed, cudaError {err}")
    return call


def event_ms(call, before, reps):
    """Mean device ms of ``call`` by a pair of CUDA events around each of
    ``reps`` calls, each after ``before()``."""
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    call()
    torch.cuda.synchronize()
    for start, end in pairs:
        before()
        start.record()
        call()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / reps


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default="HEAD~")
    ap.add_argument("--variant", action="append", default=[],
                    help="another kernel source, NAME=PATH")
    ap.add_argument("--shapes", nargs="*", default=DEFAULT_SHAPES,
                    help="B,m pairs")
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_gj_times: needs a CUDA card", file=sys.stderr)
        return 1

    sources = {"parent": parent_source(args.parent)}
    for spec in args.variant:
        name, path = spec.split("=", 1)
        sources[name] = Path(path).read_text()
    tree = threading.Thread(target=_build.build_all)  # nvcc at once too
    tree.start()
    built = build(sources)
    tree.join()
    kernels = {name: fn for name, (fn, _) in built.items()}
    logs = {name: log for name, (_, log) in built.items()}
    kernels["tree"] = gj._kernel()
    logs["tree"] = _build.build_all()["gj"].with_suffix(".log").read_text()
    for name, log in logs.items():
        for (kern, m, vec), (regs, st, ld) in sorted(
                cs.ptxas_usage(log, PTXAS_ORDERS).items()):
            print(f"[ptxas] {name} {kern}<{m}{f',{vec}' if vec else ''}> "
                  f"registers={regs} spill_stores={st} spill_loads={ld}")

    order = ["parent", "tree", "tree", "parent"] + [
        n for n in kernels if n not in ("parent", "tree")]
    l2 = torch.empty(cs.FLUSH_FLOATS, device="cuda")
    spin = lambda: torch.cuda._sleep(SPIN_CYCLES)  # noqa: E731
    for shape in args.shapes:
        B, m = (int(v) for v in shape.split(","))
        S = cs.spd_batch(B, m, seed=m)
        P = gj.gj_inverse_plain(S)
        out = torch.empty_like(S)
        calls = {n: caller(fn, S, out) for n, fn in kernels.items()}
        for name, call in calls.items():
            out.fill_(float("nan"))
            call()
            torch.cuda.synchronize()
            if not cs.same_bits(out, P):
                raise AssertionError(f"{name} differs from the plain "
                                     f"version at B={B} m={m}")
        row = {n: {"flushed_ms": [], "warm_ms": []} for n in kernels}
        for name in order:
            row[name]["flushed_ms"].append(
                event_ms(calls[name], l2.zero_, args.reps))
            row[name]["warm_ms"].append(
                event_ms(calls[name], spin, args.reps))
        # The same by torch.profiler (kernel time alone, no launch gap).
        for name, call in calls.items():
            row[name]["profiler_flushed_ms"] = cs.device_ms(
                call, args.reps, kernel="gj_", flush=l2.zero_)
            row[name]["profiler_warm_ms"] = cs.device_ms(call, args.reps,
                                                         kernel="gj_")
        bound, bound_by = cs.bound_ms(B, m)
        print(json.dumps({
            f"{B},{m}": row, "bitwise": True, "bound_ms": bound,
            "bound_by": bound_by,
            "plain_ms": cs.device_ms(lambda: gj.gj_inverse_plain(S), 5),
            "library_ms": cs.device_ms(lambda: torch.linalg.inv(S), 20)}),
            flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
