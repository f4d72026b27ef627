"""Run one cell of the benchmark of ``lcqpow_tpu_torch`` on the CUDA card
and print its result as one JSON line on standard output.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``.  ``--trace 0``
reports the cell's end-to-end metrics, ``--trace 1`` its per-layer
metrics from a profiled window.  Progress and each number the check
compares, beside its limit, go to standard error.  Exits non-zero, and
prints no result, when there is no CUDA card or fewer than the cell asks
for, when the program cannot be imported, or when the JAX package or JAX
was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# One process, few host threads; every cache of a build inside the checkout
# at a fixed path.
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness

    print(f"run: torch and the harness imported at "
          f"{time.perf_counter() - T0:.3f} s", file=sys.stderr)

    spec_path = ROOT / "BENCHMARK.json"
    try:
        cell = next(w for w in json.loads(spec_path.read_text())["workloads"]
                    if w["name"] == args.workload)
    except (OSError, ValueError, StopIteration) as exc:
        print(f"run: no workload {args.workload!r} in {spec_path}: {exc!r}",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("run: no CUDA card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"run: {args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    print(f"run: the card found at {time.perf_counter() - T0:.3f} s",
          file=sys.stderr)
    try:
        result = harness.run(spec_path, args.workload, args.seed,
                                     args.seconds, bool(args.trace),
                                     "cuda:0", T0)
    except ImportError as exc:
        print(f"run: the program cannot be imported: {exc!r}",
              file=sys.stderr)
        return 3
    bad = harness.forbidden_modules()
    if bad:
        print(f"run: forbidden modules loaded: {bad}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
