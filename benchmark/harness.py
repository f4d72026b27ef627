"""One run of one cell: set-up, the measured window, the reference's
verdict, and the metrics, all found by name from ``BENCHMARK.json``.

A cell names a configuration (``configs/<name>.json`` through its
``file``: the problem family, found as ``families/<family>.py``, the
program's entry and options, the guarantees a certified lane carries and
the limits of the check), a traffic mix (``traffic/<name>.json``: lanes a
call, one caller, closed loop, and optionally ``judged_calls``) and its
metrics (``metrics/<name>.py``: one reader each).  Adding a cell, a
family, a mix or a metric adds files and entries and edits none.

The window calls the program's entry back to back, each call on a fresh
draw of the fleet (:class:`fleet.Fleet`) and ending in a device
synchronisation, until ``seconds`` have passed and at least the mix's
judged calls (:func:`judged_calls`) have been made, and lets the last call
finish.  With ``trace`` the window is at most
``TRACE_CALLS`` calls under the profiler, with a ``record_function`` range
around each call and around each entry into the program that a metric
names (``SPANS``), and the per-layer metrics are read from those calls.
Once the window has closed and the peak memory has been read, the
program's state is freed and :mod:`reference` judges every call's result.

Which calls each number covers: ``correct`` and every number under
``checks``, the end-to-end rate and the per-layer metrics cover every call
of the window; ``attempted`` and ``failed`` cover its first judged calls
(all of a traced window's), so that two trees run at one seed are counted
on the same inputs however many calls each fits into the window.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import importlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import devtrace, reference, roofline
from .fleet import BENCH_DIR, Fleet, SpecError, load_file

#: Calls of a traced window: enough for a median, few enough that the
#: trace of the slowest cell is read in well under a minute.
TRACE_CALLS = 3
#: Calls whose lanes ``attempted`` and ``failed`` count, where the traffic
#: mix sets no ``judged_calls``: a fixed prefix of every window, so that a
#: faster tree is counted on the same fleets as a slower one at the same
#: seed, not on extra fleets only it reached.  A 51-s window at 262,144
#: lanes holds 13-15 calls; an untraced window runs on until it has made
#: this many.
JUDGED_CALLS = 12
#: Top-level module names that no run may load.
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "lcqpow_tpu"})


@dataclasses.dataclass
class Cell:
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def _for_cell(metric: dict, name: str) -> bool:
    return "workloads" not in metric or name in metric["workloads"]


def load_cell(spec_path: Path, workload: str, bench_dir: Path = BENCH_DIR
              ) -> Cell:
    """The cell ``workload`` of the spec, with its configuration's file and
    its traffic mix read, and the metrics it reports."""
    spec = json.loads(Path(spec_path).read_text())
    root = Path(spec_path).parent
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SpecError(f"no workload {workload!r}; the spec has "
                        f"{sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic_file = bench_dir / "traffic" / f"{w['traffic']}.json"
    if not traffic_file.exists():
        raise SpecError(f"no traffic mix {traffic_file}")
    return Cell(config=config,
                traffic=json.loads(traffic_file.read_text()),
                end_to_end=[m for m in spec["end_to_end"]
                            if _for_cell(m, workload)],
                per_layer=[m for m in spec["per_layer"]
                           if _for_cell(m, workload)])


def load_reader(name: str, bench_dir: Path = BENCH_DIR):
    """The module ``metrics/<name>.py``: ``read(ctx)`` gives the metric or
    ``None``; optional ``COUNTERS`` (label -> dotted path of a count in the
    program) and ``SPANS`` (label -> (dotted path of a function of the
    program, ``"call"``, ``"range"`` or ``"factory"``))."""
    return load_file("metrics", name, bench_dir)


def judged_calls(traffic: dict) -> int:
    """The mix's ``judged_calls``, or :data:`JUDGED_CALLS` where it sets
    none."""
    n = traffic.get("judged_calls", JUDGED_CALLS)
    if isinstance(n, bool) or not isinstance(n, int) or n < 1:
        raise SpecError(f"judged_calls {n!r} is no whole number >= 1")
    return n


@dataclasses.dataclass
class Context:
    """What a reader reads.  Every run fills the window's fields; a traced
    run also ``trace``, ``solutions``, ``counters`` and ``spans``."""

    lanes: int                       # lanes a call
    calls: int                       # calls in the window
    certified: int                   # lanes the program certified (ret 0)
    window_s: float                  # first call's start to last call's end
    setup_s: float
    walls: list                      # host seconds of each call
    solutions: list = dataclasses.field(default_factory=list)
    counters: dict = dataclasses.field(default_factory=dict)
    spans: dict = dataclasses.field(default_factory=dict)
    trace: devtrace.Trace | None = None
    roofline = roofline


# ---- the program ------------------------------------------------------------
class Program:
    """The program's entry on one fleet: its problem data built once from
    the fleet's base instances (the program's own ``make_lcqp`` defaults),
    tiled over the lanes on the device; each call swaps in that call's
    ``g`` and passes the start ``x0`` where the fleet's draw gives one."""

    def __init__(self, solver: dict, fleet: Fleet):
        import lcqpow_tpu_torch as lt
        from lcqpow_tpu_torch.convert import lcqp_from_numpy

        self.lt = lt
        self.entry = solver["entry"]
        self.options = lt.Options(**solver["options"])
        self.kwargs = {k: v for k, v in solver.items()
                       if k not in ("entry", "options")}
        host = {k: v.cpu().numpy() for k, v in fleet.base.items()}
        base = [lt.make_lcqp(**{k: v[i] for k, v in host.items()},
                             as_numpy=True)
                for i in range(next(iter(host.values())).shape[0])]
        stacked = lcqp_from_numpy(
            {f.name: np.stack([np.asarray(getattr(b, f.name)) for b in base])
             for f in dataclasses.fields(lt.LCQPData)}, fleet.device)
        self.data = stacked.map(lambda a: a.index_select(0, fleet.instance))

    def __call__(self, g: torch.Tensor, x0: torch.Tensor | None = None):
        data = dataclasses.replace(self.data, g=g)
        return getattr(self.lt, self.entry)(data, self.options, x0=x0,
                                            **self.kwargs)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---- spans and counters of a traced run --------------------------------------
def _resolve(path: str):
    """(module, attribute) of a dotted path into the program, or ``None``
    when the program has no such name."""
    mod_name, attr = path.rsplit(".", 1)
    try:
        mod = importlib.import_module(mod_name)
    except ImportError:
        return None
    return (mod, attr) if hasattr(mod, attr) else None


def _describe(args) -> dict:
    """Shapes and types of an invocation's tensors, and for a bool tensor
    its count of True (a device scalar, read after the window)."""
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    return dict(shapes=[tuple(a.shape) for a in tensors],
                dtypes=[a.dtype for a in tensors],
                trues=[a.sum() if a.dtype == torch.bool else None
                       for a in tensors])


def _ranged(fn, name: str, records: list):
    def call(*args, **kwargs):
        with torch.profiler.record_function(name):
            out = fn(*args, **kwargs)
        records.append(_describe(args))
        return out
    return call


def _range_only(fn, name: str):
    def call(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return call


def install_spans(readers, spans: dict):
    """Wrap each program function a reader names in a range of its own;
    returns the undo.  ``"call"``: each call gets the range and a record
    of its arguments; ``"range"``: the range alone; ``"factory"``: the
    function returns a callable, and each call of that callable gets the
    range and the record."""
    undo = []
    for reader in readers:
        for label, (path, kind) in getattr(reader, "SPANS", {}).items():
            found = _resolve(path)
            if found is None or label in spans:
                continue
            mod, attr = found
            orig = getattr(mod, attr)
            records = spans.setdefault(label, [])
            name = devtrace.RANGE_PREFIX + label
            if kind == "call":
                wrapped = _ranged(orig, name, records)
            elif kind == "range":
                wrapped = _range_only(orig, name)
            else:
                def wrapped(*a, _orig=orig, _name=name, _rec=records, **k):
                    return _ranged(_orig(*a, **k), _name, _rec)
            setattr(mod, attr, wrapped)
            undo.append((mod, attr, orig))

    def restore():
        for mod, attr, orig in reversed(undo):
            setattr(mod, attr, orig)
    return restore


def _read_counters(paths: dict) -> dict:
    out = {}
    for label, path in paths.items():
        found = _resolve(path)
        out[label] = None if found is None else getattr(*found)
    return out


# ---- the run -----------------------------------------------------------------
def power_limit(device: torch.device):
    """The card's power limit in W as ``nvidia-smi`` reads it, or ``None``."""
    if device.type != "cuda":
        return None
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", str(device.index or 0),
             "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def run(spec_path: Path, workload: str, seed: int, seconds: float,
        trace: bool, device, t0: float, bench_dir: Path = BENCH_DIR,
        log=sys.stderr) -> dict:
    """One run; returns the result line's object, whose last key,
    ``checks``, holds each number compared beside its limit.  ``t0``: the
    process's start on the host clock, from which set-up is counted.

    ``correct``, ``checks`` and the metrics cover every call of the window;
    ``attempted`` and ``failed`` the lanes, and the lanes left uncertified,
    of its first :func:`judged_calls` calls.  Standard error gives both
    counts and a digest of the judged calls' ``ret``."""
    device = torch.device(device)
    cell = load_cell(spec_path, workload, bench_dir)
    metrics = cell.per_layer if trace else cell.end_to_end
    readers = {m["name"]: load_reader(m["name"], bench_dir) for m in metrics}
    cfg = cell.config
    lanes = int(cell.traffic["lanes_per_call"])
    judged_n = judged_calls(cell.traffic)

    t_in = time.perf_counter()
    fleet = Fleet(cfg["problem"], lanes, seed, device, bench_dir)
    program = Program(cfg["solver"], fleet)
    t_data = time.perf_counter()
    program(**fleet.draw(0))
    _sync(device)
    setup_s = time.perf_counter() - t0
    print(f"[{workload}] set-up {setup_s:.3f} s (to the harness "
          f"{t_in - t0:.3f}, fleet and program data {t_data - t_in:.3f}, "
          f"warm call {t0 + setup_s - t_data:.3f}), {lanes} lanes a call",
          file=log, flush=True)

    results, walls, solutions = [], [], []
    counters = {}
    counter_paths = {k: v for r in readers.values()
                     for k, v in getattr(r, "COUNTERS", {}).items()}
    spans: dict = {}
    trace_obj = None
    restore = install_spans(readers.values(), spans) if trace else None
    try:
        with (devtrace.profiled(device) if trace
              else contextlib.nullcontext()) as prof:
            start = time.perf_counter()
            call = 1
            while True:
                inputs = fleet.draw(call)
                before = _read_counters(counter_paths) if trace else None
                c0 = time.perf_counter()
                with (torch.profiler.record_function(devtrace.CALL_RANGE)
                      if trace else contextlib.nullcontext()):
                    sol = program(**inputs)
                    _sync(device)
                end = time.perf_counter()
                walls.append(end - c0)
                results.append((call, sol.x, sol.y, sol.ret))
                if trace:
                    solutions.append(sol)
                    after = _read_counters(counter_paths)
                    for k in counter_paths:
                        counters.setdefault(k, []).append(
                            None if before[k] is None
                            else after[k] - before[k])
                call += 1
                if trace:
                    if end - start >= seconds or len(walls) >= TRACE_CALLS:
                        break
                elif end - start >= seconds and len(walls) >= judged_n:
                    break
    finally:
        if restore is not None:
            restore()
    window_s = end - start
    peak = int(torch.cuda.max_memory_allocated(device)) \
        if device.type == "cuda" else 0
    certified = sum(int((r[3] == 0).sum()) for r in results)
    if trace:
        trace_obj = devtrace.Trace.from_events(prof.events)
    ctx = Context(lanes=lanes, calls=len(results), certified=certified,
                  window_s=window_s, setup_s=setup_s, walls=walls,
                  solutions=solutions, counters=counters, spans=spans,
                  trace=trace_obj)
    values = {}
    for m in metrics:
        v = readers[m["name"]].read(ctx)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device_info = dict(
        platform="gpu" if device.type == "cuda" else device.type,
        kind=torch.cuda.get_device_name(device) if device.type == "cuda"
        else device.type,
        count=1, memory_peak_bytes=peak, power_limit_w=power_limit(device))
    breakdown = None
    if trace_obj is not None and trace_obj.window() is not None:
        device_info.update(busy_s=trace_obj.busy_ns() / 1e9,
                           window_s=trace_obj.window_ns() / 1e9)
        breakdown = {"device_ops": trace_obj.top_device_ops(),
                     "idle_gaps": trace_obj.idle_gaps()}
    print(f"[{workload}] {len(results)} calls in {window_s:.3f} s, "
          f"walls {[round(w, 4) for w in walls]}", file=log, flush=True)

    # The program's state goes before the reference runs.
    del program, ctx, solutions, sol, inputs, trace_obj, prof
    readings = [reference.check_call(fleet, fleet.g(c), x, y, ret,
                                     cfg["guarantees"])
                for c, x, y, ret in results]
    numbers = reference.combine(readings)
    judged = reference.combine(readings[:judged_n])
    digest = hashlib.sha256()
    for r in results[:judged_n]:
        digest.update(r[3].cpu().numpy().tobytes())
    print(f"[{workload}] judged calls 1-{min(judged_n, len(results))}"
          f" of {len(results)}: {judged['lanes'] - judged['certified']} of "
          f"{judged['lanes']} lanes uncertified, ret sha256 "
          f"{digest.hexdigest()[:16]}", file=log, flush=True)
    print(f"[{workload}] reference, every call: {numbers['certified']} of "
          f"{numbers['lanes']} lanes certified; plain stationarity ratio "
          f"{numbers['stationarity_raw']!r}; worst dual on an inactive "
          f"constraint {numbers['inadmissible']!r} of the stationarity "
          f"tolerance; {numbers['near']} certified "
          f"lanes over {reference.NEAR} of a tolerance", file=log, flush=True)
    checks = {k: {"value": numbers[k], "limit": v}
              for k, v in limits(cfg).items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    result = dict(correct=correct, attempted=judged["lanes"],
                  failed=judged["lanes"] - judged["certified"],
                  metrics=values, device=device_info)
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def limits(config: dict) -> dict:
    """The limit of each number the check compares: the worst stationarity,
    complementarity and feasibility ratio of a certified lane to its stated
    tolerance, and the share of lanes left uncertified, in percent."""
    return {k: float(config["check"][k]) for k in
            ("stationarity", "complementarity", "feasibility",
             "uncertified_pct")}


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is a forbidden one."""
    return sorted({name for name in sys.modules
                   if name.split(".", 1)[0] in FORBIDDEN})
