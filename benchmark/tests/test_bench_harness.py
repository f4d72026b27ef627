"""The harness: cells, mixes and metrics found by name; the rate over
whole calls; the result line's shape."""

import dataclasses
import io
import json
import re
import sys
import time

import pytest
import torch

from benchmark import harness

from conftest import TINY


def run(spec, bench, workload="warmup-sweep", seconds=0.0, trace=False,
        seed=2 ** 31 + 5):
    return harness.run(spec, workload, seed, seconds, trace, "cpu",
                       time.perf_counter(), bench_dir=bench)


def test_spec_names_a_reader_for_every_metric_and_files_for_every_cell():
    spec = json.loads((harness.BENCH_DIR.parent / "BENCHMARK.json")
                      .read_text())
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert hasattr(harness.load_reader(m["name"]), "read")
    for w in spec["workloads"]:
        cell = harness.load_cell(harness.BENCH_DIR.parent / "BENCHMARK.json",
                                 w["name"])
        assert cell.traffic["lanes_per_call"] > 0
        assert set(harness.limits(cell.config)) == {
            "stationarity", "complementarity", "feasibility",
            "uncertified_pct"}


def test_added_config_traffic_and_metric_are_found_by_name(tiny_spec):
    spec_path, bench = tiny_spec
    spec = json.loads(spec_path.read_text())
    cfg = json.loads((bench / "configs" / "warmup-admm.json").read_text())
    cfg.update(name="warmup-small")
    cfg["problem"].update(base_instances=16)
    (bench / "configs" / "warmup-small.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "tiny-32.json").write_text(json.dumps(
        {"name": "tiny-32", "lanes_per_call": 32}))
    (bench / "metrics" / "lanes_per_call.py").write_text(
        "def read(ctx):\n    return ctx.lanes\n")
    spec["configs"].append(dict(spec["configs"][0], name="warmup-small",
                                file="bench/configs/warmup-small.json"))
    spec["workloads"].append({"name": "small", "config": "warmup-small",
                              "traffic": "tiny-32", "chips": 1, "why": "t"})
    spec["per_layer"].append({"name": "lanes_per_call", "unit": "lanes",
                              "better": "higher", "source": "program_counter",
                              "layer": "entry", "moves": "certified_per_s",
                              "workloads": ["small"]})
    spec_path.write_text(json.dumps(spec))
    result = run(spec_path, bench, "small", trace=True)
    assert result["metrics"]["lanes_per_call"]["value"] == 32
    assert result["attempted"] == 32 and result["correct"]
    result = run(spec_path, bench, "warmup-sweep", trace=True)
    assert "lanes_per_call" not in result["metrics"]


def test_rate_is_certified_lanes_of_whole_calls_over_the_window(
        tiny_spec, monkeypatch):
    spec_path, bench = tiny_spec
    pause = 0.15
    orig = harness.Program.__call__

    def slow(self, g):
        sol = orig(self, g)
        time.sleep(pause)
        return sol

    monkeypatch.setattr(harness.Program, "__call__", slow)
    result = run(spec_path, bench, seconds=1.5)
    calls = result["attempted"] // 64
    certified = result["attempted"] - result["failed"]
    rate = result["metrics"]["certified_per_s"]["value"]
    assert calls >= 2
    # Every call of the window counts, the last one whole: the window
    # ends after the last call, so it lasts at least `seconds` and the
    # rate covers every lane solved in it.
    window = certified / rate
    assert window >= 1.5
    assert window >= calls * pause
    assert set(result["metrics"]) == {"certified_per_s", "setup_s"}
    assert list(result)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} \
        <= set(result)
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}


def test_traced_run_reads_per_layer_metrics_and_restores_the_program(
        tiny_spec):
    import lcqpow_tpu_torch.mixed as mixed
    import lcqpow_tpu_torch.ops.chol as chol
    import lcqpow_tpu_torch.prng as prng
    import lcqpow_tpu_torch.solvers.admm as admm

    spec_path, bench = tiny_spec
    wrapped = (chol.gj_inverse, prng.perturbation, mixed.solve,
               mixed.correct_and_certify, admm._polish_solve)
    result = run(spec_path, bench, "pas-sweep", seconds=60.0, trace=True)
    assert (chol.gj_inverse, prng.perturbation, mixed.solve,
            mixed.correct_and_certify, admm._polish_solve) == wrapped
    assert result["attempted"] == harness.TRACE_CALLS * 64
    m = result["metrics"]
    for name in ("call_s_p50", "iter_total_mean", "subproblem_iter_mean",
                 "corrector_steps_mean"):
        assert m[name]["value"] > 0
    # No card: no device operation to read, so the device's metrics are
    # left out, never reported as 0.
    for name in ("device_idle_pct", "gj_inverse_roofline",
                 "perturb_apply_roofline", "kernel_launches_per_call",
                 "predictor_device_pct", "kkt_solve_device_pct",
                 "corrector_device_pct"):
        assert name not in m
    assert result["device"]["busy_s"] == 0
    assert len(result["breakdown"]["idle_gaps"]) <= 10


def test_run_refuses_without_a_card(tmp_path):
    import subprocess
    import sys

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, str(harness.BENCH_DIR / "run.py"),
                        "--workload", "warmup-sweep", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=120,
                       cwd=tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""


class _Clock:
    """The window's clock in the tests below: each call of the program
    takes ``pause`` seconds of it, so every window holds a known number
    of calls however fast the CPU runs them."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        return self.now


_PROGRAM_CALL = harness.Program.__call__


def _paced(monkeypatch, pause, fault=None):
    """The program with each call taking ``pause`` seconds of the
    harness's clock, and ``fault(call, sol)`` applied to call ``call``
    (call 0 warms up); returns the list of calls made."""
    clock = _Clock()
    monkeypatch.setattr(harness, "time", clock)
    made = []

    def paced(self, g):
        call = len(made)
        made.append(call)
        sol = _PROGRAM_CALL(self, g)
        clock.now += pause
        return sol if fault is None else fault(call, sol)

    monkeypatch.setattr(harness.Program, "__call__", paced)
    return made


def _uncertify(calls, lanes):
    """A fault: ``lanes`` of each call in ``calls`` left uncertified."""
    def fault(call, sol):
        if call not in calls:
            return sol
        ret = sol.ret.clone()
        ret[lanes] = 100
        return dataclasses.replace(sol, ret=ret)
    return fault


def _window_calls(made):
    return len(made) - 1


def run_paced(spec, bench, seconds, log=sys.stderr):
    """A run on the paced clock, which starts at 0."""
    return harness.run(spec, "warmup-sweep", 2 ** 31 + 5, seconds, False,
                       "cpu", 0.0, bench_dir=bench, log=log)


def test_a_fast_and_a_slow_tree_are_judged_on_the_same_calls(
        tiny_spec, monkeypatch):
    # Lane 3 of every odd call uncertified: calls 1, 3, ..., 11 of the
    # judged twelve, more beyond them.
    fault = _uncertify(range(1, 100, 2), [3])
    fast = _paced(monkeypatch, 0.1, fault)
    quick = run_paced(*tiny_spec, 1.75)
    slow = _paced(monkeypatch, 1.0, fault)
    late = run_paced(*tiny_spec, 1.75)
    assert _window_calls(fast) == 18 and _window_calls(slow) == 12
    assert quick["attempted"] == late["attempted"] \
        == harness.JUDGED_CALLS * TINY
    assert quick["failed"] == late["failed"] == 6
    # The whole window is still judged: 9 of 18 * 64 lanes.
    assert quick["checks"]["uncertified_pct"]["value"] \
        == pytest.approx(100 * 9 / (18 * TINY))
    assert late["checks"]["uncertified_pct"]["value"] \
        == pytest.approx(100 * 6 / (12 * TINY))


def test_a_window_too_slow_for_the_judged_calls_runs_on_to_them(
        tiny_spec, monkeypatch):
    made = _paced(monkeypatch, 1.0)
    result = run_paced(*tiny_spec, 2.0)
    assert _window_calls(made) == harness.JUDGED_CALLS
    assert result["attempted"] == harness.JUDGED_CALLS * TINY
    certified = harness.JUDGED_CALLS * TINY - result["failed"]
    assert result["metrics"]["certified_per_s"]["value"] \
        == pytest.approx(certified / harness.JUDGED_CALLS)


@pytest.mark.parametrize("call,judged", [(1, True), (13, False)])
def test_a_lane_uncertified_counts_as_failed_only_in_a_judged_call(
        tiny_spec, monkeypatch, call, judged):
    _paced(monkeypatch, 0.1)
    clean = run_paced(*tiny_spec, 1.45)
    made = _paced(monkeypatch, 0.1, _uncertify({call}, [7]))
    log = io.StringIO()
    faulty = run_paced(*tiny_spec, 1.45, log=log)
    assert _window_calls(made) == 15
    assert faulty["attempted"] == clean["attempted"]
    assert faulty["failed"] == clean["failed"] + judged
    # The whole window's count has the lane either way.
    whole = re.search(r"every call: (\d+) of (\d+) lanes certified",
                      log.getvalue())
    assert int(whole[2]) - int(whole[1]) == 1 + round(
        clean["checks"]["uncertified_pct"]["value"] * 15 * TINY / 100)
    assert faulty["checks"]["uncertified_pct"]["value"] == pytest.approx(
        clean["checks"]["uncertified_pct"]["value"] + 100 / (15 * TINY))


def test_half_a_batch_dropped_after_the_judged_calls_is_not_correct(
        tiny_spec, monkeypatch):
    _paced(monkeypatch, 0.1, _uncertify({13}, slice(TINY // 2, None)))
    result = run_paced(*tiny_spec, 1.45)
    assert result["failed"] == 0
    check = result["checks"]["uncertified_pct"]
    assert check["value"] > check["limit"]
    assert result["correct"] is False


def test_judged_calls_are_the_mixs_and_twelve_where_it_sets_none(
        tiny_spec, monkeypatch):
    spec_path, bench = tiny_spec
    assert harness.judged_calls({}) == harness.JUDGED_CALLS == 12
    for bad in (0, -1, 2.5, True, "3"):
        with pytest.raises(harness.SpecError):
            harness.judged_calls({"judged_calls": bad})
    tiny = bench / "traffic" / "tiny.json"
    tiny.write_text(json.dumps(dict(json.loads(tiny.read_text()),
                                    judged_calls=3)))
    fault = _uncertify(range(1, 100), [5])
    slow = _paced(monkeypatch, 1.0, fault)
    late = run_paced(spec_path, bench, 2.0)
    fast = _paced(monkeypatch, 0.1, fault)
    log = io.StringIO()
    quick = run_paced(spec_path, bench, 1.75, log=log)
    # A slow window runs on to the mix's three calls and no further; a
    # fast one fills its seconds; both judge exactly calls 1-3.
    assert _window_calls(slow) == 3 and _window_calls(fast) == 18
    assert late["attempted"] == quick["attempted"] == 3 * TINY
    assert late["failed"] == quick["failed"] == 3
    assert "judged calls 1-3 of 18" in log.getvalue()
