"""The idle split over the solve's stages (``benchmark/stages.py``) on a
synthetic timeline, and the readers of the split and of the host-sync
counter."""

import types

import numpy as np
import pytest

from benchmark import harness, stages
from benchmark.devtrace import CALL_RANGE, Trace

A = np.array
SPLIT = {"predictor": "predictor_idle_pct", "inner_qp": "inner_qp_idle_pct",
         "corrector": "corrector_idle_pct", "entry": "entry_idle_pct"}


def timeline(spans=True) -> Trace:
    # Window 0..100 ns; device busy [10, 20], [40, 50], [85, 90]: idle
    # [0, 10], [20, 40], [50, 85], [90, 100] (75 ns).  The program's call
    # [5, 95] holds its predictor [8, 60] (inner QP [30, 45] inside) and
    # its corrector [60, 95]; a span that no stage names ([31, 36]) is
    # passed over.
    host = [(6, 7, "cudaLaunchKernel", True),
            (35, 45, "aten::add", False)]
    if spans:
        host += [(5, 95, "lcqpow::call", False),
                 (8, 60, "lcqpow::predictor", False),
                 (30, 45, "lcqpow::inner_qp", False),
                 (31, 36, "lcqpow::probe", False),
                 (60, 95, "lcqpow::corrector", False)]
    host.sort()
    return Trace(
        kernel_start=A([10, 40, 85]), kernel_dur=A([10, 10, 5]),
        kernel_name=["add", "gemv", "add"], kernel_launch=A([6, 36, 70]),
        dev_start=A([10, 40, 85]), dev_end=A([20, 50, 90]),
        host_start=A([h[0] for h in host]), host_end=A([h[1] for h in host]),
        host_name=[h[2] for h in host],
        host_is_runtime=A([h[3] for h in host]),
        ranges={CALL_RANGE: (A([0]), A([100]))})


def _read(name, trace):
    return harness.load_reader(name).read(types.SimpleNamespace(trace=trace))


def test_a_gap_across_two_stages_is_split_by_time():
    t = timeline()
    # [50, 85] lies 10 ns in the predictor and 25 ns in the corrector;
    # [20, 40] 10 ns in the predictor and 10 ns in the inner QP.
    assert stages.idle_pct(t, "corrector") == pytest.approx(30.0)
    assert stages.idle_pct(t, "inner_qp") == pytest.approx(10.0)


def test_a_nested_span_is_taken_out_of_its_parent():
    t = timeline()
    # The predictor [8, 60] less its inner QP [30, 45]: idle [8, 10],
    # [20, 30], [50, 60].
    assert stages.idle_pct(t, "predictor") == pytest.approx(22.0)
    # The call less its three stages: [5, 8].
    assert stages.idle_pct(t, "entry") == pytest.approx(3.0)


def test_the_stages_and_the_rest_add_up_to_the_idle_share():
    t = timeline()
    shares = {s: _read(name, t) for s, name in SPLIT.items()}
    rest = stages.outside_idle_pct(t)
    assert rest == pytest.approx(10.0)
    assert sum(shares.values()) + rest == pytest.approx(
        _read("device_idle_pct", t))


def test_nested_calls_count_once():
    t = timeline()
    # A retry's call inside the corrector's time counts once.
    t.host_start = np.append(t.host_start, 70)
    t.host_end = np.append(t.host_end, 80)
    t.host_name = t.host_name + ["lcqpow::call"]
    t.host_is_runtime = np.append(t.host_is_runtime, False)
    assert stages.idle_pct(t, "entry") == pytest.approx(3.0)
    assert stages.outside_idle_pct(t) == pytest.approx(10.0)


def test_no_split_without_the_programs_spans_or_the_card():
    for name in SPLIT.values():
        assert _read(name, timeline(spans=False)) is None
        assert _read(name, None) is None
    t = timeline()
    t.dev_start, t.dev_end = A([], dtype=np.int64), A([], dtype=np.int64)
    assert all(_read(name, t) is None for name in SPLIT.values())
    assert stages.outside_idle_pct(None) is None


def test_host_syncs_reader_reads_the_programs_counter(monkeypatch):
    import lcqpow_tpu_torch._sync as sync

    reader = harness.load_reader("host_syncs_per_call")
    ctx = types.SimpleNamespace(counters={"host_syncs": [300, 310]})
    assert reader.read(ctx) == pytest.approx(305)
    assert harness._read_counters(reader.COUNTERS) == {
        "host_syncs": sync.sync_count}
    # A tree without the counter: it does not resolve, and the metric is
    # left out.
    monkeypatch.delattr(sync, "sync_count")
    assert harness._read_counters(reader.COUNTERS) == {"host_syncs": None}
    ctx.counters = {"host_syncs": [None]}
    assert reader.read(ctx) is None
    ctx.counters = {}
    assert reader.read(ctx) is None
