"""The trace's reduction on a synthetic timeline: busy and idle time,
idle gaps by what the host did, kernels inside a range, and the
rooflines' arithmetic."""

import math
import types

import numpy as np
import pytest
import torch

from benchmark import devtrace, harness, roofline
from benchmark.devtrace import CALL_RANGE, Trace

A = np.array


def timeline() -> Trace:
    # Window 0..100 ns; device busy [10, 30], [50, 60], [70, 75].
    return Trace(
        kernel_start=A([10, 15, 50]), kernel_dur=A([10, 15, 10]),
        kernel_name=["gj", "add", "gj"], kernel_launch=A([6, 12, 45]),
        dev_start=A([10, 15, 50, 70]), dev_end=A([20, 30, 60, 75]),
        host_start=A([4, 35, 58, 60]), host_end=A([7, 45, 80, 62]),
        host_name=["cudaLaunchKernel", "aten::add", "aten::outer",
                   "aten::mul"],
        host_is_runtime=A([True, False, False, False]),
        ranges={CALL_RANGE: (A([0]), A([100])),
                "bench::gj_inverse": (A([5, 44]), A([8, 46]))})


def test_busy_idle_and_launches():
    t = timeline()
    assert t.window() == (0, 100)
    assert t.busy_ns() == 35
    assert t.kernels_in_window() == 3
    ctx = types.SimpleNamespace(trace=t, calls=1)
    idle = harness.load_reader("device_idle_pct").read(ctx)
    assert idle == pytest.approx(65.0)
    assert harness.load_reader("kernel_launches_per_call").read(ctx) == 3


def test_idle_gaps_by_what_the_host_did():
    gaps = dict(timeline().idle_gaps())
    assert gaps == {"cudaLaunchKernel": 10e-9, "aten::add": 20e-9,
                    "aten::outer": 10e-9, devtrace.BETWEEN_OPS: 25e-9}


def test_kernels_launched_inside_a_range():
    t = timeline()
    assert t.range_device_ns("bench::gj_inverse") == (2, 20)
    assert t.range_device_ns("bench::absent") is None
    assert t.range_busy_pct("bench::gj_inverse") == pytest.approx(
        100 * 20 / 35)
    assert t.range_busy_pct("bench::absent") is None
    ctx = types.SimpleNamespace(trace=t)
    t.ranges["bench::kkt_solve"] = (A([11]), A([13]))
    assert harness.load_reader("kkt_solve_device_pct").read(ctx) \
        == pytest.approx(100 * 15 / 35)
    assert harness.load_reader("corrector_device_pct").read(ctx) is None
    top = t.top_device_ops()
    assert top[0] == ["gj", 20e-9] and top[1] == ["add", 15e-9]


def test_gj_roofline_is_bound_over_device_time_of_its_range():
    t = timeline()
    recs = [dict(shapes=[(262144, 14, 14)], dtypes=[torch.float32],
                 trues=[None])] * 2
    ctx = types.SimpleNamespace(trace=t, spans={"gj_inverse": recs},
                                roofline=roofline)
    share = harness.load_reader("gj_inverse_roofline").read(ctx)
    bytes_s = 2 * 262144 * 14 * 14 * 4 / 3.35e12
    assert roofline.gj_bound_s(262144, 14) == pytest.approx(bytes_s)
    assert share == pytest.approx(100 * 2 * bytes_s / 20e-9)
    ctx.spans = {}
    assert harness.load_reader("gj_inverse_roofline").read(ctx) is None


def test_perturb_roofline_counts_going_lanes():
    B, n = 4096, 8
    go = torch.zeros(B, dtype=torch.bool)
    go[:1000] = True
    t = timeline()
    t.ranges["bench::perturb_apply"] = (A([44]), A([46]))
    rec = harness._describe((torch.zeros(B, 2, dtype=torch.int64), go,
                             torch.zeros(B, n)))
    assert int(rec["trues"][1]) == 1000
    ctx = types.SimpleNamespace(trace=t, spans={"perturb_apply": [rec]},
                                roofline=roofline)
    share = harness.load_reader("perturb_apply_roofline").read(ctx)
    ops_s = 1000 * (4 + 2 * n) * 79 / 33.5e12 + 1000 * n / 67e12
    bytes_s = (B * 33 + 2 * B * n * 4) / 3.35e12
    assert share == pytest.approx(100 * max(ops_s, bytes_s) / 10e-9)


class _Ev:
    """A raw profiler event as torch 2.13 gives it (with its activity
    type)."""

    def __init__(self, kind, name, start, dur, corr=0, linked=0):
        self._k, self._n, self._s, self._d = kind, name, start, dur
        self._c, self._l = corr, linked

    def activity_type(self):
        return self._k

    def is_user_annotation(self):
        return self._k in ("user_annotation", "gpu_user_annotation")

    def device_type(self):
        gpu = self._k in ("kernel", "gpu_memcpy", "gpu_memset",
                          "gpu_user_annotation")
        return torch.autograd.DeviceType.CUDA if gpu \
            else torch.autograd.DeviceType.CPU

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def correlation_id(self):
        return self._c

    def linked_correlation_id(self):
        return self._l


class _EvNoKind(_Ev):
    """The same event as torch 2.11 gives it: no activity type."""

    activity_type = None


@pytest.mark.parametrize("ev", [_Ev, _EvNoKind])
def test_from_events_links_kernels_to_their_launch(ev):
    evs = [ev("user_annotation", CALL_RANGE, 0, 1000),
           ev("user_annotation", "bench::gj_inverse", 100, 50),
           ev("cpu_op", "aten::add", 300, 20, corr=3),
           ev("cuda_runtime", "cudaLaunchKernel", 110, 5, corr=7, linked=1),
           ev("cuda_runtime", "cudaLaunchKernel", 305, 5, corr=8, linked=3),
           ev("cuda_runtime", "cudaMemcpyAsync", 690, 5, corr=9, linked=3),
           ev("kernel", "gj_warp_kernel", 400, 30, corr=7, linked=1),
           ev("kernel", "add_kernel", 500, 10, corr=8, linked=3),
           ev("kernel", "orphan", 600, 10, corr=99, linked=3),
           ev("gpu_user_annotation", "bench::gj_inverse", 400, 30),
           ev("gpu_memcpy", "Memcpy DtoH", 700, 40, corr=9)]
    t = Trace.from_events(evs)
    assert list(t.kernel_launch) == [110, 305]
    assert t.range_device_ns("bench::gj_inverse") == (1, 30)
    assert t.busy_ns() == 30 + 10 + 40
    assert t.kernels_in_window() == 2
    assert math.isclose(sum(s for _, s in t.idle_gaps()), 920e-9)


@pytest.mark.parametrize("ev", [_Ev, _EvNoKind])
def test_annotations_mirrored_on_the_card_are_no_operations(ev):
    """Spans the program may add (``record_function`` of any name) are
    mirrored onto the card's timeline by Kineto; they are neither kernels
    nor busy time, and the kernels inside them count once."""
    evs = [ev("user_annotation", CALL_RANGE, 0, 1000),
           ev("user_annotation", "lcqpow::solve", 50, 800, corr=2),
           ev("cuda_runtime", "cudaLaunchKernel", 110, 5, corr=7, linked=2),
           ev("cuda_runtime", "cuLaunchKernel", 120, 5, corr=8, linked=2),
           ev("kernel", "gemv", 400, 30, corr=7, linked=2),
           ev("kernel", "gj_warp_kernel", 450, 20, corr=8, linked=2),
           ev("gpu_user_annotation", "lcqpow::solve", 400, 70, corr=2),
           ev("gpu_user_annotation", "solver.solve", 380, 300),
           # A mirror whose id equals a launch's, as on the card.
           ev("gpu_user_annotation", "lcqpow::kkt", 400, 50, corr=8)]
    t = Trace.from_events(evs)
    assert t.kernel_name == ["gemv", "gj_warp_kernel"]
    assert t.busy_ns() == 50
    assert t.kernels_in_window() == 2
    assert dict(t.top_device_ops()) == {"gemv": 30e-9,
                                        "gj_warp_kernel": 20e-9}
