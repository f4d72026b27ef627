"""The readers of the matvec kernel's counters: the mean delta a traced
call, the kernel's share of the CUDA calls, and null on a tree that lacks
the counters (the parent of the kernel)."""

import types

import pytest

from benchmark import harness


def test_launches_reader_reads_the_mean_delta_of_the_programs_counter(
        monkeypatch):
    from lcqpow_tpu_torch.ops import linalg

    reader = harness.load_reader("matvec_launches_per_call")
    ctx = types.SimpleNamespace(
        counters={"matvec_launches": [6400, 6410, 6390]})
    assert reader.read(ctx) == pytest.approx(6400)
    assert harness._read_counters(reader.COUNTERS) == {
        "matvec_launches": linalg.matvec_launch_count}
    # A tree without the counter: it does not resolve, the metric is null.
    monkeypatch.delattr(linalg, "matvec_launch_count")
    assert harness._read_counters(reader.COUNTERS) == {
        "matvec_launches": None}
    ctx.counters = {"matvec_launches": [None, None, None]}
    assert reader.read(ctx) is None
    ctx.counters = {}
    assert reader.read(ctx) is None


def test_kernel_pct_reader_reads_the_kernels_share_of_the_cuda_calls(
        monkeypatch):
    from lcqpow_tpu_torch.ops import linalg

    reader = harness.load_reader("matvec_kernel_pct")
    ctx = types.SimpleNamespace(counters={
        "matvec_launches": [6000, 6000], "matvec_calls": [6400, 6400]})
    assert reader.read(ctx) == pytest.approx(93.75)
    ctx.counters["matvec_launches"] = [6400, 6400]
    assert reader.read(ctx) == pytest.approx(100.0)
    assert harness._read_counters(reader.COUNTERS) == {
        "matvec_launches": linalg.matvec_launch_count,
        "matvec_calls": linalg.matvec_call_count}
    # No CUDA call in the traced calls: no share to give.
    ctx.counters = {"matvec_launches": [0], "matvec_calls": [0]}
    assert reader.read(ctx) is None
    # A tree without the counters reads null.
    monkeypatch.delattr(linalg, "matvec_launch_count")
    monkeypatch.delattr(linalg, "matvec_call_count")
    assert harness._read_counters(reader.COUNTERS) == {
        "matvec_launches": None, "matvec_calls": None}
    ctx.counters = {"matvec_launches": [None], "matvec_calls": [None]}
    assert reader.read(ctx) is None
    ctx.counters = {}
    assert reader.read(ctx) is None
