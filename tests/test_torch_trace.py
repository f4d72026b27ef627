"""The port's own tracing: the solve's spans (``_trace.span``) and its
count of host waits (``_sync.sync_count``).

With no profiler a span makes no ``record_function`` call; under
``torch.profiler`` a mixed solve emits one ``lcqpow::call`` holding the
predictor, then the corrector, and the inner QP calls inside the
predictor.  The case marked ``gpu`` holds the count of host waits to the
card's stream syncs and device-to-host copies in one profiled call.

This file imports no JAX, so it also runs on a machine without it::

    python -m pytest --noconftest tests/test_torch_trace.py -q
"""

import pytest
import torch

import lcqpow_tpu_torch as lt
from lcqpow_tpu_torch import _sync, _trace, prng
from lcqpow_tpu_torch.problems import warmup_fleet

B = 16
OPTIONS = dict(max_iterations=200)


def _solve(data, engine="admm", **kw):
    return lt.solve_batch_mixed(
        data, lt.Options(inner_solver=engine, **OPTIONS),
        n_corrector_iters=6, **kw)


def _spans(prof) -> dict:
    """The program's spans of a profile: name without the prefix -> sorted
    (start, end) in ns."""
    out: dict = {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if name.startswith(_trace.PREFIX):
            start = int(e.start_ns())
            out.setdefault(name[len(_trace.PREFIX):], []).append(
                (start, start + int(e.duration_ns())))
    return {k: sorted(v) for k, v in out.items()}


def _inside(span, outer) -> bool:
    return any(lo <= span[0] and span[1] <= hi for lo, hi in outer)


def test_span_off_makes_no_record_function_call(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    first = _trace.span("call")
    with first:
        with _trace.span("predictor"):
            pass
    assert _trace.span("corrector") is first


def test_span_on_is_a_range_of_the_prefixed_name():
    with torch.profiler.profile() as prof:
        with _trace.span("probe"):
            torch.ones(3).sum()
    assert list(_spans(prof)) == ["probe"]


@pytest.mark.parametrize("engine", ["admm", "pas"])
def test_profiled_call_nests_the_stages(engine, monkeypatch):
    data = warmup_fleet(B, device="cpu")
    _solve(data, engine, escalate=0)
    passes = []
    perturbation = prng.perturbation

    def counted(*args):
        step = perturbation(*args)

        def counted_step(*a):
            passes.append(1)
            return step(*a)
        return counted_step

    monkeypatch.setattr(prng, "perturbation", counted)
    with torch.profiler.profile() as prof:
        _solve(data, engine, escalate=0)
    s = _spans(prof)
    assert set(s) == {"call", "predictor", "inner_qp", "corrector"}
    assert len(s["call"]) == 1
    (pred,), (corr,) = s["predictor"], s["corrector"]
    assert _inside(pred, s["call"]) and _inside(corr, s["call"])
    assert pred[1] <= corr[0]
    # The first engine call comes before the first pass's perturbation.
    assert passes and len(s["inner_qp"]) == len(passes) + 1
    assert all(_inside(q, s["predictor"]) for q in s["inner_qp"])


@pytest.mark.parametrize("engine", ["admm", "pas"])
def test_escalation_rounds_are_spans_and_counted(engine):
    data = warmup_fleet(B, device="cpu")
    opts = lt.Options(max_iterations=3, perturb_step=False,
                      inner_solver=engine)
    before = _sync.sync_count
    with torch.profiler.profile() as prof:
        sol = lt.solve_batch_mixed(data, opts, n_corrector_iters=0,
                                   escalate=1)
    s = _spans(prof)
    assert len(s["escalate"]) == 1
    # The retry is a call of the entry inside the round.
    assert len(s["call"]) == 2 and _inside(s["call"][1], s["escalate"])
    assert _sync.sync_count > before
    assert sol.ret.shape == (B,)


@pytest.mark.parametrize("engine", ["admm", "pas"])
def test_sync_count_repeats_over_identical_calls(engine):
    data = warmup_fleet(B, device="cpu")
    deltas = []
    for _ in range(2):
        before = _sync.sync_count
        _solve(data, engine)
        deltas.append(_sync.sync_count - before)
    assert deltas[0] > 0 and deltas[0] == deltas[1]


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ["admm", "pas"])
def test_host_syncs_are_the_calls_copies_to_the_host_on_card(engine):
    """Every host wait of a call is a counted read of a device flag or
    count: the call's stream syncs and its device-to-host copies are as
    many as the counter's waits, and nothing is copied from the host."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    data = warmup_fleet(1024)
    _solve(data, engine, escalate=0)
    torch.cuda.synchronize()
    before = _sync.sync_count
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        _solve(data, engine, escalate=0)
        torch.cuda.synchronize()
    syncs = _sync.sync_count - before
    events = prof.profiler.kineto_results.events()
    card = [e.name() for e in events
            if e.device_type() == torch.autograd.DeviceType.CUDA]
    waits = sum(1 for e in events
                if e.device_type() != torch.autograd.DeviceType.CUDA
                and e.name() == "cudaStreamSynchronize")
    copies = sum(1 for n in card if n.startswith("Memcpy DtoH"))
    uploads = sum(1 for n in card if n.startswith("Memcpy HtoD"))
    assert syncs > 0 and waits == syncs and copies == syncs
    assert uploads == 0
