"""What decides ``correct``: the float64 reference on a tiny fleet, the
controls in the precision below the configuration's, and whole runs with
the timed path broken underneath, each of which must come out false."""

import dataclasses
import time

import pytest
import torch

import lcqpow_tpu_torch as lt
from benchmark import control, harness, reference
from benchmark.fleet import Fleet

from conftest import TINY


def run(spec, bench, workload="warmup-sweep"):
    return harness.run(spec, workload, 7, 0.0, False, "cpu",
                       time.perf_counter(), bench_dir=bench)


def test_reference_passes_the_program_and_fails_an_altered_answer(tiny_spec):
    cell = harness.load_cell(*tiny_spec[:1], "warmup-sweep",
                             bench_dir=tiny_spec[1])
    fleet = Fleet(cell.config["problem"], TINY, 3, "cpu")
    sol = harness.Program(cell.config["solver"], fleet)(fleet.g(1))
    G = cell.config["guarantees"]
    good = reference.check_call(fleet, fleet.g(1), sol.x, sol.y, sol.ret, G)
    assert good["certified"] == TINY
    assert max(good[k] for k in ("stationarity", "complementarity",
                                 "feasibility")) < 1.0
    # The answer to another call's g is not an answer to this one.
    other = reference.check_call(fleet, fleet.g(2), sol.x, sol.y, sol.ret, G)
    assert other["stationarity"] > 1.0
    # A dual with the wrong sign convention.
    flipped = reference.check_call(fleet, fleet.g(1), sol.x, -sol.y,
                                   sol.ret, G)
    assert flipped["stationarity"] > 1.0
    bad = sol.x.clone()
    bad[:, 0] = float("nan")
    assert reference.check_call(fleet, fleet.g(1), bad, sol.y, sol.ret,
                                G)["stationarity"] == float("inf")


@pytest.mark.parametrize("name", ["f32_predictor", "no_corrector"])
def test_controls_come_out_not_correct(tiny_spec, name):
    cell = harness.load_cell(tiny_spec[0], "warmup-sweep",
                             bench_dir=tiny_spec[1])
    got = control.read(cell, 11, name, 1, "cpu")
    assert not got["correct"]
    if name == "f32_predictor":
        assert got["stationarity"] > 1e3 and got["certified"] > 0
    else:
        assert got["uncertified_pct"] > 50.0


def test_program_reads_correct_in_both_cells(tiny_spec):
    for w in ("warmup-sweep", "pas-sweep"):
        result = run(*tiny_spec, workload=w)
        assert result["correct"], result["checks"]


def _solution(sol, **fields):
    return dataclasses.replace(sol, **fields)


def _unchanged(sol, data):
    """The solve returns its start: x = 0, y = 0, certified."""
    return _solution(sol, x=torch.zeros_like(sol.x),
                     y=torch.zeros_like(sol.y),
                     ret=torch.zeros_like(sol.ret))


def _unchanged_uncertified(sol, data):
    return _solution(_unchanged(sol, data),
                     ret=torch.full_like(sol.ret, 100))


def _unchanged_box_absorbs(sol, data):
    """The solve returns its start, x = 0, certified, with the residual of
    stationarity put into the box duals (the family has no box): y_box =
    Qx + g - A'y_A - L'y_L - R'y_R with every other dual 0."""
    y = torch.zeros_like(sol.y)
    y[:, :data.nV] = data.g
    return _solution(sol, x=torch.zeros_like(sol.x), y=y,
                     ret=torch.zeros_like(sol.ret))


def _half_copied(sol, data):
    """Half of the batch left out: its lanes carry the first half's
    answers."""
    h = sol.x.shape[0] // 2
    return sol.map(lambda a: torch.cat([a[:h], a[:h]]))


def _half_dropped(sol, data):
    """Half of the batch left out and reported as not solved."""
    h = sol.ret.shape[0] // 2
    ret = sol.ret.clone()
    ret[h:] = 100
    return _solution(sol, ret=ret)


def _altered(sol, data):
    """One lane's answer altered where it is produced."""
    x = sol.x.clone()
    x[5, 3] += 1e-7
    return _solution(sol, x=x)


@pytest.mark.parametrize("fault", [_unchanged, _unchanged_uncertified,
                                   _unchanged_box_absorbs,
                                   _half_copied, _half_dropped, _altered])
def test_a_run_with_the_timed_path_broken_is_not_correct(
        tiny_spec, monkeypatch, fault):
    entry = lt.solve_batch_mixed
    monkeypatch.setattr(lt, "solve_batch_mixed",
                        lambda data, *a, **k: fault(entry(data, *a, **k),
                                                    data))
    result = run(*tiny_spec)
    assert result["correct"] is False, result["checks"]


def test_box_duals_and_inactive_duals_are_not_admitted(tiny_spec):
    """The reference admits no dual on an inactive constraint: x = 0 with
    the whole residual in y_box, or in y_A of rows that x = 0 leaves
    inactive, reads far over the limit, and the dual is reported."""
    cell = harness.load_cell(tiny_spec[0], "warmup-sweep",
                             bench_dir=tiny_spec[1])
    fleet = Fleet(cell.config["problem"], TINY, 3, "cpu")
    G = cell.config["guarantees"]
    g = fleet.g(1)
    nV = fleet.nV
    x = torch.zeros(TINY, nV, dtype=torch.float64)
    ret = torch.zeros(TINY, dtype=torch.int32)
    y = torch.zeros(TINY, nV + fleet.nC + 2 * fleet.nComp,
                    dtype=torch.float64)
    y[:, :nV] = g
    got = reference.check_call(fleet, g, x, y, ret, G)
    assert got["complementarity"] == 0.0 and got["feasibility"] == 0.0
    assert got["stationarity"] > 1e6 and got["inadmissible"] > 1e6
    # Duals of the rows of A, which x = 0 leaves inactive (lbA < -0.5 <
    # 0.5 < ubA), solving A'y_A = g in the least-squares sense.
    A = fleet.lane("A")
    yA = torch.linalg.lstsq(A.mT, g[:, :, None]).solution[..., 0]
    y = torch.zeros_like(y)
    y[:, nV:nV + fleet.nC] = yA
    got = reference.check_call(fleet, g, x, y, ret, G)
    assert got["stationarity"] > 1e6 and got["inadmissible"] > 1e6


def test_a_multiplier_of_the_wrong_sign_is_not_admitted(tiny_spec):
    """A program's lane with a row of A at one of its bounds (y_A != 0),
    re-posed with g' = g - 2 A_i' y_A_i so that the same x with y_A_i
    negated is stationary, feasible and complementary: only the sign of
    the multiplier is wrong, and the check sees it."""
    cell = harness.load_cell(tiny_spec[0], "warmup-sweep",
                             bench_dir=tiny_spec[1])
    fleet = Fleet(cell.config["problem"], TINY, 3, "cpu")
    sol = harness.Program(cell.config["solver"], fleet)(fleet.g(1))
    G = cell.config["guarantees"]
    nV, nC = fleet.nV, fleet.nC
    yA = sol.y[:, nV:nV + nC]
    lane, row = (int(i) for i in torch.nonzero(yA.abs() > 1e-3)[0])
    good = reference.check_call(fleet, fleet.g(1), sol.x, sol.y, sol.ret, G)
    assert good["stationarity"] < 1.0 and good["inadmissible"] < 1e-3
    y = sol.y.clone()
    y[lane, nV + row] = -yA[lane, row]
    g = fleet.g(1).clone()
    g[lane] -= 2 * yA[lane, row] * fleet.lane("A")[lane, row]
    got = reference.check_call(fleet, g, sol.x, y, sol.ret, G)
    assert got["complementarity"] == good["complementarity"]
    assert got["feasibility"] == good["feasibility"]
    assert got["stationarity"] > 1e6 and got["inadmissible"] > 1e6


@pytest.mark.parametrize("name", sorted(control.MATVECS))
def test_matvec_variants_change_only_the_rounding(name):
    mv, mtv = control.MATVECS[name]
    gen = torch.Generator().manual_seed(5)
    A = torch.randn(32, 14, 8, generator=gen)
    x = torch.randn(32, 8, generator=gen)
    y = torch.randn(32, 14, generator=gen)
    exact = (A.double() @ x.double()[..., None])[..., 0]
    exact_t = (A.double().mT @ y.double()[..., None])[..., 0]
    got, got_t = mv(A, x), mtv(A, y)
    assert got.dtype == got_t.dtype == torch.float32
    if name == "mv_f64acc":
        assert torch.equal(got, exact.float())
        assert torch.equal(got_t, exact_t.float())
    else:
        eps = torch.finfo(torch.float32).eps
        bound = 14 * eps * (A.abs().double() @ x.abs().double()[..., None])[
            ..., 0]
        assert ((got.double() - exact).abs() <= bound).all()
        bound_t = 14 * eps * (A.abs().double().mT
                              @ y.abs().double()[..., None])[..., 0]
        assert ((got_t.double() - exact_t).abs() <= bound_t).all()


def test_flip_control_swaps_every_matvec_binding_and_puts_it_back(
        tiny_spec):
    import importlib
    import sys

    from lcqpow_tpu_torch.ops import linalg

    mods = [importlib.import_module(n) for n in control.MATVEC_USERS]
    # No other module of the program binds the matvec the control swaps.
    bound = {n for n, m in list(sys.modules.items())
             if m is not None and n.split(".")[0] == "lcqpow_tpu_torch"
             and any(vars(m).get(a) is getattr(linalg, a)
                     for a in ("mv", "mtv"))}
    assert bound == set(control.MATVEC_USERS)
    before = [(m, a, vars(m)[a]) for m in mods for a in ("mv", "mtv")
              if a in vars(m)]
    mv, mtv = control.MATVECS["mv_reordered"]
    with control.matvec_swapped(mv, mtv):
        assert all(vars(m)[a] is (mv if a == "mv" else mtv)
                   for m, a, _ in before)
    assert all(vars(m)[a] is f for m, a, f in before)

    cell = harness.load_cell(tiny_spec[0], "warmup-sweep",
                             bench_dir=tiny_spec[1])
    lines = control.flips(cell, 2 ** 31 + 13, "cpu")
    assert [r["variant"] for r in lines] == ["program", *control.MATVECS]
    for r in lines:
        assert r["lanes"] == harness.JUDGED_CALLS * TINY and r["correct"]
    for r in lines[1:]:
        assert r["uncertified_program"] == lines[0]["uncertified"]
        assert r["uncertified"] - r["uncertified_program"] == \
            r["certified_by_program_only"] - r["certified_by_variant_only"]
    assert all(vars(m)[a] is f for m, a, f in before)
