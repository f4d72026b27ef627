"""Problem families as files: ``random_lcqp`` gives the inputs it gave
before it became a file, the circle family is LCQPow's OptimizeOnCircle,
a family of a test's own makes a cell with no file of ``benchmark/``
edited, and the reference refuses a family with a field it does not
check."""

import hashlib
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import harness, reference
from benchmark.fleet import BENCH_DIR, Fleet, SpecError

from conftest import ROOT, TINY

#: sha256 of each tensor's bytes of a ``TINY``-lane fleet on the CPU, as
#: the generator gave them before families were files (one set for both
#: configurations, whose ``problem`` blocks are the same).
BASE = {
    "Q": "fd8aabcbcf439b95363ee2f0c1ddbdad7a8f96af7e3e9b4fa716f1e338f7f8bf",
    "g": "a858fd3184204fcba92f5920be0423736d7b5898cc1dbcecb5731dc023796a22",
    "L": "800ee18e774162ddb4fe21e668ec0d71c3946588e0a0c7cb98f464972fb7de5f",
    "R": "d4c5935e5f667e1e382ec6ead86dfa12efcfba80bc09785dce8836ec6d529d20",
    "A": "6b9254092d276ce6fc9fc875726d793ab09b9f3abc76503bd47af5e38297bc2b",
    "lbA": "3bb42673f085d48da71b72785754ac00faf343fb211a360d593296dc7820b613",
    "ubA": "0e9a7bf6df7d22ae46e23c0a9067951d32ac72f4b397075480e929be82f21a92",
}
DRAWN = {
    2 ** 31 + 5: {
        "instance": "ed51eae43d13df52411102f4a94da13a63a0de31732383c118be12c6628bad2f",
        "g1": "3ebe843d3440f4bb43bf162bd9e1e3cf67c66f28d239efc09f1d991f9ab4f7f7",
        "g2": "46c4ee7521b278df173a4a73752ca24bac4bfdec85f45d74325c4ee294f358ba",
    },
    -7: {
        "instance": "0bdc25b5c22c315d6a106d842dfdc41dfa47d13b04ef96e73cab5f18186b40ca",
        "g1": "b1977c3749fe82c4b3b8b6120aeaa2bf4e4793c3ef8ae0cd78ab9a26ba5a75f2",
        "g2": "08f5543234ab93af70de3fc5666b08944a8c85bec428e693aa85be94aeda8cd2",
    },
}
W = torch.tensor([[17., -15.], [-15., 17.]], dtype=torch.float64)

#: A family of the tests' own: two copies of LCQPow's warm-up problem
#: with a coupling row, ``g`` moved by ``0.1 N(0, 1)`` a call.
WARM_UP_FAMILY = '''
import numpy as np
import torch

FIELDS = ("Q", "g", "L", "R", "A", "lbA", "ubA")


def instances(problem):
    one = dict(Q=2.0 * np.eye(2), g=np.array([-2.0, -2.0]),
               L=np.array([[1.0, 0.0]]), R=np.array([[0.0, 1.0]]),
               A=np.array([[1.0, 1.0]]), lbA=np.array([-10.0]),
               ubA=np.array([10.0]))
    return {k: np.stack([v, v]) for k, v in one.items()}


def draw(fleet, call):
    noise = torch.randn((fleet.lanes, fleet.nV),
                        generator=fleet.generator(call),
                        dtype=torch.float64, device=fleet.device)
    return {"g": fleet.lane("g") + 0.1 * noise}
'''


def _sha(t: torch.Tensor) -> str:
    return hashlib.sha256(t.cpu().contiguous().numpy().tobytes()).hexdigest()


def _add_cell(spec_path: Path, bench: Path, name: str, config: dict,
              traffic: dict) -> None:
    """A configuration, a mix and a cell of their own in the tmp spec,
    reporting the end-to-end metrics and ``call_s_p50``."""
    (bench / "configs" / f"{name}.json").write_text(json.dumps(config))
    (bench / "traffic" / f"{name}.json").write_text(json.dumps(traffic))
    spec = json.loads(spec_path.read_text())
    spec["configs"].append(dict(spec["configs"][0], name=name,
                                file=f"bench/configs/{name}.json"))
    spec["workloads"].append({"name": name, "config": name,
                              "traffic": name, "chips": 1, "why": "t"})
    spec["per_layer"][0]["workloads"].append(name)
    spec_path.write_text(json.dumps(spec))


def _circle_config(admm_config: dict, N: int) -> dict:
    """The circle at ``N`` with its options as LCQPow's example sets them
    (OSQP, stationarity tolerance 1e-2), ``escalate=3`` at full width."""
    cfg = json.loads(json.dumps(admm_config))
    cfg["problem"] = {"family": "optimize_on_circle", "N": N}
    cfg["solver"] = {"entry": "solve_batch_mixed",
                     "options": {"max_iterations": 200,
                                 "stationarity_tolerance": 1e-2,
                                 "qp_solver": 2},
                     "chunk": 0, "escalate": 3}
    cfg["guarantees"]["stationarity_tolerance"] = 1e-2
    return cfg


@pytest.mark.parametrize("seed", sorted(DRAWN))
@pytest.mark.parametrize("config", ["warmup-admm", "warmup-pas"])
def test_random_lcqp_fleet_is_the_one_before_families_were_files(config,
                                                                 seed):
    cfg = json.loads((BENCH_DIR / "configs" / f"{config}.json").read_text())
    fleet = Fleet(cfg["problem"], TINY, seed, "cpu")
    assert {k: _sha(v) for k, v in fleet.base.items()} == BASE
    assert list(fleet.base) == list(BASE)
    got = dict(instance=_sha(fleet.instance), g1=_sha(fleet.g(1)),
               g2=_sha(fleet.g(2)))
    assert got == DRAWN[seed]
    assert set(fleet.draw(1)) == {"g"}


def test_a_family_of_its_own_makes_a_cell_with_no_file_edited(tiny_spec):
    spec_path, bench = tiny_spec
    assert not (BENCH_DIR / "families" / "warm_up_pair.py").exists()
    (bench / "families" / "warm_up_pair.py").write_text(WARM_UP_FAMILY)
    cfg = json.loads((bench / "configs" / "warmup-admm.json").read_text())
    cfg.update(name="pair", problem={"family": "warm_up_pair"})
    _add_cell(spec_path, bench, "pair", cfg,
              {"name": "pair", "lanes_per_call": 16, "judged_calls": 2})
    result = harness.run(spec_path, "pair", 5, 0.0, False, "cpu",
                         time.perf_counter(), bench_dir=bench)
    assert result["correct"] and result["attempted"] == 2 * 16
    assert result["failed"] == 0
    fleet = Fleet({"family": "warm_up_pair"}, 16, 5, "cpu", bench)
    assert (fleet.nV, fleet.nC, fleet.nComp) == (2, 1, 1)
    assert torch.bincount(fleet.instance).tolist() == [8, 8]


def test_an_unknown_family_names_the_file_it_looked_for(tmp_path):
    with pytest.raises(SpecError, match="families/no_such_family.py"):
        Fleet({"family": "no_such_family"}, 4, 1, "cpu")
    with pytest.raises(SpecError, match="valid name"):
        Fleet({"family": "../metrics/setup_s"}, 4, 1, "cpu")
    (tmp_path / "families").mkdir()
    (tmp_path / "families" / "short.py").write_text(
        WARM_UP_FAMILY.replace('return {k: np.stack([v, v]) for k, v in '
                               'one.items()}',
                               'return {"Q": np.stack([one["Q"]])}'))
    with pytest.raises(SpecError, match="not its FIELDS"):
        Fleet({"family": "short"}, 4, 1, "cpu", tmp_path)


def test_circle_family_is_lcqpows_optimize_on_circle():
    from lcqpow_tpu_torch.problems import optimize_on_circle

    N, lanes = 4, 16
    fleet = Fleet({"family": "optimize_on_circle", "N": N}, lanes, 9, "cpu")
    data, x0 = optimize_on_circle(N, as_numpy=True)
    assert fleet.base["Q"].shape[0] == 1
    for name in fleet.fields:
        np.testing.assert_array_equal(fleet.base[name][0].numpy(),
                                      np.asarray(getattr(data, name)))
    # Field for field, as the program's entry gets it.
    program = harness.Program(
        _circle_config(json.loads((BENCH_DIR / "configs" /
                                   "warmup-admm.json").read_text()),
                       N)["solver"], fleet)
    for f in type(program.data).__dataclass_fields__:
        want = torch.as_tensor(np.asarray(getattr(data, f)),
                               dtype=torch.float64)
        got = getattr(program.data, f)
        assert got.shape == (lanes,) + want.shape, f
        assert torch.equal(got, want.expand_as(got)), f
    refs = []
    for call in (0, 1, 2):
        d = fleet.draw(call)
        assert set(d) == {"g", "x0"}
        g, start = d["g"], d["x0"]
        ref = start[:, :2]
        torch.testing.assert_close(g[:, :2], -(ref @ W.T), rtol=0, atol=0)
        assert torch.equal(g[:, 2:], fleet.lane("g")[:, 2:])
        assert torch.equal(start[:, 2:], torch.as_tensor(x0[2:]).expand(
            lanes, -1))
        assert torch.equal(fleet.draw(call)["x0"], start)
        refs.append(ref)
    # Each call draws targets of its own around (0.5, -0.6).
    assert not torch.equal(refs[1], refs[2])
    spread = torch.cat(refs) - torch.tensor([0.5, -0.6], dtype=torch.float64)
    assert 0.02 < float(spread.std()) < 0.1


def test_tiny_circle_cell_runs_end_to_end(tiny_spec):
    spec_path, bench = tiny_spec
    cfg = _circle_config(json.loads((bench / "configs" / "warmup-admm.json")
                                    .read_text()), 4)
    cfg["name"] = "circle-tiny"
    _add_cell(spec_path, bench, "circle-tiny", cfg,
              {"name": "circle-tiny", "lanes_per_call": 16,
               "judged_calls": 2})
    result = harness.run(spec_path, "circle-tiny", 2 ** 31 + 11, 0.0, False,
                         "cpu", time.perf_counter(), bench_dir=bench)
    assert result["attempted"] == 2 * 16
    assert result["metrics"]["certified_per_s"]["value"] > 0
    assert set(result["checks"]) == {"stationarity", "complementarity",
                                     "feasibility", "uncertified_pct"}
    for c in result["checks"].values():
        assert np.isfinite(c["value"])


@pytest.mark.parametrize("field", ["lbL", "ubR", "lb"])
def test_reference_refuses_a_family_with_a_field_it_does_not_check(
        tmp_path, field):
    (tmp_path / "families").mkdir()
    (tmp_path / "families" / "bounded.py").write_text(
        WARM_UP_FAMILY.replace('FIELDS = ("Q", "g", "L", "R", "A", "lbA", '
                               '"ubA")',
                               f'FIELDS = ("Q", "g", "L", "R", "A", "lbA", '
                               f'"ubA", "{field}")')
        .replace("ubA=np.array([10.0]))",
                 f"ubA=np.array([10.0]), {field}=np.array([0.5] * "
                 f"{2 if field == 'lb' else 1}))"))
    fleet = Fleet({"family": "bounded"}, 4, 1, "cpu", tmp_path)
    sol_x = torch.zeros(4, fleet.nV, dtype=torch.float64)
    y = torch.zeros(4, fleet.nC + 2 * fleet.nComp, dtype=torch.float64)
    ret = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match=field):
        reference.check_call(fleet, fleet.g(1), sol_x, y, ret,
                             {"stationarity_tolerance": 1.0,
                              "complementarity_tolerance": 1.0,
                              "feasibility_tolerance": 1.0})


def test_families_in_the_repo_give_what_the_loader_asks():
    for path in sorted((ROOT / "benchmark" / "families").glob("*.py")):
        mod = harness.load_file("families", path.stem)
        assert set(mod.FIELDS) <= reference.CHECKED, path
        assert callable(mod.instances) and callable(mod.draw)
