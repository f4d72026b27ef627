"""No module a run loads is JAX or the JAX package (top-level names
compared whole), and the reference loads nothing of the program."""

import json
import subprocess
import sys
import types

import pytest

from benchmark import harness

from conftest import ROOT

CHECK = """
import json, sys, time
sys.path.insert(0, {root!r})
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def loaded(body: str) -> set:
    p = subprocess.run([sys.executable, "-c",
                        CHECK.format(root=str(ROOT), body=body)],
                       capture_output=True, text=True, timeout=600,
                       env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    assert p.returncode == 0, p.stderr[-3000:]
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_reference_and_generator_load_nothing_of_the_program():
    mods = loaded("import benchmark.reference, benchmark.fleet, "
                  "benchmark.devtrace, benchmark.roofline\n"
                  "for p in (benchmark.fleet.BENCH_DIR / 'families')"
                  ".glob('*.py'):\n"
                  "    benchmark.fleet.load_file('families', p.stem)")
    assert not mods & {"lcqpow_tpu_torch", "lcqpow_tpu", "jax", "jaxlib",
                       "flax"}


def test_a_whole_run_loads_no_jax(tiny_spec):
    spec, bench = tiny_spec
    mods = loaded(
        "from pathlib import Path\n"
        "from benchmark import harness\n"
        f"r = harness.run(Path({str(spec)!r}), 'warmup-sweep', 1, 0.0, "
        f"True, 'cpu', time.perf_counter(), bench_dir=Path({str(bench)!r}))\n"
        "assert r['correct'] and not harness.forbidden_modules()")
    assert "lcqpow_tpu_torch" in mods
    assert not mods & harness.FORBIDDEN


@pytest.mark.parametrize("name,bad", [("lcqpow_tpu_torch.mixed", False),
                                      ("lcqpow_tpu.mixed", True),
                                      ("lcqpow_tpu", True),
                                      ("jax", True), ("jaxlib.xla", True),
                                      ("flax.linen", True),
                                      ("jaxtyping", False)])
def test_forbidden_names_are_compared_whole(monkeypatch, name, bad):
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert (name in harness.forbidden_modules()) == bad
