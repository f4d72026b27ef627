"""The benchmark's own tests: CPU, tiny fleets; those marked ``gpu`` run
on the card (``python3 -m pytest benchmark/tests -m gpu``)."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: Lanes of a call in the CPU tests.
TINY = 64


@pytest.fixture
def tiny_spec(tmp_path):
    """A copy of the spec and of the harness's data files under
    ``tmp_path``, every cell sent a ``TINY``-lane mix; returns
    (spec path, bench dir)."""
    bench = tmp_path / "bench"
    shutil.copytree(ROOT / "benchmark" / "configs", bench / "configs")
    shutil.copytree(ROOT / "benchmark" / "metrics", bench / "metrics")
    shutil.copytree(ROOT / "benchmark" / "families", bench / "families",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (bench / "traffic").mkdir()
    (bench / "traffic" / "tiny.json").write_text(json.dumps(
        {"name": "tiny", "lanes_per_call": TINY, "loop": "closed",
         "callers": 1, "why": "CPU test"}))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        c["file"] = "bench/configs/" + Path(c["file"]).name
    for w in spec["workloads"]:
        w["traffic"] = "tiny"
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(spec))
    return path, bench
