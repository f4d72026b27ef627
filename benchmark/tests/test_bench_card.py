"""On the card: each cell of the spec through ``run.py``, untraced and
traced, at a short window (``python3 -m pytest benchmark/tests -m gpu``)."""

import json
import subprocess
import sys

import pytest
import torch

from conftest import ROOT

CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_correct_on_the_card(workload, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        workload, "--seed", str(2 ** 31 + 11), "--seconds",
                        "1", "--trace", str(trace)], cwd=ROOT,
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"


@pytest.mark.gpu
def test_a_span_of_the_program_is_no_kernel_on_the_card():
    """A ``record_function`` of any name around launches, as a program's
    own span would be: the trace of the card counts its kernels once and
    the span's mirror on the card's timeline not at all."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from benchmark import devtrace

    dev = torch.device("cuda:0")
    a = torch.ones(1 << 22, device=dev)
    torch.cuda.synchronize(dev)
    # Many spans, so that a mirror whose id equals a launch's turns up.
    with devtrace.profiled(dev) as prof:
        with torch.profiler.record_function(devtrace.CALL_RANGE):
            for i in range(300):
                with torch.profiler.record_function(f"lcqpow::span{i % 7}"):
                    a = a * 1.5 + 1.0
            torch.cuda.synchronize(dev)
    t = devtrace.Trace.from_events(prof.events)
    assert t.kernels_in_window() == 600
    assert not any(n.startswith("lcqpow::") for n in t.kernel_name)
    assert 0 < t.busy_ns() <= t.window_ns()
