"""The port's ``parallel`` package on the CPU: ``fleet_summary`` against the
JAX package's on the same solution, the sharded solve over CPU "devices"
against ``solve_batch``, and one two-process run on a gloo process group
(``distributed.initialize``, ``host_local_batch_to_global``, the
cross-rank ``fleet_summary``, the mixed pipeline's "schur" pin and its
per-rank escalation).

Tolerances: the summaries are equal dicts (the same lanes in, the same
counts out; the means in float32 as the JAX package takes them); sharded
and per-rank solves are bit for bit ``solve_batch``'s, with
``perturb_step=False`` where the slices would draw differently.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
import time

import jax.numpy as jnp
import pytest
import torch

import lcqpow_tpu as jl
from lcqpow_tpu.parallel import fleet_summary as j_fleet_summary

import lcqpow_tpu_torch as pl_
from lcqpow_tpu_torch.parallel import (fleet_summary, make_mesh, shard_batch,
                                       solve_batch_sharded)
from lcqpow_tpu_torch.problems import warmup_fleet

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPTS = pl_.Options(print_level=pl_.PrintLevel.NONE, max_iterations=200)


@pytest.fixture(scope="module")
def mixed16():
    return pl_.solve_batch_mixed(warmup_fleet(16, device="cpu"), OPTS,
                                 n_corrector_iters=6, escalate=1)


def _as_jax(sol):
    """The JAX package's Solution holding the same per-lane values."""
    a = lambda t: None if t is None else jnp.asarray(t.numpy())
    st = sol.stats
    return jl.Solution(
        x=a(sol.x), y=a(sol.y), ret=a(sol.ret), algo_status=a(sol.algo_status),
        stats=jl.Stats(iter_total=a(st.iter_total), iter_outer=a(st.iter_outer),
                       subproblem_iter=a(st.subproblem_iter),
                       rho_opt=a(st.rho_opt),
                       solution_status=a(st.solution_status),
                       qp_exit_flag=a(st.qp_exit_flag),
                       corrector_steps=a(st.corrector_steps),
                       certified_stage=a(st.certified_stage)))


def test_fleet_summary_matches_jax(mixed16):
    got = fleet_summary(mixed16)
    assert got == j_fleet_summary(_as_jax(mixed16))
    assert got["solved"] == got["total"] == 16
    assert sum(got["certified_by_stage"].values()) == 16


def test_fleet_summary_stage_buckets_match_jax(mixed16):
    # Stages past the 16 buckets share the last one ("15+"), and a plain
    # solve has no stage entries.
    import dataclasses

    stage = torch.tensor([0, 1, 2, 3, 14, 15, 16, 40] * 2, dtype=torch.int32)
    sol = dataclasses.replace(mixed16, stats=dataclasses.replace(
        mixed16.stats, certified_stage=stage))
    got = fleet_summary(sol)
    assert got == j_fleet_summary(_as_jax(sol))
    assert got["certified_by_stage"]["15+"] == 6
    plain = dataclasses.replace(sol, stats=dataclasses.replace(
        sol.stats, certified_stage=None, corrector_steps=None))
    assert fleet_summary(plain) == j_fleet_summary(_as_jax(plain))
    assert "certified_by_stage" not in fleet_summary(plain)


def test_shard_batch_splits_lanes_in_order():
    data = warmup_fleet(5, device="cpu")
    parts = shard_batch(data, make_mesh(["cpu", "cpu"]))
    assert [p.Q.shape[0] for p in parts] == [3, 2]
    assert torch.equal(torch.cat([p.g for p in parts]), data.g)
    assert shard_batch(None, make_mesh(["cpu"] * 3)) == [None] * 3


@pytest.mark.parametrize("devices,perturb", [(1, True), (2, False)],
                         ids=["one_device", "two_devices"])
def test_solve_batch_sharded_equals_solve_batch(devices, perturb):
    opts = OPTS.replace(perturb_step=perturb)
    data = warmup_fleet(16, device="cpu")
    x0 = 0.1 * torch.ones(16, 8, dtype=torch.float64)
    got = solve_batch_sharded(data, opts, mesh=make_mesh(["cpu"] * devices),
                              x0=x0)
    want = pl_.solve_batch(data, opts, x0=x0)
    for a, b in ((got.x, want.x), (got.y, want.y), (got.ret, want.ret),
                 (got.stats.iter_total, want.stats.iter_total),
                 (got.stats.rho_opt, want.stats.rho_opt)):
        assert torch.equal(a, b)


_WORKER = textwrap.dedent(r"""
    import json, sys
    rank, port = int(sys.argv[1]), sys.argv[2]
    import torch
    import lcqpow_tpu_torch as lt
    from lcqpow_tpu_torch import mixed
    from lcqpow_tpu_torch.data import pad_lcqp
    from lcqpow_tpu_torch.parallel import (fleet_summary, make_mesh,
                                           solve_batch_sharded)
    from lcqpow_tpu_torch.parallel.distributed import (
        host_local_batch_to_global, initialize)
    from lcqpow_tpu_torch.problems import (optimize_on_circle, random_lcqp,
                                           warm_up)

    assert initialize(f"tcp://localhost:{port}", world_size=2, rank=rank,
                      device="cpu")
    assert initialize() is True          # idempotent
    # Rank 0 holds warm-ups, rank 1 random instances of the warm-up's shape.
    if rank == 0:
        probs = [warm_up(device="cpu") for _ in range(2)]
    else:
        probs = [random_lcqp(500 + i, nV=2, nC=0, nComp=1, device="cpu")
                 for i in range(2)]
    local = lt.stack_lcqps([pad_lcqp(p, 2, 0, 1) for p in probs])
    opts = lt.Options(print_level=lt.PrintLevel.NONE, max_iterations=100)
    hb = host_local_batch_to_global(local, device="cpu")
    sol = solve_batch_sharded(hb, opts, mesh=make_mesh(["cpu"]))
    ref = lt.solve_batch(local, opts)
    same = all(torch.equal(a, b) for a, b in (
        (sol.x, ref.x), (sol.y, ref.y), (sol.ret, ref.ret),
        (sol.stats.iter_total, ref.stats.iter_total)))
    msol = lt.solve_batch_mixed(local, opts, n_corrector_iters=0, escalate=1)
    circle, _ = optimize_on_circle(20, device="cpu")
    print(json.dumps({
        "rank": rank, "offset": hb.offset, "total": hb.total, "same": same,
        "summary": fleet_summary(sol), "mixed": fleet_summary(msol),
        "kkt_form": mixed._resolve_kkt_form(circle, opts).admm.kkt_form}))
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_gloo_run():
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), port],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    outs = []
    deadline = time.monotonic() + 120        # for the whole run
    try:
        for p in procs:
            out, err = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rc, out, err in outs:
        assert rc == 0, f"worker failed:\n{out}\n{err}"
    res = sorted((json.loads(o.strip().splitlines()[-1]) for _, o, _ in outs),
                 key=lambda r: r["rank"])
    assert [r["offset"] for r in res] == [0, 2]
    for r in res:
        assert r["total"] == 4 and r["same"], r
        assert r["summary"]["total"] == r["summary"]["solved"] == 4, r
        # A zero corrector budget sends every lane through escalation on
        # its own rank; the summary adds both ranks' lanes.
        assert r["mixed"]["total"] == 4, r
        assert sum(r["mixed"]["certified_by_stage"].values()) == 4, r
        assert r["kkt_form"] == "schur", r
    assert res[0]["summary"] == res[1]["summary"]
    # One process resolves the same circle to the range form.
    from lcqpow_tpu_torch import mixed
    from lcqpow_tpu_torch.problems import optimize_on_circle

    circle, _ = optimize_on_circle(20, device="cpu")
    assert mixed._resolve_kkt_form(circle, OPTS).admm.kkt_form == "range"
