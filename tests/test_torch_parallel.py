"""The port's ``parallel`` package on the CPU: ``fleet_summary`` against the
JAX package's on the same solution, the sharded solve over CPU "devices"
(its worker threads, one per slice, against ``solve_batch`` of each slice,
and a worker's exception reaching the caller), the kernel's launch counts
under threads, one two-process run on a gloo process group
(``distributed.initialize``, ``host_local_batch_to_global``, the
cross-rank ``fleet_summary``, the mixed pipeline's "schur" pin and its
per-rank escalation), and the group's teardown at exit and by
``distributed.shutdown``.

Tolerances: the summaries are equal dicts (the same lanes in, the same
counts out; the means in float32 as the JAX package takes them); sharded
and per-rank solves split the root key over the whole fleet, so they are
bit for bit the solve of the same lanes with the fleet's keys, and the
whole fleet's ``solve_batch``, with the perturbation on or off.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
import threading
import time

import jax.numpy as jnp
import pytest
import torch

import lcqpow_tpu as jl
from lcqpow_tpu.parallel import fleet_summary as j_fleet_summary

import lcqpow_tpu_torch as pl_
from lcqpow_tpu_torch import prng
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


# One device: solve_batch itself, no thread.  Two and four CPU "devices":
# the slices in concurrent worker threads, each bit for bit the solve of
# its lanes with their keys of the fleet's split, and the whole fleet's
# solve too (the keys are the full width's, and the CPU sums a slice as the
# full width).
@pytest.mark.parametrize("devices,perturb,lanes",
                         [(1, True, 16), (2, False, 16), (4, True, 8)],
                         ids=["one_device", "two_devices",
                              "four_devices_threaded"])
def test_solve_batch_sharded_equals_solve_batch(devices, perturb, lanes):
    opts = OPTS.replace(perturb_step=perturb)
    data = warmup_fleet(lanes, device="cpu")
    x0 = 0.1 * torch.ones(lanes, 8, dtype=torch.float64)
    mesh = make_mesh(["cpu"] * devices)
    key = prng.prng_key(11)
    got = solve_batch_sharded(data, opts, mesh=mesh, x0=x0, key=key)
    keys = prng.split(key, lanes)
    parts = [pl_.solve(d, opts, x0=x, key=k) for d, x, k in
             zip(shard_batch(data, mesh), shard_batch(x0, mesh),
                 shard_batch(keys, mesh))]
    wants = [parts[0].map(lambda *xs: torch.cat(xs), *parts[1:]),
             pl_.solve_batch(data, opts, x0=x0, key=key)]
    for want in wants:
        for a, b in ((got.x, want.x), (got.y, want.y), (got.ret, want.ret),
                     (got.stats.iter_total, want.stats.iter_total),
                     (got.stats.rho_opt, want.stats.rho_opt)):
            assert torch.equal(a, b)


def test_solve_batch_sharded_raises_a_workers_exception(monkeypatch):
    # The slice of 2 lanes fails at once; the others start their solves
    # after it has failed (waiting outside the workers' baton), and the
    # caller sees the failure only after every worker has ended.
    from lcqpow_tpu_torch.parallel import sharding

    real = sharding._solve_slice
    failed = threading.Event()
    ended = []

    def solve_slice(dev, stream, baton, data, *args):
        if data.Q.shape[0] == 2:
            failed.set()
            raise FloatingPointError("slice failed")
        assert failed.wait(30)
        sol = real(dev, stream, baton, data, *args)
        ended.append(data.Q.shape[0])
        return sol

    monkeypatch.setattr(sharding, "_solve_slice", solve_slice)
    before = set(threading.enumerate())
    with pytest.raises(FloatingPointError, match="slice failed"):
        solve_batch_sharded(warmup_fleet(11, device="cpu"), OPTS,
                            mesh=make_mesh(["cpu"] * 4))
    assert sorted(ended) == [3, 3, 3]
    assert set(threading.enumerate()) <= before


@pytest.mark.parametrize("hold_s,handed_over", [(0.0, True), (60.0, False)],
                         ids=["every_sync", "within_slice"])
def test_baton_is_handed_over_at_host_syncs(hold_s, handed_over):
    # A host sync (_sync.any_) runs its wait without the baton once the
    # thread has held it for its time slice, and takes it back before it
    # returns; outside a baton it leaves the lock alone.
    from lcqpow_tpu_torch import _sync

    baton = _sync.Baton(hold_s)
    seen = []

    class Flag:
        def __bool__(self):
            seen.append(baton.lock.locked())
            return True

    class Synced:
        def any(self):
            return Flag()

    with baton.held():
        assert baton.lock.locked()
        assert _sync.any_(Synced())
        assert baton.lock.locked()
    assert not baton.lock.locked()
    assert _sync.any_(Synced())
    assert seen == [not handed_over, False]
    assert _sync.any_(torch.tensor([False, True]))
    assert not _sync.any_(torch.zeros(3, dtype=torch.bool))
    assert _sync.Baton().hold_s == sys.getswitchinterval()


def test_gj_launch_counts_keep_every_threaded_update():
    # Eight threads count launches at a switch interval short enough that
    # an unlocked read-modify-write loses updates.
    from lcqpow_tpu_torch.ops import gj_inverse as gj

    saved = (gj.launch_count, dict(gj.launch_counts),
             dict(gj.launch_shapes))
    interval = sys.getswitchinterval()
    gj.launch_count = 0
    gj.launch_counts.clear()
    gj.launch_shapes.clear()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda m=m: [
            gj._count_launch(m % 2 + 4, m % 3 + 1) for _ in range(4000)])
            for m in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        assert gj.launch_count == 32000
        assert gj.launch_counts == {1: 12000, 2: 12000, 3: 8000}
        assert gj.launch_shapes == {(4, 1): 8000, (5, 2): 8000,
                                    (4, 3): 4000, (5, 1): 4000,
                                    (4, 2): 4000, (5, 3): 4000}
    finally:
        sys.setswitchinterval(interval)
        gj.launch_count = saved[0]
        for now, then in zip((gj.launch_counts, gj.launch_shapes),
                             saved[1:]):
            now.clear()
            now.update(then)


_WORKER = textwrap.dedent(r"""
    import json, sys
    rank, port = int(sys.argv[1]), sys.argv[2]
    import torch
    import lcqpow_tpu_torch as lt
    from lcqpow_tpu_torch import mixed, prng
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
    # The rank's lanes draw from their keys of the whole fleet's split.
    keys = prng.split(prng.prng_key(opts.seed), hb.total)
    ref = lt.solve(local, opts, key=keys[hb.offset:hb.offset + 2])
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


_TEARDOWN_WORKER = textwrap.dedent(r"""
    import atexit, json, sys
    rank, port = int(sys.argv[1]), sys.argv[2]
    import torch
    import torch.distributed as dist
    from lcqpow_tpu_torch.parallel import distributed

    # Registered before initialize, so it runs after the teardown that
    # initialize registers (atexit runs last-in, first-out).
    atexit.register(lambda: print(json.dumps(
        {"rank": rank, "at_exit_initialized": dist.is_initialized()}),
        flush=True))
    assert distributed.initialize(f"tcp://localhost:{port}", world_size=2,
                                  rank=rank, device="cpu")
    t = torch.tensor([rank + 1.0])
    dist.all_reduce(t)
    assert float(t) == 3.0
    if rank == 0:
        distributed.shutdown()
        assert not dist.is_initialized()
        distributed.shutdown()               # a no-op without a group
    # Rank 1 exits straight after the all_reduce.
""")


def test_gloo_group_is_torn_down_at_exit_and_by_shutdown():
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, "-c", _TEARDOWN_WORKER,
                               str(r), port], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for r in range(2)]
    outs = []
    deadline = time.monotonic() + 60
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
        assert rc == 0 and "terminate called" not in err, \
            f"rank failed:\n{out}\n{err}"
    res = [json.loads(o.strip().splitlines()[-1]) for _, o, _ in outs]
    assert res == [{"rank": r, "at_exit_initialized": False}
                   for r in range(2)]
