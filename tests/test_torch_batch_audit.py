"""Fleet helpers and the f64 audit of the port (``lcqpow_tpu_torch/batch.py``,
``audit.py``, ``mixed.solve_batch_mixed(chunk=...)``) against the JAX
package and against full-width solves.

Tolerances, and why:

* ``audit_solution``: the same NumPy f64 arithmetic on the same inputs:
  counts and verdicts exact, ``max_phi``/``max_violation`` to 1e-15
  absolute.
* Chunked against full width, ``perturb_step=False``: each lane's
  arithmetic does not depend on the lanes beside it (per-matrix batched
  products, per-lane masks), so ``ret`` is exact and x agrees to 1e-12.
* Chunked against full width with the perturbation on: the root key is
  split over the whole fleet before chunking, so every lane draws what it
  draws at full width, and on the CPU the solves are equal bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lcqpow_tpu as jl
from lcqpow_tpu.audit import audit_solution as j_audit

import lcqpow_tpu_torch as lt
from lcqpow_tpu_torch import batch as pbatch
from lcqpow_tpu_torch import mixed as pmixed
from lcqpow_tpu_torch.problems import (circle_fleet, random_lcqp, warm_up,
                                       warmup_fleet)
from lcqpow_tpu_torch.stats import Stats

FIELDS = [f.name for f in dataclasses.fields(jl.LCQPData)]
OPTS = lt.Options(print_level=lt.PrintLevel.NONE, max_iterations=200,
                  perturb_step=False)


def _jax_view(data, sol):
    """The port's data and solution as the JAX package's types hold them
    (NumPy arrays), for the JAX audit."""
    jd = jl.LCQPData(**{f: jnp.asarray(getattr(data, f).numpy())
                        for f in FIELDS})
    js = dataclasses.make_dataclass("S", ["x", "ret"])(
        x=sol.x.numpy(), ret=sol.ret.numpy())
    return jd, js


@pytest.mark.parametrize("spoil", [False, True], ids=["solved", "spoiled"])
def test_audit_matches_jax(spoil):
    data = warmup_fleet(16, device="cpu")
    sol = lt.solve_batch_mixed(data, OPTS, n_corrector_iters=6)
    if spoil:
        # An uncertified lane is left out; a moved certified lane shows
        # its complementarity product and violation.
        x = sol.x.clone()
        x[3] += 1e-3
        ret = sol.ret.clone()
        ret[5] = int(lt.ReturnValue.MAX_ITERATIONS_REACHED)
        sol = dataclasses.replace(sol, x=x, ret=ret)
    p = lt.audit_solution(data, sol, OPTS)
    j = j_audit(*_jax_view(data, sol), jl.Options())
    assert (p["audited"], p["total"], p["phi_ok"]) \
        == (j["audited"], j["total"], j["phi_ok"])
    assert p["audited"] == (15 if spoil else 16)
    assert abs(p["max_phi"] - j["max_phi"]) <= 1e-15
    assert abs(p["max_violation"] - j["max_violation"]) <= 1e-15
    if not spoil:
        assert p["phi_ok"] and p["max_violation"] <= 1e-9
    # One unbatched lane.
    one = sol.map(lambda a: a[0])
    d0 = data.map(lambda a: a[0])
    p1 = lt.audit_solution(d0, one, OPTS)
    j1 = j_audit(*_jax_view(d0, one), jl.Options())
    assert p1 == pytest.approx(j1, abs=1e-15)


def test_chunked_call_pads_with_leading_lanes_and_trims():
    seen = []

    def fn(x, d):
        seen.append(x[:, 0].tolist())
        n = x.shape[0]
        z = torch.zeros(n, dtype=torch.int32)
        return lt.Solution(x=x * 2, y=d.g, ret=z, algo_status=z,
                           stats=Stats(*(z,) * 5, x[:, 0]))

    x = torch.arange(6, dtype=torch.float64)[:, None].repeat(1, 3)
    data = warmup_fleet(6, device="cpu")
    out = pbatch.chunked_call(fn, (x, data), 6, 4)
    assert seen == [[0, 1, 2, 3], [4, 5, 0, 1]]
    assert torch.equal(out.x, 2 * x)
    assert torch.equal(out.y, data.g)
    assert out.stats.qp_exit_flag.tolist() == list(range(6))


def _same(a, b, atol=1e-12):
    assert np.array_equal(a.ret.numpy(), b.ret.numpy())
    np.testing.assert_allclose(a.x.numpy(), b.x.numpy(), rtol=0, atol=atol)
    assert np.array_equal(a.stats.iter_total.numpy(),
                          b.stats.iter_total.numpy())


def test_solve_batch_chunked_equals_full_width():
    data = warmup_fleet(10, device="cpu")
    full = lt.solve_batch(data, OPTS)
    chunked = lt.solve_batch(data, OPTS, chunk=4)
    assert (full.ret.numpy() == 0).all()
    _same(chunked, full)


def test_solve_batch_mixed_chunked_equals_full_width():
    data = warmup_fleet(10, device="cpu")
    full = lt.solve_batch_mixed(data, OPTS, n_corrector_iters=6, chunk=0)
    chunked = lt.solve_batch_mixed(data, OPTS, n_corrector_iters=6, chunk=4)
    assert int((full.ret == 0).sum()) == 10
    _same(chunked, full)
    assert np.array_equal(chunked.stats.certified_stage.numpy(),
                          full.stats.certified_stage.numpy())


def test_chunked_escalation_equals_full_width():
    # A zero corrector budget certifies nothing in the first pass: every
    # lane is retried (at chunk width min(4, 8) = 4 when chunked).
    data = warmup_fleet(6, device="cpu")
    full = lt.solve_batch_mixed(data, OPTS, n_corrector_iters=0, chunk=0)
    chunked = lt.solve_batch_mixed(data, OPTS, n_corrector_iters=0, chunk=4)
    assert (full.stats.certified_stage.numpy() == 3).all()
    _same(chunked, full)
    assert np.array_equal(chunked.stats.certified_stage.numpy(),
                          full.stats.certified_stage.numpy())


@pytest.mark.parametrize("path", ["solve_batch", "solve_batch_mixed",
                                  "escalation"])
def test_perturbed_chunked_equals_full_width_bitwise(path):
    opts = OPTS.replace(perturb_step=True)
    data = warmup_fleet(10, device="cpu")
    if path == "solve_batch":
        full = lt.solve_batch(data, opts)
        chunked = lt.solve_batch(data, opts, chunk=4)
    else:
        # A zero corrector budget sends every lane through escalation.
        kw = dict(n_corrector_iters=0 if path == "escalation" else 6)
        full = lt.solve_batch_mixed(data, opts, chunk=0, **kw)
        chunked = lt.solve_batch_mixed(data, opts, chunk=4, **kw)
        assert torch.equal(chunked.stats.certified_stage,
                           full.stats.certified_stage)
        assert (full.stats.certified_stage == 3).all() \
            == (path == "escalation")
    assert (full.ret == 0).all()
    for a, b in ((chunked.x, full.x), (chunked.y, full.y),
                 (chunked.ret, full.ret),
                 (chunked.stats.iter_total, full.stats.iter_total)):
        assert torch.equal(a, b)


def test_auto_chunk_rule():
    # bench.py's circle row (B = 128, m = 503) chunks to 32; the warm-up
    # shape (m = 14) never chunks, up to the scaling row's B = 16384.
    data, _ = circle_fleet(2, device="cpu")
    m = data.nC + 2 * data.nComp + data.nV
    assert m == 503
    assert pmixed.auto_chunk(128, m) == 32
    assert pmixed.auto_chunk(16384, 14) is None
    assert pmixed.auto_chunk(32, m) is None
    assert pmixed.auto_chunk(128, 1000) == 4


def test_circle_fleet_is_the_bench_fleet():
    # bench.py:139-154: per-lane targets from default_rng(1), lifted x0.
    data, x0 = circle_fleet(5, device="cpu")
    rng = np.random.default_rng(1)
    refs = np.array([0.5, -0.6]) + 0.05 * rng.normal(size=(5, 2))
    W = np.array([[17., -15.], [-15., 17.]])
    np.testing.assert_array_equal(data.g[:, :2].numpy(), -(refs @ W.T))
    np.testing.assert_array_equal(x0[:, :2].numpy(), refs)
    assert (x0[:, 2:].numpy() == 1.0).all() and (data.g[:, 2:] == 0).all()
    assert tuple(data.A.shape) == (5, 101, 202)


def test_solve_many_pads_and_matches_single_solves():
    problems = [warm_up(device="cpu"),
                random_lcqp(3, nV=4, nC=1, nComp=1, device="cpu")]
    sol = pbatch.solve_many(problems, OPTS)
    assert tuple(sol.x.shape) == (2, 4)
    for i, p in enumerate(problems):
        one = lt.solve(p, OPTS)
        assert int(sol.ret[i]) == int(one.ret) == 0
        np.testing.assert_allclose(sol.x[i, :p.nV].numpy(), one.x.numpy(),
                                   rtol=0, atol=1e-9)
