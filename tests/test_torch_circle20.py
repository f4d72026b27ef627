"""The circle-N20 fleet that ``chip_smoke.py`` drives on the card
(``circle-N20-512``) against the JAX package on the CPU.

The fleet is the JAX package's benchmark circle construction
(``bench.py:139-154``) at N = 20 (nV = 42: the predictor's f32 inverses are
the GJ kernel's order 42), solved by ``solve_batch_mixed`` with the
circle's options (stationarity 1e-2, ``OSQP_SPARSE``, the lifted start),
``escalate=3``, on bench.py's root key ``PRNGKey(1)``.

Tolerances, and why: the f32 predictor differs from XLA:CPU's in summation
order, in its inverse and in XLA's contraction of products into fused
multiply-adds (ROADMAP C-7), so the homotopy's path may differ in the last
f32 bits while both draw the same perturbation bits.  Every lane must end
with the same return code.  Where the two runs take the same number of
passes within one, they end on the same vertex and the certified points
agree to 1e-6 (measured 1.2e-7).  The lanes where the jitted, vmapped JAX
function takes more passes are named in ``APART``, with the vertex each
ends on (one lands on another vertex of the circle's discretization); on
each of them the JAX function run without vmap, jitted or eagerly (no
fusion at all), ends where the port does.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import lcqpow_tpu as jl
from lcqpow_tpu.problems import optimize_on_circle as j_circle

import lcqpow_tpu_torch as pl_
from lcqpow_tpu_torch import convert, prng
from lcqpow_tpu_torch.problems import circle_fleet

N = 20
KEY = 1
# Lanes on which the jitted, vmapped JAX function takes more than one pass
# more or fewer than the port, by fleet width, and whether it ends on the
# port's vertex.  B = 8: lane 4 takes 20 passes against the port's 18 and
# ends on the same vertex (1.1e-7 apart); lane 6 takes 31 passes against
# 16 and certifies x[:2] = (0.11742, -1.0) against the port's (0.15838,
# -1.0).  On either lane alone the same JAX function, jitted (18 and 16
# passes) or eagerly (19 and 17), ends where the port does: the difference
# is XLA:CPU's fusion of the batched program (ROADMAP C-7), not the port.
APART = {2: {}, 8: {4: "same vertex", 6: "other vertex"}}
FLEET_X01 = {4: [0.20631467, -0.98442652], 6: [0.15838444, -1.0]}


def _jax_fleet(B):
    """bench.py's ``make_circle_batch`` at N = 20, in NumPy."""
    rng = np.random.default_rng(1)
    data, x0 = j_circle(N, as_numpy=True)
    W = np.array([[17., -15.], [-15., 17.]])
    refs = np.array([0.5, -0.6]) + 0.05 * rng.normal(size=(B, 2))
    g = np.tile(np.asarray(data.g), (B, 1))
    g[:, :2] = -(refs @ W.T)
    batch = jax.tree.map(lambda x: np.tile(x, (B,) + (1,) * x.ndim), data)
    batch = dataclasses.replace(batch, g=g)
    x0b = np.tile(np.asarray(x0), (B, 1))
    x0b[:, :2] = refs
    return batch, x0b


def _opts():
    j = jl.Options(print_level=jl.PrintLevel.NONE, max_iterations=200,
                   stationarity_tolerance=1e-2,
                   qp_solver=jl.QPSolver.OSQP_SPARSE)
    return j, convert.options_from_dict(dataclasses.asdict(j))


@functools.cache
def _port(B):
    pd, px0 = circle_fleet(B, device="cpu", N=N)
    return pl_.solve_batch_mixed(pd, _opts()[1], x0=px0,
                                 key=prng.prng_key(KEY), escalate=3)


def _runs(B):
    """(jitted, vmapped JAX solve_batch_mixed, the port's) of the fleet."""
    jb, x0b = _jax_fleet(B)
    j = jl.solve_batch_mixed(jax.tree.map(jnp.asarray, jb), _opts()[0],
                             x0=jnp.asarray(x0b),
                             key=jax.random.PRNGKey(KEY), escalate=3)
    return jax.tree.map(np.asarray, j), _port(B)


def test_circle_fleet_is_the_benchmark_construction():
    jb, x0b = _jax_fleet(3)
    pd, px0 = circle_fleet(3, device="cpu", N=N)
    assert (pd.nV, pd.nC, pd.nComp) == (42, 21, 20)
    for name in ("Q", "g", "L", "R", "A", "lbA", "ubA"):
        np.testing.assert_array_equal(getattr(pd, name).numpy(),
                                      np.asarray(getattr(jb, name)))
    np.testing.assert_array_equal(px0.numpy(), x0b)


@pytest.mark.parametrize("B", [2, pytest.param(8, marks=pytest.mark.slow)])
def test_circle20_fleet_matches_jax(B):
    j, p = _runs(B)
    assert np.array_equal(p.ret.numpy(), j.ret)
    assert (j.ret == 0).all()
    close = np.abs(p.stats.iter_total.numpy() - j.stats.iter_total) <= 1
    assert set(np.flatnonzero(~close)) == set(APART[B])
    dx = np.abs(p.x.numpy() - j.x).max(axis=1)
    same = close.copy()
    for lane, where in APART[B].items():
        same[lane] = where == "same vertex"
    assert (dx[same] <= 1e-6).all(), dx
    # Another vertex of the discretization: some x entry 1.0 apart.
    assert (dx[~same] > 0.5).all(), dx


def _lane(B, i):
    jb, x0b = _jax_fleet(B)
    d = jax.tree.map(lambda a: jnp.asarray(a[i]), jb)
    key = jax.random.split(jax.random.PRNGKey(KEY), B)[i]
    return d, jnp.asarray(x0b[i]), key


def _solve_lane(d, x0, key):
    return jl.solve_mixed(d, _opts()[0], x0=x0, key=key)


_solve_lane_jit = jax.jit(_solve_lane)


@pytest.mark.parametrize("lane,eager", [
    (4, False), (6, False),
    pytest.param(4, True, marks=pytest.mark.slow),
    pytest.param(6, True, marks=pytest.mark.slow)])
def test_circle20_apart_lane_ends_where_unbatched_jax_does(lane, eager):
    # B = 8 (APART): the JAX function on the lane alone, not vmapped,
    # jitted or (slow: ~40 s a lane) eagerly, op by op with no fusion.
    d, x0, key = _lane(8, lane)
    if eager:
        with jax.disable_jit():
            j = _solve_lane(d, x0, key)
    else:
        j = _solve_lane_jit(d, x0, key)
    p = _port(8)
    assert int(j.ret) == int(p.ret[lane]) == 0
    assert abs(int(j.stats.iter_total) - int(p.stats.iter_total[lane])) <= 1
    np.testing.assert_allclose(p.x[lane].numpy(), np.asarray(j.x), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(p.x[lane, :2].numpy(), FLEET_X01[lane],
                               atol=1e-6)
