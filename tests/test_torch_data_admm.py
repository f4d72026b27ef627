"""Options, problem data, conversion and the ADMM engine's factorization and
polish solve: the port against the JAX package on NumPy-made inputs."""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lcqpow_tpu as jl
from lcqpow_tpu import solver as jsolver
from lcqpow_tpu.problems import random_lcqp as j_random_lcqp
from lcqpow_tpu.solvers import admm as jadmm

import lcqpow_tpu_torch as pl_
from lcqpow_tpu_torch import _config, convert
from lcqpow_tpu_torch import solver as psolver
from lcqpow_tpu_torch.problems import random_lcqp as p_random_lcqp
from lcqpow_tpu_torch.problems import warmup_fleet
from lcqpow_tpu_torch.solvers import admm as padmm

FIELDS = [f.name for f in dataclasses.fields(jl.LCQPData)]


def _asdict(o):
    return dataclasses.asdict(o)


def test_config_pins_precision_and_device_policy():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
    assert _config.default_dtype() == torch.float64
    assert _config.default_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert _config.default_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            _config.default_device()
        with pytest.raises(RuntimeError):
            pl_.make_lcqp([[2.0]], [1.0], [[1.0]], [[1.0]])


def test_enums_value_identical():
    for name in ("ReturnValue", "AlgorithmStatus", "PrintLevel", "QPSolver"):
        j, p = getattr(jl, name), getattr(pl_, name)
        assert [(e.name, int(e)) for e in j] == [(e.name, int(e)) for e in p]
    assert (pl_.EPS, pl_.ZERO, pl_.INFTY) == (jl.EPS, jl.ZERO, jl.INFTY)


def test_option_defaults_identical():
    assert _asdict(pl_.Options()) == _asdict(jl.Options())
    assert _asdict(pl_.ADMMOptions()) == _asdict(jl.ADMMOptions())


@pytest.mark.parametrize("kw", [
    dict(complementarity_tolerance=0.0), dict(stationarity_tolerance=-1.0),
    dict(initial_penalty_parameter=0.0), dict(penalty_update_factor=0.5),
    dict(max_penalty_parameter=-2.0), dict(max_iterations=0),
    dict(eta_dynamic_penalty=1.5), dict(inner_solver="qp"),
    dict(print_level=0, qp_solver=2),
])
def test_option_validation_identical(kw):
    with warnings.catch_warnings(record=True) as wj:
        warnings.simplefilter("always")
        j = jl.Options(**kw)
    with warnings.catch_warnings(record=True) as wp:
        warnings.simplefilter("always")
        p = pl_.Options(**kw)
    assert [str(w.message) for w in wp] == [str(w.message) for w in wj]
    assert _asdict(p) == _asdict(j)
    assert _asdict(p.replace(max_iterations=7)) \
        == _asdict(j.replace(max_iterations=7))


@pytest.mark.parametrize("kw", [
    dict(rho=-1.0), dict(sigma=0.0), dict(alpha=2.5), dict(max_iter=0),
    dict(polish_drop_rule="all"), dict(kkt_form="lu"),
])
def test_admm_option_validation_identical(kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        j, p = jl.ADMMOptions(**kw), pl_.ADMMOptions(**kw)
    assert _asdict(p) == _asdict(j)


def test_options_from_dict_carries_jax_options():
    j = jl.Options(max_iterations=200, perturb_step=False,
                   print_level=jl.PrintLevel.NONE,
                   qp_solver=jl.QPSolver.OSQP_SPARSE,
                   admm=jl.ADMMOptions(rho=0.5, polish_drop_rule="murty"))
    p = convert.options_from_dict(_asdict(j))
    assert isinstance(p.print_level, pl_.PrintLevel)
    assert isinstance(p.admm, pl_.ADMMOptions)
    assert _asdict(p) == _asdict(j)


def _problem_args(seed):
    rng = np.random.default_rng(seed)
    nV, nC, nK = 5, 2, 2
    return dict(Q=np.eye(nV) * 2 + 0.1, g=rng.normal(size=nV),
                L=rng.normal(size=(nK, nV)), R=rng.normal(size=(nK, nV)),
                lbL=[0.5, 0.0], lbR=[0.0, -0.3], ubR=[np.inf, 4.0],
                A=rng.normal(size=(nC, nV)), lbA=[-1.0, -np.inf],
                ubA=[1.0, 2.0], lb=-np.ones(nV) * 3, ub=None)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_make_lcqp_pad_and_stack_match_jax(dtype):
    args = _problem_args(0)
    j = jl.make_lcqp(**args, dtype=getattr(jnp, dtype))
    p = pl_.make_lcqp(**args, dtype=getattr(torch, dtype), device="cpu")
    for f in FIELDS:
        assert np.array_equal(getattr(p, f).numpy(), np.asarray(getattr(j, f))), f
    assert (p.nV, p.nC, p.nComp, p.has_box) == (j.nV, j.nC, j.nComp, j.has_box)
    for prop in ("A_full", "lbA_full", "ubA_full"):
        assert np.array_equal(getattr(p, prop).numpy(),
                              np.asarray(getattr(j, prop)))
    jp, pp = jl.pad_lcqp(j, 7, 3, 4), pl_.pad_lcqp(p, 7, 3, 4)
    js, ps = jl.stack_lcqps([j, j]), pl_.stack_lcqps([p, p])
    for f in FIELDS:
        assert np.array_equal(getattr(ps, f).numpy(), np.asarray(getattr(js, f))), f
        a, b = getattr(pp, f).numpy(), np.asarray(getattr(jp, f))
        if f in ("C", "g_phi", "phi_const"):
            # Re-derived with each library's matmul: summation order only.
            eps = np.finfo(b.dtype).eps
            assert np.abs(a - b).max() <= 8 * eps * (1 + np.abs(b).max()), f
        else:
            assert np.array_equal(a, b), f
    with pytest.raises(pl_.LCQPError) as e:
        pl_.make_lcqp(**dict(args, lbL=[-np.inf, 0.0]), device="cpu")
    assert e.value.code == pl_.ReturnValue.INVALID_LOWER_COMPLEMENTARITY_BOUND


@pytest.mark.parametrize("seed", [0, 7])
def test_random_lcqp_same_instances_and_conversion(seed):
    j = j_random_lcqp(seed, nV=8, nC=2, nComp=2)
    p = p_random_lcqp(seed, nV=8, nC=2, nComp=2, device="cpu")
    c = convert.lcqp_from_numpy({f: np.asarray(getattr(j, f)) for f in FIELDS},
                                "cpu")
    for f in FIELDS:
        assert np.array_equal(getattr(p, f).numpy(), np.asarray(getattr(j, f))), f
        assert torch.equal(getattr(c, f), getattr(p, f)), f
    with pytest.raises(KeyError):
        convert.lcqp_from_numpy({"Q": np.eye(2)}, "cpu")


def _jax_fleet(B):
    """bench.py:121-137, the JAX package's headline fleet generator."""
    rng = np.random.default_rng(0)
    problems = [j_random_lcqp(rng, nV=8, nC=2, nComp=2, as_numpy=True)
                for _ in range(64)]
    base = jax.tree.map(lambda *xs: np.stack(xs), *problems)
    reps = -(-B // 64)
    batch = jax.tree.map(
        lambda x: np.tile(x, (reps,) + (1,) * (x.ndim - 1))[:B], base)
    return dataclasses.replace(batch, g=batch.g + 0.01 * rng.normal(size=(B, 8)))


def test_warmup_fleet_is_the_bench_fleet():
    jb = _jax_fleet(80)
    pb = warmup_fleet(80, device="cpu")
    for f in FIELDS:
        assert np.array_equal(getattr(pb, f).numpy(), np.asarray(getattr(jb, f))), f


# f64: same operations, summation order and 1/sqrt (XLA may use rsqrt)
# differ by an ulp (measured <= 1e-15 relative).  f32: same, in f32
# (measured <= 4.2e-7), and the port inverts with Gauss-Jordan where
# JAX-on-CPU uses the block recursion (both with Newton-Schulz).
TOL = {np.float64: 1e-14, np.float32: 2e-6}


@pytest.fixture(scope="module")
def workspaces():
    jb = _jax_fleet(16)
    fields = {f: np.asarray(getattr(jb, f)) for f in FIELDS}
    opts = jl.Options()
    out = {}
    for dt in (np.float64, np.float32):
        jd = jax.tree.map(lambda a: jnp.asarray(a, dt), jb)
        pd = convert.lcqp_from_numpy({k: v.astype(dt) for k, v in
                                      fields.items()}, "cpu")
        jws = jax.jit(jax.vmap(lambda d: jsolver.build_workspace(d, opts)))(jd)
        pws = psolver.build_workspace(pd, convert.options_from_dict(
            _asdict(opts)))
        out[dt] = (jws, pws, fields["g"].astype(dt))
    return out


def _close(a, b, tol):
    a = np.asarray(a)
    b = b.numpy()
    if a.dtype == bool:
        return np.array_equal(a, b)
    # Scaled +/-INFTY bounds (~1e20) compare to their own magnitude.
    fin = np.abs(a) < 1e19
    if not np.all(np.abs(a - b)[~fin] <= tol * np.abs(a[~fin])):
        return False
    return np.abs(a - b)[fin].max() <= tol * np.abs(a[fin]).max()


@pytest.mark.parametrize("dt", [np.float64, np.float32])
def test_factorize_matches_jax(workspaces, dt):
    jws, pws, _ = workspaces[dt]
    for f in dataclasses.fields(jws):
        assert _close(getattr(jws, f.name), getattr(pws, f.name), TOL[dt]), \
            f.name


@pytest.mark.parametrize("dt", [np.float64, np.float32])
def test_polish_solve_matches_jax(workspaces, dt):
    jws, pws, q = workspaces[dt]
    cfg = jl.ADMMOptions()
    y = np.random.default_rng(1).normal(size=q.shape[:1] + (14,)).astype(dt)
    low = np.asarray(jws.eq_mask) | ((y < 0) & (np.asarray(jws.l) > -1e20))
    up = (y > 0) & (np.asarray(jws.u) < 1e20) & ~low
    jx, jy = jax.jit(jax.vmap(
        lambda w, q, lo, u: jadmm._polish_solve(w, q, lo, u, cfg)))(
        jws, jnp.asarray(q), jnp.asarray(low), jnp.asarray(up))
    px, py = padmm._polish_solve(pws, torch.from_numpy(q),
                                 torch.from_numpy(low), torch.from_numpy(up),
                                 pl_.ADMMOptions())
    assert _close(jx, px, TOL[dt])
    assert _close(jy, py, TOL[dt])


# The main path's polish-first attempt accepts nearly every subproblem, so
# these configurations force the rest of the engine: the ADMM iteration
# loop with its in-iteration polish, plain ADMM, adaptive rho and the other
# active-set drop rules.  The polish seeds its active set from dual signs,
# and an inactive row's ADMM dual is zero only up to rounding, so its sign
# depends on rounding:
# * "jit": plain ADMM has no such ties; the jitted, vmapped JAX function is
#   the reference and iteration counts must be equal.
# * "eager": XLA contracts products into FMAs inside a compiled loop and
#   eager PyTorch never does, so the reference is the JAX function run
#   eagerly lane by lane (``jax.disable_jit``); iteration counts equal.
# * "solution": the murty and single rules drop any row whose multiplier is
#   wrong-signed by any amount, so matmul summation order alone (a dual of
#   0 in one package, -2.8e-18 in the other) can change which check
#   accepts.  Both must reach the same status and the same QP solution
#   (unique: P is positive definite).  A lane may end on ADMM's own
#   convergence test, whose residuals reach 1e-6 + 1e-6 * scale with scales
#   up to ~4 here, and P >= I bounds the point error by the same ~5e-6:
#   the tolerance is 1e-5.
@pytest.mark.parametrize("kw,ref", [
    (dict(), "eager"),
    (dict(polish=False, max_iter=600), "jit"),
    (dict(polish=False, adaptive_rho=True, rho=1e-3, max_iter=600), "jit"),
    (dict(polish_drop_rule="murty", polish_active_set_rounds=1), "solution"),
    (dict(polish_drop_rule="single", polish_active_set_rounds=1), "solution"),
], ids=["polish_first", "plain_admm", "adaptive_rho", "murty", "single"])
def test_admm_solve_matches_jax(workspaces, kw, ref):
    jws, pws, q = workspaces[np.float64]
    cfg = jl.ADMMOptions(**kw)
    rng = np.random.default_rng(4)
    # A cold start from random duals, so the polish seed is often wrong.
    y0 = rng.normal(size=(q.shape[0], 14))
    q = q + 0.5 * rng.normal(size=q.shape)

    def jrun(w, q, y0):
        return jadmm.solve(w, q, jadmm.init_state(w, None, y0), cfg)

    if ref == "eager":
        with jax.disable_jit():
            lanes = [jrun(jax.tree.map(lambda a: a[i], jws), jnp.asarray(q[i]),
                          jnp.asarray(y0[i])) for i in range(q.shape[0])]
        j = jax.tree.map(lambda *xs: np.stack(xs), *lanes)
    else:
        j = jax.jit(jax.vmap(jrun))(jws, jnp.asarray(q), jnp.asarray(y0))
    p = padmm.solve(pws, torch.from_numpy(q),
                    padmm.init_state(pws, None, torch.from_numpy(y0)),
                    pl_.ADMMOptions(**kw))
    assert np.array_equal(p.status.numpy(), np.asarray(j.status))
    if ref == "solution":
        np.testing.assert_allclose(p.x.numpy(), np.asarray(j.x), rtol=0,
                                   atol=1e-5)
        return
    assert np.array_equal(p.iterations.numpy(), np.asarray(j.iterations))
    # f64, same iteration: summation order only.
    for a, b in ((p.x, j.x), (p.y, j.y), (p.state.x, j.state.x),
                 (p.state.z, j.state.z), (p.state.y, j.state.y)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-9)
