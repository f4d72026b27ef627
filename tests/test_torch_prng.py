"""The port's key stream (``lcqpow_tpu_torch/prng.py``) against
``jax.random`` on the CPU, bit for bit: ``PRNGKey``, ``split``,
``fold_in``, 64-bit ``bits``, ``randint(-1, 2)``, the batched per-pass draw
(``perturb_step_plain``: split, then ``randint`` from the second key, on
the active lanes only), the pass's whole perturbation (``perturb_apply``:
the draw times eps added to the iterate of the lanes going), the fleet's
keys that every entry point hands its lanes (``fleet_keys``), and the
solver's one perturbation call a pass.

The port copies JAX 0.9.0 with ``jax_threefry_partitionable`` on and x64
on (the JAX package turns x64 on when it is imported); the first test
asserts both, so a change of either default shows here first.  Every
comparison is exact: the arithmetic is integer-only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import prng as jax_prng

import lcqpow_tpu  # noqa: F401  (turns x64 on, as in every run of the package)

import lcqpow_tpu_torch

from lcqpow_tpu_torch import prng

SEEDS = [0, 1, -1, 2 ** 32 - 1, 2 ** 40 + 5, 2 ** 63 - 1]
WIDTHS = [1, 5, 8, 64]


def _t(a):
    """A JAX uint32 (or int64) array as the port's int64 tensor."""
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def test_jax_flags_are_the_ported_ones():
    assert jax.config.jax_threefry_partitionable is True
    assert jax.config.jax_enable_x64 is True


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_matches_jax(seed):
    assert torch.equal(prng.prng_key(seed), _t(jax.random.PRNGKey(seed)))


def test_prng_key_words():
    # High word first; negative seeds as two's complement.
    assert prng.prng_key(2 ** 40 + 5).tolist() == [256, 5]
    assert prng.prng_key(-1).tolist() == [4294967295, 4294967295]
    assert prng.prng_key(2 ** 63 - 1).tolist() == [2147483647, 4294967295]
    with pytest.raises(OverflowError):
        prng.prng_key(2 ** 63)


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("seed", SEEDS)
def test_split_matches_jax(seed, width):
    key = jax.random.PRNGKey(seed)
    assert torch.equal(prng.split(prng.prng_key(seed), width),
                       _t(jax.random.split(key, width)))


@pytest.mark.parametrize("seed", SEEDS)
def test_split_prefix_and_batched_keys(seed):
    # A split's first keys do not depend on how many it makes (the JAX
    # package's padded retries rely on it), and a (B, 2) key array splits
    # lane by lane, as vmap over split does.
    key = prng.prng_key(seed)
    assert torch.equal(prng.split(key, 8)[:5], prng.split(key, 5))
    jkeys = jax.random.split(jax.random.PRNGKey(seed), 6)
    want = jax.vmap(lambda k: jax.random.split(k, 3))(jkeys)
    assert torch.equal(prng.split(_t(jkeys), 3), _t(want))


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_matches_jax(seed):
    key = jax.random.PRNGKey(seed)
    for data in (0, 1, 2, 3, 7, 2 ** 31, 2 ** 32 - 1):
        assert torch.equal(prng.fold_in(prng.prng_key(seed), data),
                           _t(jax.random.fold_in(key, data))), data


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("seed", SEEDS)
def test_random_bits_64_matches_jax(seed, width):
    want = np.asarray(jax.random.bits(jax.random.PRNGKey(seed), (width,),
                                      dtype=jnp.uint64))
    hi, lo = prng.random_bits(prng.prng_key(seed), (width,))
    got = (hi.numpy().astype(np.uint64) << np.uint64(32)) \
        | lo.numpy().astype(np.uint64)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_random_bits_shapes_match_jax(seed):
    # Elements count in row-major order over the whole shape.
    key = jax.random.PRNGKey(seed)
    for shape in ((3, 4), (2, 1, 5)):
        hi, lo = prng.random_bits(prng.prng_key(seed), shape)
        want = np.asarray(jax.random.bits(key, shape, dtype=jnp.uint64))
        assert hi.shape == lo.shape == shape
        assert np.array_equal(hi.numpy().astype(np.uint64), want >> 32)
        assert np.array_equal(lo.numpy().astype(np.uint64),
                              want & np.uint64(0xFFFFFFFF))


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("seed", SEEDS)
def test_randint_matches_jax(seed, width):
    got = prng.randint(prng.prng_key(seed), (width,), -1, 2)
    want = jax.random.randint(jax.random.PRNGKey(seed), (width,), -1, 2)
    assert np.asarray(want).dtype == np.int64
    assert torch.equal(got, _t(want))


# Other spans: one value, an empty range (JAX returns minval), a power of
# two, and the largest span the port takes, whose multiplier and unsigned
# remainders a signed int64 remainder would get wrong.
@pytest.mark.parametrize("lo,hi", [(0, 1), (5, 5), (0, 8), (-3, 4),
                                   (-10 ** 6, 2 ** 31 - 1 - 10 ** 6)])
def test_randint_spans_match_jax(lo, hi):
    for seed in (0, -1, 2 ** 40 + 5):
        got = prng.randint(prng.prng_key(seed), (64,), lo, hi)
        want = jax.random.randint(jax.random.PRNGKey(seed), (64,), lo, hi)
        assert torch.equal(got, _t(want)), seed


def _threefry_2x32(key, count):
    """JAX's ``threefry_2x32(keypair, count)`` (``jax/_src/prng.py:1092``)
    over the port's hash: the flat counts, padded to an even length, are
    hashed as (first half, second half) pairs and the two output halves
    concatenated."""
    flat = count.reshape(-1)
    odd = flat.numel() % 2
    if odd:
        flat = torch.cat([flat, flat.new_zeros(1)])
    h = flat.numel() // 2
    a, b = prng.threefry2x32(key[0], key[1], flat[:h], flat[h:])
    out = torch.cat([a, b])
    return (out[:-1] if odd else out).reshape(count.shape)


@pytest.mark.parametrize("count", [6, 7])
def test_threefry_2x32_matches_jax(count):
    # The hash itself, at counts JAX's split and bits never hash.
    key = jax.random.PRNGKey(2 ** 40 + 5)
    c = jnp.arange(count, dtype=jnp.uint32) * 977
    assert torch.equal(_threefry_2x32(_t(key), _t(c)),
                       _t(jax_prng.threefry_2x32(key, c)))


def _jax_pass(key, n):
    """One homotopy pass's draw, as ``lcqpow_tpu/solver.py:496-499``."""
    key, sub = jax.random.split(key)
    return key, jax.random.randint(sub, (n,), -1, 2)


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("seed", SEEDS)
def test_perturb_step_matches_jax(seed, width):
    B = 16
    jkeys = jax.random.split(jax.random.PRNGKey(seed), B)
    active = np.random.default_rng(width).random(B) < 0.6
    active[:2] = [True, False]
    want_k, want_r = jax.vmap(lambda k: _jax_pass(k, width))(jkeys)
    keys, r = prng.perturb_step_plain(_t(jkeys), torch.from_numpy(active),
                                      width)
    keys, r = keys.numpy(), r.numpy()
    # Active lanes advance as the JAX lane does; the others (the done
    # branch of the JAX loop) keep their key and draw nothing.
    assert np.array_equal(keys[active], np.asarray(want_k)[active])
    assert np.array_equal(r[active], np.asarray(want_r)[active])
    assert np.array_equal(keys[~active], np.asarray(jkeys)[~active])
    assert (r[~active] == 0).all()
    assert set(np.unique(r[active])) <= {-1, 0, 1}


def test_perturb_step_chain_matches_jax():
    # Ten passes with lanes finishing on the way: a finished lane stops
    # splitting, so its later draws continue from where it stopped.
    B, n = 8, 5
    jkeys = jax.random.split(jax.random.PRNGKey(3), B)
    keys = _t(jkeys)
    for p in range(10):
        active = np.arange(B) >= p - 2
        nk, nr = jax.vmap(lambda k: _jax_pass(k, n))(jkeys)
        jkeys = jnp.where(active[:, None], nk, jkeys)
        keys, r = prng.perturb_step_plain(keys, torch.from_numpy(active), n)
        assert torch.equal(keys, _t(jkeys))
        assert np.array_equal(r.numpy()[active], np.asarray(nr)[active])


DTYPES = {"f32": (torch.float32, jnp.float32, np.uint32),
          "f64": (torch.float64, jnp.float64, np.uint64)}


def _jax_apply(key, go, x):
    """One pass's whole perturbation of a lane, as the JAX package's pass
    does it (``lcqpow_tpu/solver.py:496-499``; a done lane keeps its key
    and iterate, ``:515-518``)."""
    nk, sub = jax.random.split(key)
    r = jax.random.randint(sub, x.shape, -1, 2).astype(x.dtype)
    xn = x + r * jnp.finfo(x.dtype).eps
    return jnp.where(go, nk, key), jnp.where(go, xn, x)


def _iterate(B, n, dtype, seed):
    """(B, n) values of ``dtype`` with -0, +0, subnormals of both signs and
    +-1 at every third element among normal draws."""
    flat = np.random.default_rng(seed).normal(size=B * n).astype(dtype)
    tiny = np.finfo(dtype).smallest_subnormal
    special = np.array([-0.0, 0.0, 3 * tiny, -5 * tiny, 1.0, -1.0], dtype)
    flat[::3] = np.resize(special, flat[::3].shape)
    return flat.reshape(B, n)


def _mask(B, seed):
    go = np.random.default_rng(seed).random(B) < 0.6
    go[:2] = [True, False]
    return go


@pytest.mark.parametrize("n", [1, 8, 202])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_perturb_apply_plain_matches_jax(dt, n):
    tdt, jdt, bits = DTYPES[dt]
    B = 16
    jkeys = jax.random.split(jax.random.PRNGKey(n), B)
    go = _mask(B, n)
    x = _iterate(B, n, jdt, n)
    want_k, want_x = jax.vmap(_jax_apply)(jkeys, jnp.asarray(go),
                                          jnp.asarray(x))
    keys, got = prng.perturb_apply_plain(
        _t(jkeys), torch.from_numpy(go), torch.from_numpy(x),
        torch.finfo(tdt).eps)
    assert got.dtype == tdt and tuple(got.shape) == (B, n)
    assert torch.equal(keys, _t(want_k))
    got, want_x = got.numpy().view(bits), np.asarray(want_x).view(bits)
    # The same sum in IEEE arithmetic (numpy) on the draw: equal bit for
    # bit everywhere, -0 + 0 = +0 on a going lane, every bit of a lane not
    # going kept.
    _, r = prng.perturb_step_plain(_t(jkeys), torch.from_numpy(go), n)
    r = r.numpy()
    ieee = np.where(go[:, None], x + r.astype(x.dtype) * np.finfo(x.dtype).eps,
                    x)
    assert np.array_equal(got, ieee.view(bits))
    assert np.array_equal(got[~go], x[~go].view(bits))
    assert ((got == x.view(bits)) | go[:, None]).all()
    # XLA:CPU flushes subnormal operands to zero, so where a going lane adds
    # r = 0 to a subnormal it gives +0 and the port (like the card) keeps
    # the subnormal; every other element is JAX's bit for bit.
    sub = go[:, None] & (r == 0) & (x != 0) \
        & (np.abs(x) < np.finfo(x.dtype).tiny)
    assert np.array_equal(got[~sub], want_x[~sub])
    assert (want_x[sub] == 0).all()
    assert np.array_equal(got[sub], x[sub].view(bits))


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_perturb_apply_chain_matches_jax(dt):
    # Twenty passes with lanes finishing on the way, each from the keys and
    # iterate the last one left, as the solver carries them.
    tdt, jdt, bits = DTYPES[dt]
    B, n = 8, 8
    jkeys = jax.random.split(jax.random.PRNGKey(5), B)
    jx = jnp.asarray(np.random.default_rng(5).normal(size=(B, n)), jdt)
    keys, x = _t(jkeys), torch.from_numpy(np.array(jx))
    for p in range(20):
        go = np.arange(B) >= p - 12
        jkeys, jx = jax.vmap(_jax_apply)(jkeys, jnp.asarray(go), jx)
        keys, x = prng.perturb_apply_plain(keys, torch.from_numpy(go), x,
                                           torch.finfo(tdt).eps)
        assert torch.equal(keys, _t(jkeys)), p
        assert np.array_equal(x.numpy().view(bits),
                              np.asarray(jx).view(bits)), p


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_perturb_apply_takes_the_plain_version_on_the_cpu(dt):
    tdt = DTYPES[dt][0]
    B, n = 12, 5
    keys = prng.split(prng.prng_key(7), B)
    go = torch.from_numpy(_mask(B, 7))
    x = torch.from_numpy(_iterate(B, n, DTYPES[dt][1], 7))
    before = prng.launch_count
    got = prng.perturb_apply(keys, go, x, torch.finfo(tdt).eps)
    step = prng.perturbation(keys, x, torch.finfo(tdt).eps)
    want = prng.perturb_apply_plain(keys, go, x, torch.finfo(tdt).eps)
    for a in (got, step(keys, go, x)):
        assert torch.equal(a[0], want[0])
        assert torch.equal(a[1].view(torch.uint8), want[1].view(torch.uint8))
    assert prng.launch_count == before


def test_perturb_apply_rejects_other_devices():
    keys = prng.split(prng.prng_key(1), 4).to("meta")
    go = torch.ones(4, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError):
        prng.perturb_apply(keys, go, torch.zeros((4, 3), device="meta"), 1.0)


def _recorded_keys(entry, monkeypatch, B, seed, offset):
    """The keys ``entry`` hands lanes ``offset`` to ``B - 1`` of a fleet of
    ``B`` lanes, in fleet order, recorded at the calls that solve them."""
    from lcqpow_tpu_torch import batch, mixed
    from lcqpow_tpu_torch.parallel import distributed, sharding
    from lcqpow_tpu_torch.problems import warmup_fleet

    opts = lcqpow_tpu_torch.Options(
        print_level=lcqpow_tpu_torch.PrintLevel.NONE, max_iterations=3,
        seed=seed)
    fleet = warmup_fleet(B, device="cpu")
    seen = []

    def record(module, name):
        real = getattr(module, name)

        def call(d, options, *args, key=None, **kw):
            seen.append((d.g.clone(), key.clone()))
            return real(d, options, *args, key=key, **kw)
        monkeypatch.setattr(module, name, call)

    if entry == "solve_batch":
        record(batch, "solve")
        batch.solve_batch(fleet, opts, chunk=4)
    elif entry == "solve_batch_mixed":
        record(mixed, "solve_mixed")
        mixed.solve_batch_mixed(fleet, opts, chunk=4, escalate=0)
    else:
        record(sharding, "solve")
        local = distributed.HostLocalBatch(
            fleet.map(lambda a: a[offset:]), offset=offset, total=B)
        sharding.solve_batch_sharded(local, opts,
                                     mesh=sharding.make_mesh(["cpu", "cpu"]))
    # The lanes' g rows are distinct (warmup_fleet's 64 problems, each with
    # its own noise): they tell which lane each recorded key is for.
    keys = torch.full((B, 2), -1, dtype=torch.int64)
    for g, k in seen:
        lane = (g[:, None, :] == fleet.g[None]).all(-1).int().argmax(-1)
        keys[lane] = k
    return keys[offset:]


@pytest.mark.parametrize("entry", ["solve_batch", "solve_batch_mixed",
                                   "solve_batch_sharded"])
def test_entry_points_give_a_fleet_jax_split_keys(entry, monkeypatch):
    # solve_batch and solve_batch_mixed in chunks of 4 lanes, and the rank
    # whose lanes start at 3 over two slices: each lane gets its key of
    # jax.random.split(PRNGKey(seed), B), as the JAX package gives it.
    B, seed = 10, 11
    offset = 3 if entry == "solve_batch_sharded" else 0
    got = _recorded_keys(entry, monkeypatch, B, seed, offset)
    want = jax.random.split(jax.random.PRNGKey(seed), B)
    assert torch.equal(got, _t(want)[offset:])


def test_fleet_keys_of_a_rank_are_the_fleet_split():
    key = prng.prng_key(4)
    assert torch.equal(prng.fleet_keys(key, 0, 9, "cpu", offset=6),
                       prng.split(key, 30)[6:9])
    assert torch.equal(prng.fleet_keys(None, 4, 5, "cpu"),
                       _t(jax.random.split(jax.random.PRNGKey(4), 5)))


@pytest.mark.parametrize("mixed", [False, True])
def test_solver_perturbs_with_one_call_a_pass(mixed, monkeypatch):
    # With the perturbation stubbed to return keys and iterate unchanged,
    # a solve with the perturbation on takes the path of one with it off:
    # its op count must be the same, so the pass holds no draw, cast, scale,
    # add or select of the perturbation beside the one call, and the call
    # comes once a pass (the longest lane's passes).  Each call gets the
    # very keys tensor the last one returned: the carry does not select the
    # keys again (the perturbation keeps those of the lanes not going).
    from torch.profiler import ProfilerActivity, profile

    import lcqpow_tpu_torch as lt
    from lcqpow_tpu_torch.problems import warmup_fleet

    calls = []

    def stub(keys, go, xk, eps):
        calls.append((tuple(xk.shape), keys))
        return keys, xk

    monkeypatch.setattr(prng, "perturb_apply_plain", stub)
    fleet = warmup_fleet(6, device="cpu")
    opts = lt.Options(print_level=lt.PrintLevel.NONE, max_iterations=200)
    solve = (lambda o: lt.solve_mixed(fleet, o, n_corrector_iters=6)) \
        if mixed else (lambda o: lt.solve(fleet, o))
    counts, sols = [], []
    for on in (False, True):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            sols.append(solve(opts.replace(perturb_step=on)))
        counts.append({e.key: e.count for e in prof.key_averages()
                       if e.key.startswith("aten::")})
    assert counts[0] == counts[1]
    passes = int(sols[1].stats.iter_total.max())
    assert [shape for shape, _ in calls] == [(6, 8)] * passes and passes > 0
    assert all(keys is calls[0][1] for _, keys in calls)
    assert torch.equal(sols[0].x, sols[1].x)
