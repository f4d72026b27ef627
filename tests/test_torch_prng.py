"""The port's key stream (``lcqpow_tpu_torch/prng.py``) against
``jax.random`` on the CPU, bit for bit: ``PRNGKey``, ``split``,
``fold_in``, 64-bit ``bits``, ``randint(-1, 2)`` and the solver's batched
per-pass draw (``perturb_step``: split, then ``randint`` from the second
key, on the active lanes only).

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
    keys, r = prng.perturb_step(_t(jkeys), torch.from_numpy(active), width)
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
        keys, r = prng.perturb_step(keys, torch.from_numpy(active), n)
        assert torch.equal(keys, _t(jkeys))
        assert np.array_equal(r.numpy()[active], np.asarray(nr)[active])
