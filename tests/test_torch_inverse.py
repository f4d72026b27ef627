"""The port's Gauss-Jordan inverse and SPD inverses against the JAX package.

Inputs are Jacobi-scaled SPD batches made with NumPy from a seed, the
matrices the solver hands the inverse (``ops/chol.py``).  Tolerances are
relative to the largest entry of the exact (float64) inverse of each
matrix.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import lcqpow_tpu  # noqa: F401  (enables x64 for the f64 reference)
from lcqpow_tpu.ops import chol as jchol
from lcqpow_tpu.ops.pallas_inverse import _gj_kernel

from lcqpow_tpu_torch.ops import chol as pchol
from lcqpow_tpu_torch.ops import gj_inverse as pgj


def _spd(B, m, seed):
    """(Jacobi-scaled f32 batch, the unscaled f64 SPD batch)."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, m, m))
    S = A @ A.transpose(0, 2, 1) / m + 0.1 * np.eye(m)
    d = np.sqrt(np.einsum("bii->bi", S))
    return (S / (d[:, :, None] * d[:, None, :])).astype(np.float32), S


def _rel_err(X, Y, ref):
    scale = np.abs(ref).max(axis=(1, 2), keepdims=True)
    return float((np.abs(np.asarray(X, np.float64) - np.asarray(Y, np.float64))
                  / scale).max())


def _pallas_interpret(Ss, bt=128):
    """The TPU kernel ``_gj_kernel`` itself, run by Pallas' interpreter on
    the lane-major (m, m, B) layout of ``spd_inverse_pallas``."""
    B, m = Ss.shape[0], Ss.shape[-1]
    imap = lambda i: (i * 0, i * 0, i)
    out = pl.pallas_call(
        functools.partial(_gj_kernel, m), grid=(B // bt,),
        in_specs=[pl.BlockSpec((m, m, bt), imap)],
        out_specs=pl.BlockSpec((m, m, bt), imap),
        out_shape=jax.ShapeDtypeStruct((m, m, B), jnp.float32),
        interpret=True)(jnp.asarray(Ss.transpose(1, 2, 0)))
    return np.asarray(out).transpose(2, 0, 1)


@pytest.mark.parametrize("m", [8, 14])
def test_gj_plain_matches_tpu_kernel(m):
    Ss, _ = _spd(256, m, seed=m)
    J = _pallas_interpret(Ss)
    P = pgj.gj_inverse_plain(torch.from_numpy(Ss)).numpy()
    ref = np.linalg.inv(Ss.astype(np.float64))
    # Same elimination order, but XLA:CPU contracts ``M - f*rowM`` into a
    # fused multiply-add in the interpreted kernel while eager PyTorch
    # rounds the product: the two differ by a few f32 ulps per step
    # (measured 7.4e-7 at m = 14), each within 1e-6 of the exact inverse.
    assert _rel_err(J, P, ref) <= 2e-6
    assert _rel_err(P, ref, ref) <= 2e-6
    assert _rel_err(J, ref, ref) <= 2e-6


def test_gj_wrapper_on_cpu_is_plain_and_not_counted():
    Ss, _ = _spd(33, 14, seed=1)
    S = torch.from_numpy(Ss)
    before = pgj.launch_count
    out = pgj.gj_inverse(S)
    assert torch.equal(out, pgj.gj_inverse_plain(S))
    assert pgj.launch_count == before


@pytest.mark.parametrize("name", ["spd_inverse", "spd_inverse_light"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("m", [8, 14])
def test_spd_inverse_matches_jax(name, dtype, m):
    _, S = _spd(64, m, seed=3 + m)
    S = S.astype(dtype)
    J = np.asarray(getattr(jchol, name)(jnp.asarray(S)))
    P = getattr(pchol, name)(torch.from_numpy(S)).numpy()
    ref = np.linalg.inv(S.astype(np.float64))
    if dtype == np.float64:
        # Both packages run the same block recursion (+ Newton-Schulz); only
        # the summation order of the small matmuls differs.
        tol = 1e-14
    else:
        # f32: the port routes to Gauss-Jordan, JAX-on-CPU to the block
        # recursion; both land within ~1.2e-6 of the exact inverse
        # (measured), so they differ by at most the sum.
        tol = 4e-6
    assert _rel_err(P, J, ref) <= tol
    assert _rel_err(P, ref, ref) <= tol


@pytest.mark.parametrize("n", [1, 2, 5, 14])
def test_block_inverse_and_triangular_inverse_match_jax(n):
    _, S = _spd(8, n, seed=n)
    J = np.asarray(jchol.block_spd_inverse(jnp.asarray(S)))
    P = pchol.block_spd_inverse(torch.from_numpy(S)).numpy()
    np.testing.assert_allclose(P, J, rtol=0, atol=1e-12 * np.abs(J).max())
    L = np.linalg.cholesky(S)
    Jt = np.asarray(jchol.tri_inv_lower(jnp.asarray(L)))
    Pt = pchol.tri_inv_lower(torch.from_numpy(L)).numpy()
    np.testing.assert_allclose(Pt, Jt, rtol=0, atol=1e-12 * np.abs(Jt).max())


def test_unbatched_and_nested_batches_route_like_jax():
    _, S = _spd(6, 14, seed=9)
    S32 = S.astype(np.float32)
    one = pchol.spd_inverse(torch.from_numpy(S32[0]))
    nested = pchol.spd_inverse(torch.from_numpy(S32.reshape(2, 3, 14, 14)))
    flat = pchol.spd_inverse(torch.from_numpy(S32))
    assert torch.equal(nested.reshape(6, 14, 14), flat)
    # An unbatched matrix takes the block recursion, as an un-vmapped call
    # does in the JAX package.
    J = np.asarray(jchol.spd_inverse(jnp.asarray(S32[0])))
    assert _rel_err(one.numpy()[None], J[None], np.linalg.inv(S[:1])) <= 4e-6
