"""The port's double-word f32 arithmetic against NumPy float64 and against
``lcqpow_tpu.ops.df32``.

JAX runs its ops eagerly here, one XLA computation per op, so nothing is
contracted into a fused multiply-add on either side: where the two packages
do the same f32 operations in the same order the results must be equal bit
for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lcqpow_tpu  # noqa: F401  (enables x64)
from lcqpow_tpu.ops import df32 as jdf

from lcqpow_tpu_torch.ops import df32 as pdf

U = 2.0 ** -24          # f32 unit roundoff
U_DF = 2.0 ** -44       # df32 accuracy budget for short sums (~2^-48 * 16)


def _f32(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same(p, j):
    """Bitwise equality of a port DF and a JAX DF."""
    assert np.array_equal(p.hi.numpy(), np.asarray(j.hi))
    assert np.array_equal(p.lo.numpy(), np.asarray(j.lo))


def _val(d):
    return d.hi.numpy().astype(np.float64) + d.lo.numpy().astype(np.float64)


# Scales keep products clear of f32 underflow and overflow, where no
# error-free transformation exists.
@pytest.mark.parametrize("scale", [1.0, 1e-8, 1e8])
def test_eft_scalar_ops(scale):
    rng = np.random.default_rng(0)
    a, b = _f32(rng, 4096, scale=scale), _f32(rng, 4096, scale=scale)
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    # Error-free: hi + lo equals the exact f64 result (f32 sums and products
    # of f32 inputs are exact in f64).
    s = pdf.two_sum(_t(a), _t(b))
    assert np.array_equal(_val(s), a64 + b64)
    p = pdf.two_prod(_t(a), _t(b))
    assert np.array_equal(_val(p), a64 * b64)
    big = np.where(np.abs(a) >= np.abs(b), a, b)
    small = np.where(np.abs(a) >= np.abs(b), b, a)
    f = pdf.fast_two_sum(_t(big), _t(small))
    assert np.array_equal(_val(f), big.astype(np.float64) + small)
    hi, lo = pdf._split(_t(a))
    assert np.array_equal(hi.numpy().astype(np.float64) + lo.numpy(), a64)
    # ... and identical to the JAX package, word for word.
    _same(s, jdf.two_sum(jnp.asarray(a), jnp.asarray(b)))
    _same(p, jdf.two_prod(jnp.asarray(a), jnp.asarray(b)))
    _same(f, jdf.fast_two_sum(jnp.asarray(big), jnp.asarray(small)))
    jhi, jlo = jdf._split(jnp.asarray(a))
    assert np.array_equal(hi.numpy(), np.asarray(jhi))
    assert np.array_equal(lo.numpy(), np.asarray(jlo))


def test_df_arithmetic():
    rng = np.random.default_rng(1)
    x64 = rng.normal(size=(64, 9))
    y64 = rng.normal(size=(64, 9))
    r = rng.normal(size=(64, 9)).astype(np.float32)
    px, py = pdf.from_f64(_t(x64)), pdf.from_f64(_t(y64))
    jx, jy = jdf.from_f64(jnp.asarray(x64)), jdf.from_f64(jnp.asarray(y64))
    _same(px, jx)
    cases = [
        (pdf.add(px, py), jdf.add(jx, jy), x64 + y64),
        (pdf.sub(px, py), jdf.sub(jx, jy), x64 - y64),
        (pdf.mul(px, py), jdf.mul(jx, jy), x64 * y64),
        (pdf.mul_f32(px, _t(r)), jdf.mul_f32(jx, jnp.asarray(r)),
         x64 * r.astype(np.float64)),
        (pdf.sum_(px), jdf.sum_(jx), x64.sum(-1)),
        (pdf.sum_(px, axis=0), jdf.sum_(jx, axis=0), x64.sum(0)),
    ]
    for p, j, exact in cases:
        _same(p, j)
        scale = 1.0 + np.abs(exact).max()
        assert np.abs(_val(p) - exact).max() <= U_DF * scale
    assert np.array_equal(pdf.to_f64(px).numpy(), np.asarray(jdf.to_f64(jx)))
    w = rng.normal(size=(64, 9)) > 0
    _same(pdf.where(_t(w), px, py), jdf.where(jnp.asarray(w), jx, jy))
    assert pdf.max_abs(px).item() == float(jdf.max_abs(jx))


@pytest.mark.parametrize("shape", [(14, 8), (22, 13)])
def test_compensated_matvecs(shape):
    rng = np.random.default_rng(2)
    m, n = shape
    M64 = rng.normal(size=(16, m, n))
    x64 = rng.normal(size=(16, n))
    y64 = rng.normal(size=(16, m))
    Mhi, Mlo = pdf.split_mat(_t(M64))
    jMhi, jMlo = jdf.split_mat(jnp.asarray(M64))
    assert np.array_equal(Mhi.numpy(), np.asarray(jMhi))
    assert np.array_equal(Mlo.numpy(), np.asarray(jMlo))
    x, y = pdf.from_f64(_t(x64)), pdf.from_f64(_t(y64))
    jx, jy = jdf.from_f64(jnp.asarray(x64)), jdf.from_f64(jnp.asarray(y64))
    # The leading compensated term is the same tree of EFTs: bitwise.
    _same(pdf.matvec(Mhi, x.hi), jdf.matvec(jMhi, jx.hi))
    _same(pdf.matvec_t(Mhi, y.hi), jdf.matvec_t(jMhi, jy.hi))
    # The f32 correction matvecs sum in each library's own order, so the
    # split products agree to df32 accuracy, not bitwise.
    for p, j, exact in (
            (pdf.split_matvec(Mhi, Mlo, x), jdf.split_matvec(jMhi, jMlo, jx),
             np.einsum("bmn,bn->bm", M64, x64)),
            (pdf.split_matvec_t(Mhi, Mlo, y),
             jdf.split_matvec_t(jMhi, jMlo, jy),
             np.einsum("bmn,bm->bn", M64, y64))):
        scale = 1.0 + np.abs(exact).max()
        assert np.abs(_val(p) - exact).max() <= U_DF * n * scale
        assert np.abs(_val(p) - np.asarray(jdf.to_f64(j))).max() \
            <= U_DF * n * scale


def test_single_word_ops_and_abs():
    rng = np.random.default_rng(3)
    x64 = rng.normal(size=(64, 9))
    r = rng.normal(size=(64, 9)).astype(np.float32)
    px, jx = pdf.from_f64(_t(x64)), jdf.from_f64(jnp.asarray(x64))
    # The same f32 operations in the same order: bitwise.
    assert np.array_equal(pdf.to_f32(px).numpy(), np.asarray(jdf.to_f32(jx)))
    _same(pdf.add_f32(px, _t(r)), jdf.add_f32(jx, jnp.asarray(r)))
    _same(pdf.scale(px, _t(r)), jdf.scale(jx, jnp.asarray(r)))
    _same(pdf.scale(px, 0.5), jdf.scale(jx, 0.5))
    # abs_ keys on the sign of hi: negative, positive, +0 and -0 hi, each
    # with a nonzero lo of either sign.
    hi = np.array([-1.5, -1.5, 2.0, 2.0, 0.0, 0.0, -0.0, -0.0], np.float32)
    lo = np.array([1e-9, -1e-9, 1e-9, -1e-9, 1e-9, -1e-9, 1e-9, -1e-9],
                  np.float32)
    p = pdf.abs_(pdf.DF(_t(hi), _t(lo)))
    j = jdf.abs_(jdf.DF(jnp.asarray(hi), jnp.asarray(lo)))
    _same(p, j)
    for pw, jw in ((p.hi, j.hi), (p.lo, j.lo)):
        assert np.array_equal(np.signbit(pw.numpy()),
                              np.signbit(np.asarray(jw)))
    assert np.array_equal(p.hi.numpy(), np.abs(hi))
    assert np.array_equal(p.lo.numpy(), np.where(hi < 0, -lo, lo))


# (8, 8): the df operand shape of the JAX package's own test; (16, 6, 9):
# its batched matvec shape.
@pytest.mark.parametrize("shape", [(8, 8), (16, 6, 9)])
def test_df_matvecs_df_operand(shape):
    rng = np.random.default_rng(4)
    *lead, m, n = shape
    A = rng.normal(size=shape).astype(np.float32)
    x64 = rng.normal(size=(*lead, n))
    y64 = rng.normal(size=(*lead, m))
    x, y = pdf.from_f64(_t(x64)), pdf.from_f64(_t(y64))
    jx, jy = jdf.from_f64(jnp.asarray(x64)), jdf.from_f64(jnp.asarray(y64))
    A64 = A.astype(np.float64)
    # The lo words go through an f32 matvec that each library sums in its
    # own order, so the two agree to df32 accuracy, not bitwise.
    for p, j, exact, k in (
            (pdf.df_matvec(_t(A), x), jdf.df_matvec(jnp.asarray(A), jx),
             np.einsum("...mn,...n->...m", A64, x64), n),
            (pdf.df_matvec_t(_t(A), y), jdf.df_matvec_t(jnp.asarray(A), jy),
             np.einsum("...mn,...m->...n", A64, y64), m)):
        assert p.hi.shape == exact.shape
        scale = 1.0 + np.abs(exact).max()
        assert np.abs(_val(p) - exact).max() <= U_DF * k * scale
        assert np.abs(_val(p) - np.asarray(jdf.to_f64(j))).max() \
            <= U_DF * k * scale


def test_df_dot_cancelling_operands():
    # a . b with b = (c, -c) against a = (u, u): the exact sum is tiny next
    # to its terms, the case the compensated dot exists for.
    rng = np.random.default_rng(5)
    u64 = rng.normal(size=(16, 7)) * 1e3
    c64 = rng.normal(size=(16, 7))
    a64 = np.concatenate([u64, u64 * (1 + 1e-9)], axis=-1)
    b64 = np.concatenate([c64, -c64], axis=-1)
    pa, pb = pdf.from_f64(_t(a64)), pdf.from_f64(_t(b64))
    ja, jb = jdf.from_f64(jnp.asarray(a64)), jdf.from_f64(jnp.asarray(b64))
    p, j = pdf.df_dot(pa, pb), jdf.df_dot(ja, jb)
    # The hi words' products: the same tree of EFTs as the JAX package.
    _same(pdf.dot(pa.hi, pb.hi), jdf.dot(ja.hi, jb.hi))
    # The cross terms are an f32 sum in each library's order: df32
    # accuracy against the exact sum of the represented values.
    exact = (_val(pa) * _val(pb)).sum(-1)
    terms = np.abs(_val(pa) * _val(pb)).sum(-1).max()
    assert np.abs(exact).max() < 1e-3 * terms
    assert np.abs(_val(p) - exact).max() <= U_DF * 14 * terms
    assert np.abs(_val(p) - np.asarray(jdf.to_f64(j))).max() \
        <= U_DF * 14 * terms
