"""Double-word float32 ("double-single") arithmetic: the port of
``lcqpow_tpu/ops/df32.py``.

A value is the unevaluated sum ``hi + lo`` of two float32 words (~48-bit
mantissa, unit roundoff ~2^-48), and +, -, *, dot are sequences of exact f32
operations (Dekker 1971, Knuth TAOCP v2).  The mixed-precision corrector
(:mod:`lcqpow_tpu_torch.mixed`) evaluates its residuals with them.

Rounding: the error-free transformations need every product ROUNDED before
the compensating add.  Eager PyTorch runs each operation as its own kernel
and stores its rounded result, so nothing here can be contracted into a
fused multiply-add, and the JAX package's anti-contraction fence
(``df32.py:38-50``) is the identity here.  Running this module under
``torch.compile`` (or porting it into a kernel built without
``--fmad=false``) would break that and is not done.

All functions broadcast over leading batch dims and take ``(hi, lo)`` pairs
of equal-shape float32 tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .linalg import mtv, mv

_SPLIT = 4097.0  # 2^12 + 1 (Dekker split constant for f32)
_F32 = torch.float32


def _fence(x):
    """Identity: eager ops already round every product (see the module
    docstring); kept so the EFTs read as in the JAX package."""
    return x


class DF(NamedTuple):
    """A double-word float32 value/array: represented value = hi + lo."""

    hi: torch.Tensor
    lo: torch.Tensor

    @property
    def shape(self):
        return self.hi.shape


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(_F32)
    return torch.as_tensor(x, dtype=_F32)


def from_f32(x) -> DF:
    x = _f32(x)
    return DF(x, torch.zeros_like(x))


def from_f64(x) -> DF:
    """Split a float64 tensor into hi+lo f32 words (exact to df32
    precision)."""
    x = torch.as_tensor(x)
    hi = x.to(_F32)
    lo = (x - hi.to(x.dtype)).to(_F32)
    return DF(hi, lo)


def to_f32(a: DF):
    return a.hi + a.lo


def to_f64(a: DF):
    """Recombine in float64."""
    return a.hi.to(torch.float64) + a.lo.to(torch.float64)


# ------------------------------------------------------------ scalar EFTs
def two_sum(a, b) -> DF:
    """Knuth TwoSum: a + b = s + e exactly (6 flops, branchless)."""
    a, b = _f32(a), _f32(b)
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return DF(s, e)


def fast_two_sum(a, b) -> DF:
    """Dekker FastTwoSum, requires |a| >= |b| (3 flops)."""
    s = a + b
    return DF(s, b - (s - a))


def _split(a):
    t = _fence(_SPLIT * a)
    hi = t - (t - a)
    return hi, a - hi


def two_prod(a, b) -> DF:
    """Dekker TwoProd: a * b = p + e exactly (17 flops, FMA-free)."""
    a, b = _f32(a), _f32(b)
    p = _fence(a * b)
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return DF(p, e)


# ------------------------------------------------------------- df ops
def add(a: DF, b: DF) -> DF:
    """df + df (Dekker add22, ~11 flops)."""
    s = two_sum(a.hi, b.hi)
    e = s.lo + (a.lo + b.lo)
    return fast_two_sum(s.hi, e)


def add_f32(a: DF, b) -> DF:
    s = two_sum(a.hi, _f32(b))
    return fast_two_sum(s.hi, s.lo + a.lo)


def neg(a: DF) -> DF:
    return DF(-a.hi, -a.lo)


def sub(a: DF, b: DF) -> DF:
    return add(a, neg(b))


def mul(a: DF, b: DF) -> DF:
    """df * df (~25 flops)."""
    p = two_prod(a.hi, b.hi)
    e = p.lo + (a.hi * b.lo + a.lo * b.hi)
    return fast_two_sum(p.hi, e)


def mul_f32(a: DF, b) -> DF:
    b = _f32(b)
    p = two_prod(a.hi, b)
    return fast_two_sum(p.hi, p.lo + a.lo * b)


def scale(a: DF, s) -> DF:  # alias
    return mul_f32(a, s)


def abs_(a: DF) -> DF:
    neg_mask = a.hi < 0
    return DF(torch.where(neg_mask, -a.hi, a.hi),
              torch.where(neg_mask, -a.lo, a.lo))


def where(mask, a: DF, b: DF) -> DF:
    return DF(torch.where(mask, a.hi, b.hi), torch.where(mask, a.lo, b.lo))


# -------------------------------------------------- reductions & linalg
def sum_(a: DF, axis: int = -1) -> DF:
    """Tree-reduced df sum along one axis (log2(n) df-adds on halved
    tensors), in the JAX package's pairing order."""
    hi, lo = a.hi, a.lo
    axis = axis % hi.ndim
    n = hi.shape[axis]
    while n > 1:
        half = n // 2
        s = add(DF(hi.narrow(axis, 0, half), lo.narrow(axis, 0, half)),
                DF(hi.narrow(axis, half, half), lo.narrow(axis, half, half)))
        if n % 2:
            hi = torch.cat([s.hi, hi.narrow(axis, 2 * half, 1)], dim=axis)
            lo = torch.cat([s.lo, lo.narrow(axis, 2 * half, 1)], dim=axis)
            n = half + 1
        else:
            hi, lo = s.hi, s.lo
            n = half
    return DF(hi.squeeze(axis), lo.squeeze(axis))


def dot(a, b, axis: int = -1) -> DF:
    """Compensated dot product of two f32 tensors along ``axis`` (TwoProd
    products, tree-summed in df: the ~2^-48 'dot2' algorithm)."""
    return sum_(two_prod(a, b), axis=axis)


def matvec(A, x) -> DF:
    """``A @ x`` with df accuracy: ``A`` (..., m, n), ``x`` (..., n) f32."""
    return dot(A, x[..., None, :], axis=-1)


def matvec_t(A, y) -> DF:
    """``A.T @ y``: ``A`` (..., m, n), ``y`` (..., m) -> DF (..., n)."""
    return dot(A, y[..., :, None], axis=-2)


def df_matvec(A, x: DF) -> DF:
    """``A @ x`` where x is df: the hi word through the compensated
    matvec, the lo word through an f32 one (enough: |lo| <= eps |x|)."""
    main = matvec(A, x.hi)
    corr = mv(A, x.lo)
    return add(main, DF(corr, torch.zeros_like(corr)))


def df_matvec_t(A, y: DF) -> DF:
    """``A.T @ y`` where y is df."""
    main = matvec_t(A, y.hi)
    corr = mtv(A, y.lo)
    return add(main, DF(corr, torch.zeros_like(corr)))


def split_mat(M64) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split a float64 matrix into (hi, lo) f32 words (exact to df32)."""
    d = from_f64(M64)
    return d.hi, d.lo


def split_matvec(Mhi, Mlo, x: DF) -> DF:
    """``(Mhi + Mlo) @ (x.hi + x.lo)`` to df accuracy: one compensated
    matvec for the leading term plus two f32 correction matvecs (the
    ``Mlo @ x.lo`` term is below df precision and dropped)."""
    main = matvec(Mhi, x.hi)
    corr = mv(Mhi, x.lo) + mv(Mlo, x.hi)
    return add(main, DF(corr, torch.zeros_like(corr)))


def split_matvec_t(Mhi, Mlo, y: DF) -> DF:
    """``(Mhi + Mlo).T @ (y.hi + y.lo)`` to df accuracy."""
    main = matvec_t(Mhi, y.hi)
    corr = mtv(Mhi, y.lo) + mtv(Mlo, y.hi)
    return add(main, DF(corr, torch.zeros_like(corr)))


def df_dot(a: DF, b: DF) -> DF:
    """Compensated dot of two df vectors along the last axis (the lo*lo
    term is dropped)."""
    main = dot(a.hi, b.hi)
    corr = (a.hi * b.lo + a.lo * b.hi).sum(-1)
    return add(main, DF(corr, torch.zeros_like(corr)))


def max_abs(a: DF, axis=None):
    """f32 upper estimate of max|a| (the hi word dominates; lo shifts the
    boundary by O(eps^2))."""
    v = (a.hi + a.lo).abs()
    return v.amax() if axis is None else v.amax(dim=axis)
