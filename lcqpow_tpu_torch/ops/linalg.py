"""Batched dense helpers (the reference's ``Utilities`` layer).

Every function works on the trailing dimensions and broadcasts over any
leading batch dimensions, which is how the port writes out the batch axis
that the JAX package gets from ``vmap``.
"""

from __future__ import annotations

import torch


def mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` per lane: ``A`` (..., m, n), ``x`` (..., n) -> (..., m)."""
    return (A @ x.unsqueeze(-1)).squeeze(-1)


def mtv(A: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``A.T @ y`` per lane: ``A`` (..., m, n), ``y`` (..., m) -> (..., n)."""
    return (y.unsqueeze(-2) @ A).squeeze(-2)


def absmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``max |x|`` over one axis (the infinity norm per lane)."""
    return x.abs().amax(dim=dim)


def eye(n: int, like: torch.Tensor) -> torch.Tensor:
    """(n, n) identity with ``like``'s dtype and device."""
    return torch.eye(n, dtype=like.dtype, device=like.device)


def matrix_multiplication(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``A @ b`` (reference ``Utilities::MatrixMultiplication``,
    ``src/Utilities.cpp:38-47``).  ``b`` is a vector per lane when it has
    one dimension fewer than ``A``, else a matrix."""
    return mv(A, b) if b.ndim == A.ndim - 1 else A @ b


def transposed_matrix_multiplication(A: torch.Tensor,
                                     b: torch.Tensor) -> torch.Tensor:
    """``A' @ b`` (reference ``TransponsedMatrixMultiplication``,
    ``src/Utilities.cpp:62-72``); ``b`` as in
    :func:`matrix_multiplication`."""
    return mtv(A, b) if b.ndim == A.ndim - 1 else A.mT @ b


def matrix_symmetrization_product(L: torch.Tensor,
                                  R: torch.Tensor) -> torch.Tensor:
    """``C = L'R + R'L`` (reference ``MatrixSymmetrizationProduct``,
    ``src/Utilities.cpp:104-116``): the complementarity Hessian,
    ``1/2 x'Cx = (Lx)'(Rx)``."""
    LtR = L.mT @ R
    return LtR + LtR.mT


def affine_linear_transformation(alpha, A: torch.Tensor, b: torch.Tensor,
                                 c: torch.Tensor) -> torch.Tensor:
    """``d = alpha*A@b + c`` (reference ``AffineLinearTransformation``,
    ``src/Utilities.cpp:176-186``)."""
    return alpha * matrix_multiplication(A, b) + c


def weighted_matrix_add(alpha, A, beta, B) -> torch.Tensor:
    """``alpha*A + beta*B`` (reference ``WeightedMatrixAdd``,
    ``src/Utilities.cpp:202-206``)."""
    return alpha * A + beta * B


def weighted_vector_add(alpha, a, beta, b) -> torch.Tensor:
    """``alpha*a + beta*b`` (reference ``WeightedVectorAdd``,
    ``src/Utilities.cpp:208-211``)."""
    return alpha * a + beta * b


def quadratic_form_product(Q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``p'Qp`` per lane (reference ``QuadraticFormProduct``,
    ``src/Utilities.cpp:214-225``)."""
    return (p * mv(Q, p)).sum(-1)


def dot_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a'b`` per lane (reference ``DotProduct``,
    ``src/Utilities.cpp:244-250``)."""
    return (a * b).sum(-1)


def max_abs(a: torch.Tensor) -> torch.Tensor:
    """Infinity norm ``max_i |a_i|`` per lane.  The reference's ``MaxAbs``
    (``src/Utilities.cpp:253-265``) computes the infinity norm although its
    doc comment says "1-norm"; the behaviour, not the comment, is kept: it
    feeds the stationarity check (``src/LCQProblem.cpp:1151-1153``)."""
    return absmax(a)


def lane_where(mask: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """``where`` with a per-lane mask: ``mask`` has the leading (batch)
    shape and is broadcast over the trailing dims of ``a``/``b``.  This is
    how a finished lane's carry is frozen in the port's lockstep loops, as
    the batching rule of ``lax.while_loop`` freezes it under ``vmap``."""
    extra = max(a.ndim, b.ndim) - mask.ndim
    return torch.where(mask.reshape(mask.shape + (1,) * extra), a, b)
