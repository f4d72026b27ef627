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


def matrix_symmetrization_product(L: torch.Tensor,
                                  R: torch.Tensor) -> torch.Tensor:
    """``C = L'R + R'L`` (reference ``MatrixSymmetrizationProduct``,
    ``src/Utilities.cpp:104-116``): the complementarity Hessian,
    ``1/2 x'Cx = (Lx)'(Rx)``."""
    LtR = L.mT @ R
    return LtR + LtR.mT


def lane_where(mask: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """``where`` with a per-lane mask: ``mask`` has the leading (batch)
    shape and is broadcast over the trailing dims of ``a``/``b``.  This is
    how a finished lane's carry is frozen in the port's lockstep loops, as
    the batching rule of ``lax.while_loop`` freezes it under ``vmap``."""
    extra = max(a.ndim, b.ndim) - mask.ndim
    return torch.where(mask.reshape(mask.shape + (1,) * extra), a, b)
