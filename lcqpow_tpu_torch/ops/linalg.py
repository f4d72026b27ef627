"""Batched dense helpers (the reference's ``Utilities`` layer).

Every function works on the trailing dimensions and broadcasts over any
leading batch dimensions, which is how the port writes out the batch axis
that the JAX package gets from ``vmap``.

:func:`mv` and :func:`mtv` are the solver's batched matvecs.  On a CUDA
float32 (B, m, n) batch of one of the shapes in :data:`MATVEC_ORDERS` they
launch the kernel of ``csrc/matvec.cu``, which gives the bits of the cuBLAS
gemv kernels that ``torch.matmul`` runs there; every other input (CPU
tensors, float64, other orders, one matrix shared by the lanes, a (2, 8)
batch that is not packed) goes to :func:`mv_plain` / :func:`mtv_plain`,
``torch.matmul`` as before.  ``matvec_call_count`` counts the CUDA calls,
``matvec_launch_count`` the kernel's launches among them and
``matvec_launch_shapes`` the same launches by (B, m, n, transposed).
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from .. import _build

#: The sums' orders of ``csrc/matvec.cu`` (its ``Order``): each splits the
#: K terms into chains, FMA chains from +0, and adds the chains' sums.
HALVES, EVEN_ODD, MOD4, QUADS_0213, QUADS_SEQ, PAIRS8 = range(6)

#: cuBLAS splits a batched gemv into launches of at most this many lanes.
CUBLAS_LAUNCH = 65535

#: (m, n, transposed) -> the order of the cuBLAS kernel that ``torch.matmul``
#: picks for a launch of c lanes: that of the last (first c, order) entry
#: with first c <= c.  Found on an H100 for every c in 1 .. 65535 (pair
#: probes, then random inputs bit for bit; torch 2.11, CUDA 12.8).
MATVEC_ORDERS = {
    (2, 8, False): ((1, HALVES), (12998, EVEN_ODD), (37293, HALVES)),
    (8, 8, False): ((1, HALVES), (12998, EVEN_ODD), (37293, HALVES)),
    (14, 8, False): ((1, HALVES), (12998, EVEN_ODD), (37293, HALVES)),
    (14, 14, False): ((1, HALVES), (12998, MOD4)),
    (14, 8, True): ((1, HALVES), (2, QUADS_0213), (127, PAIRS8),
                    (130, HALVES), (150, QUADS_0213), (190, HALVES),
                    (792, QUADS_SEQ), (1336, EVEN_ODD), (2853, HALVES)),
}

#: CUDA ``mv``/``mtv`` calls in this process, kernel or ``torch.matmul``.
matvec_call_count = 0
#: Launches of the kernel among them.
matvec_launch_count = 0
#: The same launches by shape: (B, m, n, transposed) -> launches.
matvec_launch_shapes: dict[tuple[int, int, int, bool], int] = {}
#: Guards the counts and shapes: threads solve slices at once
#: (``parallel.solve_batch_sharded``).
_count_lock = threading.Lock()


def mv_plain(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` per lane by ``torch.matmul``."""
    return (A @ x.unsqueeze(-1)).squeeze(-1)


def mtv_plain(A: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``A.T @ y`` per lane by ``torch.matmul``."""
    return (y.unsqueeze(-2) @ A).squeeze(-2)


def mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` per lane: ``A`` (..., m, n), ``x`` (..., n) -> (..., m)."""
    if A.is_cuda:
        return _on_card(A, x, False)
    return mv_plain(A, x)


def mtv(A: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``A.T @ y`` per lane: ``A`` (..., m, n), ``y`` (..., m) -> (..., n)."""
    if A.is_cuda:
        return _on_card(A, y, True)
    return mtv_plain(A, y)


def kernel_takes(A: torch.Tensor, v: torch.Tensor, trans: bool) -> bool:
    """Whether the matvec kernel computes ``mv(A, v)`` (``mtv`` if
    ``trans``) for these operands on the card: float32, A (B, m, n) with
    its last stride 1 and (m, n, trans) in :data:`MATVEC_ORDERS`, v (B, k)
    of the matching k on A's device, 0 < B < 2**31 - 256.  At (2, 8), which
    the kernel computes one thread a lane with 16-byte loads, both operands
    must besides be packed and 16-byte aligned."""
    if (A.dtype is not torch.float32 or v.dtype is not torch.float32
            or A.dim() != 3 or v.dim() != 2):
        return False
    B, m, n = A.shape
    Bv, k = v.shape
    if not ((m, n, trans) in MATVEC_ORDERS and Bv == B
            and 0 < B < 2 ** 31 - 256 and k == (m if trans else n)
            and A.stride(2) == 1 and v.get_device() == A.get_device()):
        return False
    return m * n > 16 or (A.stride() == (m * n, n, 1) and v.stride() == (n, 1)
                          and A.data_ptr() % 16 == 0
                          and v.data_ptr() % 16 == 0)


@functools.lru_cache(maxsize=1024)
def launch_orders(m: int, n: int, trans: bool, B: int):
    """(order of the full 65535-lane launches, order of the remainder, the
    first lane of the remainder) with which cuBLAS sums a batch of B."""
    table = MATVEC_ORDERS[m, n, trans]

    def order(c):
        return [o for first, o in table if first <= c][-1]
    split = B - B % CUBLAS_LAUNCH
    rem = B - split
    return (order(CUBLAS_LAUNCH) if split else HALVES,
            order(rem) if rem else HALVES, split)


@functools.cache
def _kernel():
    """The C entry point of ``csrc/matvec.cu``, built and loaded on first
    use, pointers and the stream declared as ``c_void_p``."""
    fn = _build.load("matvec").matvec_f32
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _on_card(A: torch.Tensor, v: torch.Tensor, trans: bool) -> torch.Tensor:
    global matvec_call_count, matvec_launch_count
    if not kernel_takes(A, v, trans):
        with _count_lock:
            matvec_call_count += 1
        return mtv_plain(A, v) if trans else mv_plain(A, v)
    B, m, n = A.shape
    out = A.new_empty((B, n if trans else m))
    _launch(A, v, out, trans)
    with _count_lock:
        matvec_call_count += 1
        matvec_launch_count += 1
        shape = (B, m, n, trans)
        matvec_launch_shapes[shape] = matvec_launch_shapes.get(shape, 0) + 1
    return out


def _launch(A, v, out, trans) -> None:
    B, m, n = A.shape
    full, rem, split = launch_orders(m, n, trans, B)
    sA, sv = A.stride(), v.stride()
    card = A.get_device()
    err = _kernel()(A.data_ptr(), v.data_ptr(), out.data_ptr(), B, m, n,
                    trans, sA[0], sA[1], sv[0], sv[1], full, rem, split,
                    card, torch._C._cuda_getCurrentRawStream(card))
    if err != 0:
        raise RuntimeError(f"matvec: kernel launch failed, cudaError {err}")


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
