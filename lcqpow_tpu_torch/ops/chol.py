"""SPD inverses: the port of ``lcqpow_tpu/ops/chol.py``.

Routing follows ``chol._batched_impl`` of the JAX package: a float32 batch
of small matrices (3-D after flattening the leading dims, square,
m <= 48) goes Jacobi scale -> Gauss-Jordan (:mod:`.gj_inverse`, the CUDA
kernel on the card) -> unscale -> guarded Newton-Schulz (none for the
"light" inverse).  Everything else goes to :func:`_spd_inverse_impl`:
Jacobi scale -> matmul-only block recursion -> Newton-Schulz.  An
unbatched (2-D) matrix takes :func:`_spd_inverse_impl`, as an un-vmapped
call does in the JAX package.  Above n = 64 :func:`_spd_inverse_impl`
takes the blocked sweep (:func:`sweep_spd_inverse`) in place of the
recursion, as the JAX package does; the sweep inverts its 32 x 32 pivot
blocks with :func:`block_spd_inverse`, never with the Gauss-Jordan kernel,
so its arithmetic is the reference's.  Everything here but the Gauss-Jordan
kernel is plain PyTorch, as it is plain ``jnp`` there.
"""

from __future__ import annotations

import math

import torch

from .gj_inverse import MAX_M, gj_inverse
from .linalg import eye


def tri_inv_lower(L: torch.Tensor) -> torch.Tensor:
    """Exact inverse of a lower-triangular matrix via log-depth squaring of
    the nilpotent part (``L = D(I - N)``, ``L^-1 = (sum_k N^k) D^-1``).
    Batched over leading dims."""
    n = L.shape[-1]
    d = torch.diagonal(L, dim1=-2, dim2=-1)
    I = eye(n, L)
    N = I - L / d[..., :, None]
    S = I + N
    if n > 2:
        steps = math.ceil(math.log2(n)) - 1
        P = N
        for _ in range(steps):
            P = P @ P
            S = S + P @ S
    return S / d[..., None, :]


def block_spd_inverse(M: torch.Tensor) -> torch.Tensor:
    """Inverse of an SPD matrix via recursive 2x2 block (Schur-complement)
    inversion — matmul and elementwise only.  Batched over leading dims."""
    n = M.shape[-1]
    if n == 1:
        return 1.0 / M
    if n == 2:
        a = M[..., 0, 0]
        b = M[..., 0, 1]
        c = M[..., 1, 0]
        d = M[..., 1, 1]
        det = a * d - b * c
        row0 = torch.stack([d, -b], dim=-1)
        row1 = torch.stack([-c, a], dim=-1)
        return torch.stack([row0, row1], dim=-2) / det[..., None, None]
    k = n // 2
    A = M[..., :k, :k]
    Bt = M[..., :k, k:]
    B = M[..., k:, :k]
    D = M[..., k:, k:]
    Ai = block_spd_inverse(A)
    BAi = B @ Ai
    Si = block_spd_inverse(D - BAi @ Bt)
    TR = -(BAi.mT @ Si)
    TL = Ai - TR @ BAi
    BL = -(Si @ BAi)
    top = torch.cat([TL, TR], dim=-1)
    bot = torch.cat([BL, Si], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _sweep_eager(M: torch.Tensor, block: int) -> torch.Tensor:
    n = M.shape[-1]
    block = min(block, n)
    nb = -(-n // block)
    npad = nb * block
    A = M.new_zeros(M.shape[:-2] + (npad, npad))
    A[..., :n, :n] = M
    # Identity in the padding: inv(blockdiag(M, I)) = blockdiag(Minv, I).
    A.diagonal(dim1=-2, dim2=-1)[..., n:].fill_(1.0)
    for k in range(nb):
        blk = slice(k * block, (k + 1) * block)
        col = A[..., :, blk]
        row = A[..., blk, :]
        Di = block_spd_inverse(A[..., blk, blk])
        G = col @ Di
        Di_row = Di @ row
        # Full rank-b update, then the pivot row, column and block per the
        # sweep formulas: A[i,k] <- A[i,k] Di, A[k,j] <- Di A[k,j],
        # A[k,k] <- -Di, A[i,j] <- A[i,j] - A[i,k] Di A[k,j].
        A = A - G @ row
        A[..., :, blk] = G
        A[..., blk, :] = Di_row
        A[..., blk, blk] = -Di
    return -A[..., :n, :n]


#: CUDA graphs of the sweep, one per (shape, dtype, device, block); the
#: oldest is dropped past ``_SWEEP_GRAPHS_MAX`` (a chunked circle fleet
#: uses a dozen: two orders at its chunk width and at each retry width).
_SWEEP_GRAPHS: dict = {}
_SWEEP_GRAPHS_MAX = 32


def _sweep_graphed(M: torch.Tensor, block: int) -> torch.Tensor:
    """:func:`_sweep_eager` replayed from a CUDA graph captured at the first
    call of each shape: the same kernels in the same order, so the same
    bits, for one launch in place of the ~3000 small ones of a 288-row
    sweep (their host time is what bounds the eager sweep)."""
    key = (tuple(M.shape), M.dtype, M.device, block)
    entry = _SWEEP_GRAPHS.get(key)
    if entry is None:
        x = M.clone()
        side = torch.cuda.Stream(M.device)
        side.wait_stream(torch.cuda.current_stream(M.device))
        with torch.cuda.stream(side):
            _sweep_eager(x, block)      # warm-up outside the capture
        torch.cuda.current_stream(M.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            y = _sweep_eager(x, block)
        if len(_SWEEP_GRAPHS) >= _SWEEP_GRAPHS_MAX:
            _SWEEP_GRAPHS.pop(next(iter(_SWEEP_GRAPHS)))
        entry = _SWEEP_GRAPHS[key] = (graph, x, y)
    graph, x, y = entry
    x.copy_(M)
    graph.replay()
    return y.clone()


def sweep_spd_inverse(M: torch.Tensor, block: int = 32) -> torch.Tensor:
    """SPD inverse via the blocked sweep operator (in-place block
    Gauss-Jordan), batched over leading dims: the medium-``n`` companion of
    :func:`block_spd_inverse`.  The matrix is padded with identity to a
    multiple of ``block``; each step inverts its pivot block with
    :func:`block_spd_inverse` and applies one rank-``block`` update.  No
    pivoting: every pivot block is an SPD Schur complement of the input.
    After all blocks the matrix holds ``-M^-1``.

    On a CUDA tensor the sweep is replayed from a CUDA graph
    (:func:`_sweep_graphed`), unless a graph is being captured already."""
    if M.is_cuda and not torch.cuda.is_current_stream_capturing():
        return _sweep_graphed(M.contiguous(), block)
    return _sweep_eager(M, block)


#: Recursion-vs-sweep crossover of the JAX package.
_SWEEP_THRESHOLD = 64


def _jacobi_scale(M: torch.Tensor):
    """Symmetric Jacobi equilibration ``Ms = D^-1/2 M D^-1/2``; returns
    ``(Ms, d)`` with ``d = sqrt(diag(M))`` (1 where not positive)."""
    d = torch.sqrt(torch.diagonal(M, dim1=-2, dim2=-1))
    d = torch.where(d > 0, d, torch.ones((), dtype=M.dtype, device=M.device))
    return M / (d[..., :, None] * d[..., None, :]), d


def _newton_schulz(M: torch.Tensor, X: torch.Tensor,
                   steps: int) -> torch.Tensor:
    """Guarded Newton-Schulz refinement ``X <- X + X(I - MX)``,
    resymmetrized, keeping per matrix the iterate with the smallest measured
    ``max|I - MX|`` (NaN never wins).  Batched over leading dims."""
    I = eye(M.shape[-1], M)

    def resid(Xc):
        E = I - M @ Xc
        return E, E.abs().amax(dim=(-2, -1), keepdim=True)

    E, e_best = resid(X)
    best = X
    for _ in range(steps):
        X = X + X @ E
        X = 0.5 * (X + X.mT)
        E, e = resid(X)
        better = e < e_best
        best = torch.where(better, X, best)
        e_best = torch.where(better, e, e_best)
    return best


def _ns_steps(dtype) -> int:
    return 2 if dtype == torch.float32 else 1


def _spd_inverse_impl(M: torch.Tensor, ns) -> torch.Tensor:
    Ms, d = _jacobi_scale(M)
    if M.shape[-1] > _SWEEP_THRESHOLD:
        Xs = sweep_spd_inverse(Ms)
    else:
        Xs = block_spd_inverse(Ms)
    X = Xs / (d[..., :, None] * d[..., None, :])
    steps = _ns_steps(M.dtype) if ns is None else ns
    return _newton_schulz(M, X, steps) if steps else X


def _gj_applicable(S: torch.Tensor) -> bool:
    return (S.dtype == torch.float32 and S.ndim == 3
            and S.shape[-1] == S.shape[-2] and 1 <= S.shape[-1] <= MAX_M)


def _batched_impl(S: torch.Tensor, ns) -> torch.Tensor:
    """(B, m, m) SPD inverse: Gauss-Jordan for float32 m <= 48, the block
    recursion otherwise."""
    if not _gj_applicable(S):
        return _spd_inverse_impl(S, ns)
    Ss, d = _jacobi_scale(S)
    X = gj_inverse(Ss.contiguous()) / (d[..., :, None] * d[..., None, :])
    steps = _ns_steps(S.dtype) if ns is None else ns
    return _newton_schulz(S, X, steps) if steps else X


def _routed(M: torch.Tensor, ns) -> torch.Tensor:
    if M.ndim == 2:
        return _spd_inverse_impl(M, ns)
    flat = M.reshape((-1,) + M.shape[-2:])
    return _batched_impl(flat, ns).reshape(M.shape)


def spd_inverse(M: torch.Tensor) -> torch.Tensor:
    """Guarded SPD inverse (Jacobi + GJ/recursion + Newton-Schulz, 2 steps in
    f32, 1 in f64): for one-time factorizations whose error is not removed
    downstream (the ADMM KKT operator, preconditioner Hessians)."""
    return _routed(M, None)


def spd_inverse_light(M: torch.Tensor) -> torch.Tensor:
    """Light SPD inverse (no Newton-Schulz): for active-set Schur inverses
    consumed as preconditioners inside an iterative-refinement loop."""
    return _routed(M, 0)


def spd_inverse_chol(M: torch.Tensor) -> torch.Tensor:
    """Cholesky-route inverse ``W'W`` with ``W = chol(M)^-1``: a cross-check
    of :func:`block_spd_inverse` and :func:`sweep_spd_inverse`."""
    W = tri_inv_lower(torch.linalg.cholesky(M))
    return W.mT @ W


def spd_inverse_factor(M: torch.Tensor) -> torch.Tensor:
    """``W = chol(M)^-1``, so that ``M^-1 = W'W`` (solves applied as two
    matmuls)."""
    return tri_inv_lower(torch.linalg.cholesky(M))
