"""Batched Gauss-Jordan inverse of small SPD matrices: the Hopper kernel
that replaces the Pallas TPU kernel ``lcqpow_tpu/ops/pallas_inverse.py``
(``_gj_kernel``, launched by ``spd_inverse_pallas``).

* :func:`gj_inverse` is the wrapper the solver calls (through
  :mod:`.chol`).  On a CUDA tensor it launches the CUDA kernel in
  ``csrc/gj_inverse.cu`` or raises; on a CPU tensor it runs
  :func:`gj_inverse_plain`.
* :func:`gj_inverse_plain` is the same elimination in plain PyTorch ops, in
  the kernel's order.  Eager PyTorch rounds every product before the
  subtract, and the kernel is built with ``--fmad=false`` to do the same, so
  the two agree bit for bit on the card.
* ``launch_count`` counts the kernel's launches (never the plain version's),
  so a run can show that its main path went through the kernel;
  ``launch_counts`` splits the same launches by matrix order m and
  ``launch_shapes`` by (B, m).

No pivoting: the callers pass Jacobi-scaled, regularized SPD matrices and
refine the result (Newton-Schulz, or the caller's own iterative refinement).
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from .. import _build

#: Largest matrix order the kernel takes (the TPU kernel's ``MAX_M``).
MAX_M = 48

#: Launches of the CUDA kernel in this process.
launch_count = 0
#: The same launches by matrix order: m -> launches.
launch_counts: dict[int, int] = {}
#: The same launches by batch and order: (B, m) -> launches.
launch_shapes: dict[tuple[int, int], int] = {}
#: Guards the counts and shapes: threads launch the kernel at once
#: (``parallel.solve_batch_sharded``).
_count_lock = threading.Lock()


def _count_launch(B: int, m: int) -> None:
    global launch_count
    with _count_lock:
        launch_count += 1
        launch_counts[m] = launch_counts.get(m, 0) + 1
        launch_shapes[B, m] = launch_shapes.get((B, m), 0) + 1


@functools.cache
def _kernel():
    """The C entry point of ``csrc/gj_inverse.cu``, built and loaded on
    first use, with its argument types declared (pointers and the stream as
    ``c_void_p``, so ctypes does not cut them to 32 bits).  Two threads may
    both run this at their first launch: ``_build.load`` holds a lock and
    loads the library once, so both get the same function."""
    fn = _build.load("gj").gj_inverse_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def gj_inverse_plain(S: torch.Tensor) -> torch.Tensor:
    """Unpivoted Gauss-Jordan inverse of each (m, m) matrix of ``S``
    (shape (B, m, m)), in plain PyTorch ops, in the kernel's order."""
    m = S.shape[-1]
    M = S.clone()
    I = torch.eye(m, dtype=S.dtype, device=S.device).expand_as(S).clone()
    for k in range(m):
        r = torch.reciprocal(M[:, k, k])[:, None]
        rowM = M[:, k, :] * r
        rowI = I[:, k, :] * r
        f = M[:, :, k].clone()
        f[:, k] = 0.0
        M = M - f[:, :, None] * rowM[:, None, :]
        I = I - f[:, :, None] * rowI[:, None, :]
        M[:, k, :] = rowM
        I[:, k, :] = rowI
    return I


def gj_inverse(S: torch.Tensor) -> torch.Tensor:
    """Batched inverse of (B, m, m) SPD matrices, m <= ``MAX_M``.

    A CPU tensor goes to :func:`gj_inverse_plain`.  A CUDA tensor must be
    float32, contiguous, 3-D and square with m <= ``MAX_M``; anything else
    raises (the callers route such inputs elsewhere first).
    """
    if S.device.type == "cpu":
        return gj_inverse_plain(S)
    if S.device.type != "cuda":
        raise ValueError(f"gj_inverse: unsupported device {S.device}")
    if S.dtype != torch.float32:
        raise ValueError(f"gj_inverse: needs float32, got {S.dtype}")
    if S.ndim != 3 or S.shape[-1] != S.shape[-2]:
        raise ValueError(f"gj_inverse: needs (B, m, m), got {tuple(S.shape)}")
    m = S.shape[-1]
    if not 1 <= m <= MAX_M:
        raise ValueError(f"gj_inverse: needs 1 <= m <= {MAX_M}, got {m}")
    if not S.is_contiguous():
        raise ValueError("gj_inverse: needs a contiguous tensor")
    if S.shape[0] >= 2 ** 31:
        raise ValueError("gj_inverse: batch over the kernel's int range")
    out = torch.empty_like(S)
    if S.shape[0] == 0:
        return out
    launch = _kernel()
    with torch.cuda.device(S.device):
        stream = torch.cuda.current_stream(S.device).cuda_stream
        err = launch(S.data_ptr(), out.data_ptr(), S.shape[0], m, stream)
    if err != 0:
        raise RuntimeError(f"gj_inverse: kernel launch failed, cudaError {err}")
    _count_launch(S.shape[0], m)
    return out
