"""Counter-based random keys, as ``jax.random`` makes them: the port of the
``jax.random`` calls of the JAX package, and the per-pass draw of the step
perturbation (``perturbStep``, ``src/LCQProblem.cpp:1353-1362``).

The JAX package seeds ``PRNGKey(options.seed)``, gives every lane of a
fleet its own key (``jax.random.split(key, batch)``, ``batch.py:104-106``,
``mixed.py:970-972``), and every homotopy pass of a lane splits that key and
draws ``randint(sub, (n,), -1, 2)`` (``solver.py:496-499``).  Escalation
round ``r`` folds ``r + 1`` into the root key (``mixed.py:1079,1154``).
Here the same functions give the same bits, so a lane's draws depend only
on the seed and the lane's fleet index, whatever the chunking, sharding or
retry the fleet goes through.

Each function copies one routine of JAX 0.9.0 with
``jax_threefry_partitionable`` on (its default) and x64 on (the JAX
package's setting):

* :func:`threefry2x32`: the hash ``threefry2x32_p``
  (``jax/_src/prng.py:_threefry2x32_lowering``);
* :func:`prng_key`: ``jax.random.PRNGKey`` (``threefry_seed``,
  ``prng.py:802``), a 64-bit seed as [high word, low word];
* :func:`split`: the fold-like split, ``prng.py:1156``;
* :func:`fold_in`: ``prng.py:1163``;
* :func:`random_bits`: the partitionable variant at 64 bits,
  ``prng.py:1184``;
* :func:`randint`: ``jax/_src/random.py:581`` (``_randint``) at its default
  int64 type: two 64-bit words per element reduced mod the span.

Words are uint32 values held in int64 tensors: every operation masks with
``0xFFFFFFFF`` and rotations are shift-or pairs, so no signed overflow
occurs.  A key is a (..., 2) tensor; the functions map over its leading
axes, as ``vmap`` over the JAX functions does.

:func:`lane_keys`, :func:`root_key` and :func:`fleet_keys` turn the key
arguments of the entry points into keys on a device: one module decides how
a fleet's root key is split over its lanes, whatever entry point, chunk,
slice or rank solves them.

:func:`perturb_apply` is the solver's whole step perturbation of a pass for
a fleet: the draw, its scaled add to the iterate of the lanes still going,
and the keys' carry.  On a CUDA tensor it launches the kernel in
``csrc/threefry.cu`` once (where the plain version takes some 750 small
ops) or raises; on a CPU tensor it runs :func:`perturb_apply_plain`.  The
draw is integer-only and its product with ``eps`` exact, so the two agree
bit for bit.  The solver checks its tensors once a solve
(:func:`perturbation`) and launches unchecked once a pass.
``launch_count`` counts the kernel's launches, never the plain version's,
and ``launch_shapes`` splits them by (B, n).
"""

from __future__ import annotations

import ctypes
import functools
import threading

import numpy as np
import torch

from . import _build

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

#: Launches of the CUDA kernel in this process.
launch_count = 0
#: The same launches by shape: (B, n) -> launches.
launch_shapes: dict[tuple[int, int], int] = {}
#: Guards both counts: threads launch the kernel at once
#: (``parallel.solve_batch_sharded``).
_count_lock = threading.Lock()


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash of the count pairs ``(x1, x2)`` under the key
    ``(k1, k2)`` (20 rounds); every argument an int64 tensor of uint32 words
    or a Python int, broadcast together.  Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    a = (x1 + ks[0]) & MASK
    b = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & MASK
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & MASK
        b = (b + ks[(i + 2) % 3] + i + 1) & MASK
    return a, b


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` under x64: the seed as a 64-bit two's
    complement word, high word first.  Built on ``device`` by fills, with
    no copy from the host."""
    seed = int(seed)
    if not -2 ** 63 <= seed < 2 ** 63:
        raise OverflowError(f"seed {seed} does not fit in int64")
    seed &= 2 ** 64 - 1
    key = torch.empty(2, dtype=torch.int64, device=device)
    key[0].fill_(seed >> 32)
    key[1].fill_(seed & MASK)
    return key


def _words(key: torch.Tensor):
    """The two words of ``key`` with a trailing axis of 1 for the counts."""
    return key[..., 0, None], key[..., 1, None]


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``, fold-like: key ``i`` is the hash of
    the count pair (0, i).  ``key`` (..., 2) -> (..., num, 2)."""
    k1, k2 = _words(key)
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    a, b = threefry2x32(k1, k2, 0, i)
    return torch.stack([a, b], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: ``data`` as uint32, hashed as the
    count pair (0, data).  ``key`` (..., 2) -> (..., 2)."""
    a, b = threefry2x32(key[..., 0], key[..., 1], 0, int(data) & MASK)
    return torch.stack([a, b], dim=-1)


def random_bits(key: torch.Tensor, shape: tuple):
    """``jax.random.bits``' partitionable path at 64 bits, the only width
    ``randint``'s int64 draws use: element ``j`` (flat index) hashes the
    count pair (j >> 32, j & MASK) and its uint64 is (first word << 32) |
    second word.  ``key`` (..., 2); returns the (high, low) words, each of
    shape ``key.shape[:-1] + shape``."""
    size = 1
    for s in shape:
        size *= int(s)
    j = torch.arange(size, dtype=torch.int64, device=key.device)
    k1, k2 = _words(key)
    a, b = threefry2x32(k1, k2, j >> 32, j & MASK)
    out = key.shape[:-1] + tuple(shape)
    return a.reshape(out), b.reshape(out)


def _mod_u64(hi: torch.Tensor, lo: torch.Tensor, span: int) -> torch.Tensor:
    """(hi * 2^32 + lo) mod ``span`` for the unsigned 64-bit word of two
    uint32 halves, ``span`` < 2^31 (no product reaches 2^63)."""
    return ((hi % span) * (2 ** 32 % span) + lo % span) % span


def randint(key: torch.Tensor, shape: tuple, minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` at the default
    int64 type: the key is split in two, each half draws 64 random bits per
    element (``higher_bits``, ``lower_bits``), and the offset is
    ``(higher mod s * m + lower mod s) mod s`` with the multiplier
    ``m = (2^32 mod s)^2 mod s``, as ``_randint`` computes it in uint64;
    ``s`` is the span (1 when ``maxval <= minval``), up to 2^31 - 1."""
    span = maxval - minval if maxval > minval else 1
    if span >= 2 ** 31:
        raise ValueError(f"randint: span {span} over 2^31 - 1")
    keys = split(key, 2)
    hi = random_bits(keys[..., 0, :], shape)
    lo = random_bits(keys[..., 1, :], shape)
    multiplier = (2 ** 32 % span) ** 2 % span
    offset = (_mod_u64(*hi, span) * multiplier + _mod_u64(*lo, span)) % span
    return minval + offset


def lane_keys(key, batch: int, seed: int, device) -> torch.Tensor:
    """The (batch, 2) int64 Threefry keys of a solve's lanes on ``device``:
    ``key`` of shape (batch, 2) as given, one key of shape (2,) for every
    lane, and ``prng_key(seed)`` for every lane when ``key`` is None (what
    ``vmap`` over the JAX package's ``solve`` gives without a key).  A key
    may be a tensor or an array-like of uint32 words (a JAX key array)."""
    if key is None:
        key = prng_key(seed, device)
    elif not isinstance(key, torch.Tensor):
        key = torch.from_numpy(np.asarray(key).astype(np.int64))
    key = key.to(device=device, dtype=torch.int64)
    if key.shape == (2,):
        key = key.expand(batch, 2)
    if key.shape != (batch, 2):
        raise ValueError(f"key: needs shape (2,) or ({batch}, 2), got "
                         f"{tuple(key.shape)}")
    return key.contiguous()


def root_key(key, seed: int, device) -> torch.Tensor:
    """One (2,) key on ``device``: ``key`` (an array-like of two uint32
    words), or ``prng_key(seed)`` when it is None."""
    return lane_keys(key, 1, seed, device)[0]


def fleet_keys(key, seed: int, total: int, device,
               offset: int = 0) -> torch.Tensor:
    """The (total - offset, 2) keys of lanes ``offset`` to ``total - 1`` of
    a fleet: the root ``key`` (:func:`root_key`) split over ``total``
    lanes, as the JAX package splits its key over a batch
    (``batch.py:104-106``, ``mixed.py:970-972``) and over a sharded one
    (``parallel/sharding.py:57-69``).  A split's first keys do not depend
    on its length, so a lane's key depends only on the root key and the
    lane's index in the fleet, whatever chunk, slice or rank solves it, and
    a rank whose lanes start at ``offset`` needs only ``total = offset +``
    its lane count."""
    return split(root_key(key, seed, device), total)[offset:]


def perturb_step_plain(keys: torch.Tensor, active: torch.Tensor, n: int):
    """One homotopy pass's draw for every lane, in plain PyTorch ops: an
    active lane splits its key (``key, sub = split(key)``), keeps the first
    and draws ``randint(sub, (n,), -1, 2)`` from the second; a lane that is
    not active keeps its key and draws zeros.  ``keys`` (B, 2) int64,
    ``active`` (B,) bool; returns (keys', r), r (B, n) int64."""
    pair = split(keys, 2)
    r = randint(pair[:, 1], (n,), -1, 2)
    keys_out = torch.where(active[:, None], pair[:, 0], keys)
    return keys_out, torch.where(active[:, None], r, 0)


def perturb_apply_plain(keys: torch.Tensor, go: torch.Tensor,
                        xk: torch.Tensor, eps: float):
    """One homotopy pass's whole step perturbation for every lane, in plain
    PyTorch ops: :func:`perturb_step_plain`'s draw, then a going lane's
    iterate ``xk + r.to(dtype) * eps`` (through the add even where r = 0,
    so -0 becomes +0 there, as the JAX package's add does); a lane that is
    not going keeps its key and its iterate bit for bit.  ``keys`` (B, 2)
    int64, ``go`` (B,) bool, ``xk`` (B, n) float; returns (keys', x)."""
    keys_out, r = perturb_step_plain(keys, go, xk.shape[-1])
    return keys_out, torch.where(go[:, None], xk + r.to(xk.dtype) * eps, xk)


def _count_launch(B: int, n: int) -> None:
    global launch_count
    with _count_lock:
        launch_count += 1
        launch_shapes[B, n] = launch_shapes.get((B, n), 0) + 1


@functools.cache
def _kernel():
    """The C entry point of ``csrc/threefry.cu``, built and loaded on first
    use, pointers and the stream declared as ``c_void_p``."""
    fn = _build.load("threefry").threefry_perturb_apply
    fn.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def perturbation(keys: torch.Tensor, xk: torch.Tensor, eps: float):
    """The pass's perturbation for one solve: returns ``step(keys, go, xk)
    -> (keys', x)``, :func:`perturb_apply_plain` with this ``eps`` on
    tensors of the shapes, type and device of ``keys`` (B, 2) and ``xk``
    (B, n).  For CPU tensors ``step`` runs the plain version.  For CUDA
    tensors this checks them once (contiguous, on one card, ``xk`` float32
    or float64) and takes the thread's current stream there; ``step`` then
    checks nothing and launches the kernel of ``csrc/threefry.cu`` once a
    call on that stream.  Its callers hand it a (B,) bool ``go`` on the
    same card and contiguous tensors of the checked shapes and types, as
    the solver's pass does; :func:`perturb_apply` is the checked call."""
    eps = float(eps)
    if keys.device.type == "cpu":
        return lambda k, go, x: perturb_apply_plain(k, go, x, eps)
    if keys.device.type != "cuda":
        raise ValueError(f"perturbation: unsupported device {keys.device}")
    if keys.dtype != torch.int64 or keys.ndim != 2 or keys.shape[1] != 2:
        raise ValueError(f"perturbation: needs (B, 2) int64 keys, got "
                         f"{tuple(keys.shape)} {keys.dtype}")
    B = keys.shape[0]
    if (xk.dtype not in (torch.float32, torch.float64) or xk.ndim != 2
            or xk.shape[0] != B or xk.device != keys.device):
        raise ValueError(f"perturbation: needs a ({B}, n) float32 or float64 "
                         f"xk on {keys.device}, got {tuple(xk.shape)} "
                         f"{xk.dtype} on {xk.device}")
    if not (keys.is_contiguous() and xk.is_contiguous()):
        raise ValueError("perturbation: needs contiguous tensors")
    n = xk.shape[1]
    if B * max(n, 1) >= 2 ** 31:
        raise ValueError(f"perturbation: B * n over the kernel's int range "
                         f"(B={B}, n={n})")
    if B == 0:
        return lambda k, go, x: (torch.empty_like(k), torch.empty_like(x))
    fn = _kernel()
    f64 = int(xk.dtype == torch.float64)
    card = keys.device.index
    stream = torch.cuda.current_stream(keys.device).cuda_stream

    def step(k, go, x):
        keys_out = torch.empty_like(k)
        out = torch.empty_like(x)
        err = fn(k.data_ptr(), go.data_ptr(), x.data_ptr(),
                 keys_out.data_ptr(), out.data_ptr(), B, n, eps, f64, card,
                 stream)
        if err != 0:
            raise RuntimeError(f"perturb_apply: kernel launch failed, "
                               f"cudaError {err}")
        _count_launch(B, n)
        return keys_out, out

    return step


def perturb_apply(keys: torch.Tensor, go: torch.Tensor, xk: torch.Tensor,
                  eps: float):
    """:func:`perturb_apply_plain`'s result: by the plain version for CPU
    tensors, by one launch of the CUDA kernel for CUDA tensors, which must
    be a contiguous (B, 2) int64 ``keys``, a (B,) bool ``go`` and a (B, n)
    float32 or float64 ``xk`` on one card; anything else raises.  Every
    call is checked (:func:`perturbation`, once a solve, is not)."""
    step = perturbation(keys, xk, eps)
    if keys.device.type == "cuda" and not (
            go.dtype == torch.bool and tuple(go.shape) == (keys.shape[0],)
            and go.device == keys.device and go.is_contiguous()):
        raise ValueError(f"perturb_apply: needs a contiguous "
                         f"({keys.shape[0]},) bool go on {keys.device}, got "
                         f"{tuple(go.shape)} {go.dtype} on {go.device}")
    return step(keys, go, xk)
