"""Canonical LCQP workloads: the port's own copy of the NumPy problem
generators of ``lcqpow_tpu/problems.py``, and the fleets of the JAX
package's benchmark (``bench.py``) built from them.

The draws happen in the same order as there, so one seed gives the same
instances in both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from .data import LCQPData, make_lcqp


def warm_up(dtype=None, device=None) -> LCQPData:
    """min ||x - (1,1)||^2  s.t.  0 <= x1 ⟂ x2 >= 0.
    Solutions: (1,0) and (0,1), both S-stationary
    (``test/RunUnitTests.cpp:505-547``)."""
    return make_lcqp(Q=[[2., 0.], [0., 2.]], g=[-2., -2.],
                     L=[[1., 0.]], R=[[0., 1.]], dtype=dtype, device=device)


def optimize_on_circle(N: int = 100, x_ref=(0.5, -0.6), dtype=None,
                       as_numpy: bool = False, device=None):
    """Project ``x_ref`` onto the unit circle discretized as N vertices with
    complementarity-based vertex selection (LCQPow's
    ``examples/OptimizeOnCircle.cpp``):

        min (x-x_ref)' W (x-x_ref),  W = [[17,-15],[-15,17]]
        s.t. cos_i x1 + sin_i x2 + lambda_i = 1        (i < N)
             sum_i theta_i = 1
             0 <= lambda_i ⟂ theta_i >= 0

    Returns ``(data, x0)``, ``x0`` the lifted feasible start (a NumPy array
    with ``as_numpy``, else a tensor beside ``data``).  For N=100 the global
    solution is x* ~ (0.1811, -0.9835); another local solution
    ~ (0.9764, -0.2183) (``OptimizeOnCircle.cpp:144-145``).
    """
    nV = 2 + 2 * N
    nC = N + 1
    nComp = N
    W = np.array([[17., -15.], [-15., 17.]])

    Q = np.zeros((nV, nV))
    Q[:2, :2] = W
    # Tiny regularization on the lifted variables (OptimizeOnCircle.cpp:67-68).
    for i in range(2, nV):
        Q[i, i] = 5e-12

    g = np.zeros(nV)
    g[:2] = -(W @ np.asarray(x_ref))

    A = np.zeros((nC, nV))
    L = np.zeros((nComp, nV))
    R = np.zeros((nComp, nV))
    lbA = np.zeros(nC)
    ubA = np.zeros(nC)
    x0 = np.zeros(nV)
    x0[:2] = x_ref

    for i in range(N):
        A[i, 0] = np.cos(2 * np.pi * i / N)
        A[i, 1] = np.sin(2 * np.pi * i / N)
        A[i, 2 + 2 * i] = 1.0       # lambda_i
        A[N, 3 + 2 * i] = 1.0       # sum theta = 1
        L[i, 2 + 2 * i] = 1.0
        R[i, 3 + 2 * i] = 1.0
        lbA[i] = 1.0
        ubA[i] = 1.0
        x0[2 + 2 * i] = 1.0
        x0[3 + 2 * i] = 1.0
    lbA[N] = 1.0
    ubA[N] = 1.0

    data = make_lcqp(Q, g, L, R, A=A, lbA=lbA, ubA=ubA, dtype=dtype,
                     as_numpy=as_numpy, device=device)
    if as_numpy:
        return data, x0
    return data, torch.as_tensor(x0, dtype=data.Q.dtype, device=data.Q.device)


def random_lcqp(key: np.random.Generator | int, nV: int = 8, nC: int = 2,
                nComp: int = 2, dtype=None, as_numpy: bool = False,
                device=None) -> LCQPData:
    """Random strictly-convex LCQP with complementarity between selected
    coordinate pairs — the warm-up-class randomized family used for
    throughput benchmarking."""
    rng = np.random.default_rng(key) if isinstance(key, int) else key
    B = rng.normal(size=(nV, nV)) / np.sqrt(nV)
    Q = B @ B.T + np.eye(nV)
    g = rng.normal(size=nV)
    # Complementarity between disjoint coordinate pairs.
    idx = rng.permutation(nV)[:2 * nComp]
    L = np.zeros((nComp, nV))
    R = np.zeros((nComp, nV))
    L[np.arange(nComp), idx[:nComp]] = 1.0
    R[np.arange(nComp), idx[nComp:]] = 1.0
    A = rng.normal(size=(nC, nV)) / np.sqrt(nV) if nC else None
    lbA = -np.abs(rng.normal(size=nC)) - 0.5 if nC else None
    ubA = np.abs(rng.normal(size=nC)) + 0.5 if nC else None
    return make_lcqp(Q, g, L, R, A=A, lbA=lbA, ubA=ubA, dtype=dtype,
                     as_numpy=as_numpy, device=device)


def warmup_fleet(B: int, device=None) -> LCQPData:
    """The warm-up-class fleet of the JAX package's headline benchmark
    (``bench.py:121-137``): 64 ``random_lcqp(nV=8, nC=2, nComp=2)``
    instances from ``default_rng(0)``, tiled to ``B`` lanes, with
    ``g += 0.01 * N(0, 1)`` per lane.  Assembled in NumPy, moved once."""
    from .convert import lcqp_from_numpy

    rng = np.random.default_rng(0)
    problems = [random_lcqp(rng, nV=8, nC=2, nComp=2, as_numpy=True)
                for _ in range(64)]
    reps = -(-B // 64)
    fields = {}
    for name in LCQPData.__dataclass_fields__:
        base = np.stack([np.asarray(getattr(p, name)) for p in problems])
        fields[name] = np.tile(base, (reps,) + (1,) * (base.ndim - 1))[:B]
    fields["g"] = fields["g"] + 0.01 * rng.normal(size=(B, 8))
    return lcqp_from_numpy(fields, device)


def circle_fleet(B: int, device=None):
    """The circle fleet of the JAX package's benchmark
    (``bench.py:139-154``): ``optimize_on_circle(100)`` tiled to ``B`` lanes,
    each projecting its own target ``(0.5, -0.6) + 0.05 * N(0, 1)`` from
    ``default_rng(1)`` and started from its own lifted point.  Returns
    ``(data, x0)``; assembled in NumPy, moved once."""
    from .convert import lcqp_from_numpy

    rng = np.random.default_rng(1)
    data, x0 = optimize_on_circle(100, as_numpy=True)
    W = np.array([[17., -15.], [-15., 17.]])
    refs = np.array([0.5, -0.6]) + 0.05 * rng.normal(size=(B, 2))
    fields = {name: np.tile(np.asarray(getattr(data, name)),
                            (B,) + (1,) * np.ndim(getattr(data, name)))
              for name in LCQPData.__dataclass_fields__}
    fields["g"][:, :2] = -(refs @ W.T)
    x0b = np.tile(x0, (B, 1))
    x0b[:, :2] = refs
    batch = lcqp_from_numpy(fields, device)
    return batch, torch.as_tensor(x0b, device=batch.Q.device)
