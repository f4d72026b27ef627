"""Canonical LCQP workloads: the port's own copy of the NumPy problem
generators of ``lcqpow_tpu/problems.py``.

The draws happen in the same order as there, so one seed gives the same
instances in both packages.
"""

from __future__ import annotations

import numpy as np

from .data import LCQPData, make_lcqp


def warm_up(dtype=None, device=None) -> LCQPData:
    """min ||x - (1,1)||^2  s.t.  0 <= x1 ⟂ x2 >= 0.
    Solutions: (1,0) and (0,1), both S-stationary
    (``test/RunUnitTests.cpp:505-547``)."""
    return make_lcqp(Q=[[2., 0.], [0., 2.]], g=[-2., -2.],
                     L=[[1., 0.]], R=[[0., 1.]], dtype=dtype, device=device)


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
