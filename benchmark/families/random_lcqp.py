"""``random_lcqp``: the randomized warm-up-class batch of ``bench.py``.

``problem`` keys: ``nV``, ``nC``, ``nComp``, ``base_instances`` (K),
``base_seed``, ``g_noise``.  The K instances are drawn on the host from
``default_rng(base_seed)`` exactly as ``bench.py:121-137`` draws its
warm-up fleet (a copy of its ``random_lcqp`` is kept here); each call adds
``g_noise * N(0, 1)`` to every entry of every lane's ``g``.
"""

import numpy as np
import torch

FIELDS = ("Q", "g", "L", "R", "A", "lbA", "ubA")


def random_lcqp(rng: np.random.Generator, nV: int, nC: int,
                nComp: int) -> dict:
    """One strictly convex LCQP with complementarity between disjoint
    coordinate pairs, drawn in the order of ``bench.py``'s
    ``random_lcqp``: ``Q = B B' / nV + I``, ``g``, the pairs, then ``A``
    and its bounds (``lbA < -0.5``, ``ubA > 0.5``, so ``x = 0`` is
    feasible).  Complementarity bounds are ``lbL = lbR = 0``; there is no
    box."""
    B = rng.normal(size=(nV, nV)) / np.sqrt(nV)
    Q = B @ B.T + np.eye(nV)
    g = rng.normal(size=nV)
    idx = rng.permutation(nV)[:2 * nComp]
    L = np.zeros((nComp, nV))
    R = np.zeros((nComp, nV))
    L[np.arange(nComp), idx[:nComp]] = 1.0
    R[np.arange(nComp), idx[nComp:]] = 1.0
    A = rng.normal(size=(nC, nV)) / np.sqrt(nV)
    lbA = -np.abs(rng.normal(size=nC)) - 0.5
    ubA = np.abs(rng.normal(size=nC)) + 0.5
    return dict(Q=Q, g=g, L=L, R=R, A=A, lbA=lbA, ubA=ubA)


def instances(problem: dict) -> dict:
    rng = np.random.default_rng(int(problem["base_seed"]))
    sizes = [int(problem[k]) for k in ("nV", "nC", "nComp")]
    drawn = [random_lcqp(rng, *sizes)
             for _ in range(int(problem["base_instances"]))]
    return {name: np.stack([d[name] for d in drawn]) for name in FIELDS}


def draw(fleet, call: int) -> dict:
    """The lanes' base ``g`` plus ``g_noise`` times a standard normal draw
    of the call's generator."""
    noise = torch.randn((fleet.lanes, fleet.nV),
                        generator=fleet.generator(call),
                        dtype=torch.float64, device=fleet.device)
    return {"g": fleet.lane("g") + float(fleet.problem["g_noise"]) * noise}
