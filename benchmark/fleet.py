"""The benchmark's generator of LCQP fleets, driven by a configuration's
``problem`` block and a traffic mix, and seeded by ``--seed``.

A fleet is ``base_instances`` random LCQPs drawn on the host from the
configuration's ``base_seed`` exactly as ``bench.py`` draws its warm-up
fleet (``default_rng(0)``; a copy of its ``random_lcqp`` is kept here, so
that a change to the program's own generators does not move the
yardstick), tiled over the lanes, each instance on the same number of
lanes, in an order drawn from the seed; and a fresh per-lane perturbation
``g += g_noise * N(0, 1)`` for every call, drawn on the device from
``(seed, call index)``.  Every seed solves the same set of instances, so
the seed changes the draws and the order and not the amount of work; the
same seed gives the same inputs.

Nothing here imports the program: the reference (:mod:`reference`) reads
the same arrays.
"""

from __future__ import annotations

import numpy as np
import torch


def _entropy(seed: int, *words: int) -> list[int]:
    """Words of a ``SeedSequence`` for a signed seed of any size."""
    s = int(seed)
    return [abs(s), int(s < 0), *words]


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


class Fleet:
    """The fleet of one run: base instances (float64, on ``device``), the
    lane-to-instance map, and each call's ``g``."""

    def __init__(self, problem: dict, lanes: int, seed: int, device):
        if problem.get("family") != "random_lcqp":
            raise ValueError(f"unknown problem family {problem.get('family')!r}")
        self.seed = int(seed)
        self.lanes = int(lanes)
        self.nV, self.nC, self.nComp = (int(problem[k]) for k in
                                        ("nV", "nC", "nComp"))
        self.g_noise = float(problem["g_noise"])
        k = int(problem["base_instances"])
        rng = np.random.default_rng(int(problem["base_seed"]))
        drawn = [random_lcqp(rng, self.nV, self.nC, self.nComp)
                 for _ in range(k)]
        self.device = torch.device(device)
        #: name -> (K, ...) float64 tensor on the device.
        self.base = {name: torch.as_tensor(np.stack([d[name] for d in drawn]),
                                           dtype=torch.float64,
                                           device=self.device)
                     for name in drawn[0]}
        #: (lanes,) base instance of each lane: lane i of ``bench.py``'s
        #: tiling (instance i % k), in the seed's order.
        order = torch.randperm(self.lanes, generator=self._generator(0),
                               device=self.device)
        self.instance = order % k

    def lane(self, name: str) -> torch.Tensor:
        """Field ``name`` of the base instances, one row per lane."""
        return self.base[name].index_select(0, self.instance)

    def g(self, call: int) -> torch.Tensor:
        """(lanes, nV) float64 ``g`` of call ``call``: the lanes' base
        ``g`` plus ``g_noise`` times a standard normal draw of its own
        generator on the device."""
        noise = torch.randn((self.lanes, self.nV),
                            generator=self._generator(1, call),
                            dtype=torch.float64, device=self.device)
        return self.lane("g") + self.g_noise * noise

    def _generator(self, *words: int) -> torch.Generator:
        """A generator on the device seeded from the run's seed and
        ``words``."""
        state = np.random.SeedSequence(_entropy(self.seed, *words)) \
            .generate_state(2, np.uint32)
        gen = torch.Generator(device=self.device)
        gen.manual_seed((int(state[0]) << 31) ^ int(state[1]))
        return gen
