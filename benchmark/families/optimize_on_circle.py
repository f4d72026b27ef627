"""``optimize_on_circle``: LCQPow's ``examples/OptimizeOnCircle.cpp``,
each lane projecting a target of its own onto the unit circle,
discretized as N vertices with complementarity-based vertex selection:

    min (x - ref)' W (x - ref),  W = [[17, -15], [-15, 17]]
    s.t. cos_i x1 + sin_i x2 + lambda_i = 1        (i < N)
         sum_i theta_i = 1
         0 <= lambda_i ⟂ theta_i >= 0

``problem`` keys: ``N``, ``x_ref`` (default ``[0.5, -0.6]``),
``target_noise`` (default 0.05).  One base instance (K = 1), with the
reference's 5e-12 regularization of the lifted variables
(``OptimizeOnCircle.cpp:67-68``).  Each call draws every lane's target
``ref = x_ref + target_noise * N(0, 1)``, as ``bench.py:139-154`` does
once: ``g[:2] = -W ref``, the lifted entries of ``g`` stay 0, and the lane
starts from the lifted point of ``OptimizeOnCircle.cpp`` with ``x0[:2] =
ref``.  The benchmark's own copy of the program's ``optimize_on_circle``.
"""

import numpy as np
import torch

FIELDS = ("Q", "g", "L", "R", "A", "lbA", "ubA")
W = np.array([[17., -15.], [-15., 17.]])
X_REF = (0.5, -0.6)
TARGET_NOISE = 0.05


def circle(N: int, x_ref) -> dict:
    """The instance at target ``x_ref``; its lifted start is 1 in every
    entry past the first two (``lambda_i = theta_i = 1``)."""
    nV, nC, nComp = 2 + 2 * N, N + 1, N
    Q = np.zeros((nV, nV))
    Q[:2, :2] = W
    Q[np.arange(2, nV), np.arange(2, nV)] = 5e-12
    g = np.zeros(nV)
    g[:2] = -(W @ np.asarray(x_ref, dtype=np.float64))
    A = np.zeros((nC, nV))
    L = np.zeros((nComp, nV))
    R = np.zeros((nComp, nV))
    i = np.arange(N)
    A[i, 0] = np.cos(2 * np.pi * i / N)
    A[i, 1] = np.sin(2 * np.pi * i / N)
    A[i, 2 + 2 * i] = 1.0
    A[N, 3 + 2 * i] = 1.0
    L[i, 2 + 2 * i] = 1.0
    R[i, 3 + 2 * i] = 1.0
    lbA = np.ones(nC)
    ubA = np.ones(nC)
    return dict(Q=Q, g=g, L=L, R=R, A=A, lbA=lbA, ubA=ubA)


def instances(problem: dict) -> dict:
    one = circle(int(problem["N"]), problem.get("x_ref", X_REF))
    return {name: one[name][None] for name in FIELDS}


def draw(fleet, call: int) -> dict:
    """Every lane's target from the call's generator; its ``g`` and its
    lifted start."""
    dev = fleet.device
    noise = torch.randn((fleet.lanes, 2), generator=fleet.generator(call),
                        dtype=torch.float64, device=dev)
    ref = torch.tensor(fleet.problem.get("x_ref", X_REF),
                       dtype=torch.float64, device=dev) \
        + float(fleet.problem.get("target_noise", TARGET_NOISE)) * noise
    g = fleet.lane("g")
    g[:, :2] = -(ref @ torch.as_tensor(W, device=dev).T)
    x0 = torch.ones((fleet.lanes, fleet.nV), dtype=torch.float64,
                    device=dev)
    x0[:, :2] = ref
    return {"g": g, "x0": x0}
