"""Problem file I/O: the port of ``lcqpow_tpu/io.py``.

Reference: ``Utilities::readFromFile/writeToFile``
(``src/Utilities.cpp:312-395``) read/write whitespace-separated doubles; the
file-loading ``loadLCQP`` overload (``src/LCQProblem.cpp:147-387``) reads
each array from its own file with dimensions known a priori, and the example
program infers them by counting values
(``examples/solve_lcqp_from_file.cpp:63-98``: nV=len(g), nC=len(lbA),
nComp=len(lbL)).  This module reproduces that format so the reference's
``examples/example_data/*.txt`` load unchanged.  Reading and writing are
NumPy, the fallback path of the JAX package's reader and writer.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from .data import LCQPData, make_lcqp


def read_vector(path: str) -> np.ndarray:
    """Whitespace-separated doubles, any line structure."""
    with open(path) as f:
        return np.array([float(t) for t in f.read().split()], dtype=np.float64)


def write_vector(path: str, values) -> None:
    """One double per line, 17 significant digits (round-trips exactly)."""
    vals = np.asarray(values, dtype=np.float64).reshape(-1)
    with open(path, "w") as f:
        f.write("\n".join(f"{v:.17g}" for v in vals))
        f.write("\n")


def _maybe(path: Optional[str]) -> Optional[np.ndarray]:
    if path is None or not os.path.exists(path):
        return None
    return read_vector(path)


def load_lcqp_from_files(directory: str, *, dtype=None,
                         names: Optional[dict] = None,
                         as_numpy: bool = False, device=None) -> LCQPData:
    """Load an LCQP from a directory of ``.txt`` files using the reference's
    file layout (``Q.txt g.txt L.txt R.txt [lbL ubL lbR ubR A lbA ubA lb ub]``).

    Dimensions are inferred the same way the reference example does:
    ``nV = len(g)``, ``nC = len(lbA)`` (0 if absent), ``nComp = len(lbL)``
    (falls back to ``len(L)/nV``).  Built by :func:`data.make_lcqp`, on
    ``device`` (default: the CUDA card), or as NumPy with ``as_numpy``.
    """
    nm = {k: f"{k}.txt" for k in
          ("Q", "g", "L", "R", "lbL", "ubL", "lbR", "ubR",
           "A", "lbA", "ubA", "lb", "ub", "x0")}
    if names:
        nm.update(names)
    p = lambda k: os.path.join(directory, nm[k])

    g = read_vector(p("g"))
    nV = g.shape[0]
    Q = read_vector(p("Q")).reshape(nV, nV)
    L = read_vector(p("L")).reshape(-1, nV)
    R = read_vector(p("R")).reshape(-1, nV)

    A = _maybe(p("A"))
    if A is not None:
        A = A.reshape(-1, nV)

    return make_lcqp(
        Q, g, L, R,
        lbL=_maybe(p("lbL")), ubL=_maybe(p("ubL")),
        lbR=_maybe(p("lbR")), ubR=_maybe(p("ubR")),
        A=A, lbA=_maybe(p("lbA")), ubA=_maybe(p("ubA")),
        lb=_maybe(p("lb")), ub=_maybe(p("ub")),
        dtype=dtype, as_numpy=as_numpy, device=device,
    )


def load_x0_from_files(directory: str) -> Optional[np.ndarray]:
    return _maybe(os.path.join(directory, "x0.txt"))
