"""CSC sparse-matrix utilities (host-side ingestion layer): the port of
``lcqpow_tpu/ops/csc.py``.

The reference keeps CSC twins of every matrix and converts between dense and
CSC storage (``src/Utilities.cpp:469-650``: ``createCSC``, ``copyCSC`` with
optional upper-triangular extraction for OSQP, ``csc_to_dns``,
``dns_to_csc``).  The port computes on dense tensors, so these utilities
live at the ingestion boundary: they accept the sparse formats LCQPow users
have (raw CSC triples, scipy.sparse) and produce dense NumPy arrays, and
export back for interchange.

NumPy only.  The JAX package may hand the conversions to its C++ host
library (``lcqpow_tpu/native``); every such call there has a NumPy fallback
with the same semantics, and that fallback is what this module is.

Semantics replicated from the reference:

* ``dense_to_csc`` drops exact zeros (``src/Utilities.cpp:632`` keeps entries
  with ``v > 0 || v < 0``);
* ``csc_to_dense`` tolerates padded/short ``indptr`` by stopping at ``nnz``
  (the early-return guard at ``src/Utilities.cpp:602-604``);
* ``csc_upper_triangular`` extracts the upper triangle including the
  diagonal (what the reference hands OSQP as ``P``,
  ``src/Utilities.cpp:512-583``).
"""

from __future__ import annotations

import numpy as np

from ..types import ReturnValue


class CSCMatrix:
    """A minimal CSC triple (column pointers, row indices, values) matching
    the reference's ``csc`` struct usage.  Interoperates with scipy.sparse
    but does not require it."""

    __slots__ = ("m", "n", "indptr", "indices", "data")

    def __init__(self, m: int, n: int, indptr, indices, data):
        self.m = int(m)
        self.n = int(n)
        self.indptr = np.asarray(indptr, dtype=np.int64)
        self.indices = np.asarray(indices, dtype=np.int64)
        self.data = np.asarray(data, dtype=np.float64)

    @property
    def nnz(self) -> int:
        return int(self.indptr[self.n])

    def validate(self) -> ReturnValue:
        """Structural validation, mirroring the argument checks the reference
        performs on CSC input (INVALID_INDEX_POINTER / INVALID_INDEX_ARRAY)."""
        if self.indptr.shape[0] != self.n + 1 or self.indptr[0] != 0 \
                or np.any(np.diff(self.indptr) < 0):
            return ReturnValue.INVALID_INDEX_POINTER
        nnz = self.nnz
        if self.indices.shape[0] < nnz or self.data.shape[0] < nnz:
            return ReturnValue.INVALID_INDEX_ARRAY
        if nnz and (self.indices[:nnz].min() < 0
                    or self.indices[:nnz].max() >= self.m):
            return ReturnValue.INVALID_INDEX_ARRAY
        return ReturnValue.SUCCESSFUL_RETURN

    def toarray(self) -> np.ndarray:
        return csc_to_dense(self)

    @classmethod
    def from_scipy(cls, M) -> "CSCMatrix":
        M = M.tocsc()
        return cls(M.shape[0], M.shape[1], M.indptr, M.indices, M.data)


def csc_to_dense(M: CSCMatrix) -> np.ndarray:
    """CSC -> dense (reference ``csc_to_dns``, ``src/Utilities.cpp:593-615``)."""
    ret = M.validate()
    if ret != ReturnValue.SUCCESSFUL_RETURN:
        raise ValueError(f"invalid CSC matrix: {ret.name}")
    out = np.zeros((M.m, M.n), dtype=np.float64)
    nnz = M.nnz
    cols = np.repeat(np.arange(M.n), np.diff(M.indptr))
    out[M.indices[:nnz], cols] = M.data[:nnz]
    return out


def dense_to_csc(A) -> CSCMatrix:
    """Dense -> CSC, dropping exact zeros (reference ``dns_to_csc``,
    ``src/Utilities.cpp:618-650``; the drop test there is ``v>0 || v<0``,
    which also keeps NaN out — replicated)."""
    A = np.asarray(A, dtype=np.float64)
    m, n = A.shape
    keep = (A > 0) | (A < 0)
    counts = keep.sum(axis=0)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    _, rows = np.nonzero(keep.T)      # column-major order
    return CSCMatrix(m, n, indptr, rows, A.T[keep.T])


def csc_upper_triangular(M: CSCMatrix) -> CSCMatrix:
    """Extract the upper triangle (incl. diagonal) of a CSC matrix — the
    reference's ``copyCSC(..., upperTriangular=true)`` used to build OSQP's
    ``P`` (``src/Utilities.cpp:512-583``)."""
    nnz = M.nnz
    cols = np.repeat(np.arange(M.n), np.diff(M.indptr))
    rows = M.indices[:nnz]
    keep = rows <= cols
    new_counts = np.bincount(cols[keep], minlength=M.n)
    indptr = np.zeros(M.n + 1, dtype=np.int64)
    np.cumsum(new_counts, out=indptr[1:])
    return CSCMatrix(M.m, M.n, indptr, rows[keep], M.data[:nnz][keep])


def create_csc(m: int, n: int, nnz: int, data, indices, indptr
               ) -> CSCMatrix:
    """Assemble-and-validate (reference ``createCSC``,
    ``src/Utilities.cpp:469-491``)."""
    M = CSCMatrix(m, n, indptr, indices, data)
    ret = M.validate()
    if ret != ReturnValue.SUCCESSFUL_RETURN:
        raise ValueError(f"invalid CSC matrix: {ret.name}")
    if M.nnz != nnz:
        raise ValueError(f"indptr says nnz={M.nnz}, caller says {nnz}")
    return M
