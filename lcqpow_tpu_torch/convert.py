"""Carry problem data and options across from the JAX package.

The JAX package's ``LCQPData`` and ``Options`` are the reference; these
functions turn their fields, handed over as NumPy arrays and plain values,
into the port's types.  Nothing of the JAX package is imported here: the
caller does the JAX-side ``np.asarray`` / ``dataclasses.asdict``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import _config
from .data import LCQPData
from .options import ADMMOptions, Options
from .types import PrintLevel, QPSolver


def lcqp_from_numpy(fields: dict, device=None) -> LCQPData:
    """``LCQPData`` from a mapping of field name to array (all 16 fields of
    the JAX ``LCQPData``, batched or not).  Dtypes are kept; the tensors go
    to ``device`` (default: the CUDA card)."""
    names = [f.name for f in dataclasses.fields(LCQPData)]
    missing = set(names) - set(fields)
    if missing:
        raise KeyError(f"LCQPData fields missing: {sorted(missing)}")
    dev = _config.default_device(device)
    return LCQPData(**{n: torch.tensor(np.asarray(fields[n]), device=dev)
                       for n in names})


def options_from_dict(d: dict) -> Options:
    """``Options`` from a mapping of field name to value, such as
    ``dataclasses.asdict`` of the JAX package's ``Options``; ``admm`` may be
    a nested mapping.  Validation runs as in the constructor."""
    d = dict(d)
    admm = d.pop("admm", None)
    if isinstance(admm, dict):
        admm = ADMMOptions(**admm)
    if admm is not None:
        d["admm"] = admm
    if "print_level" in d:
        d["print_level"] = PrintLevel(int(d["print_level"]))
    if "qp_solver" in d:
        d["qp_solver"] = QPSolver(int(d["qp_solver"]))
    return Options(**d)
