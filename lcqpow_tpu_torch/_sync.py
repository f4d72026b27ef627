"""The solve loops' host syncs, and the baton that threads solving at once
hand over there (:func:`.parallel.solve_batch_sharded`).

PyTorch releases the GIL while it dispatches and launches each op, so
threads that run op-by-op loops at once hand the GIL to one another on
every op, and every hand-over wakes a sleeping thread: such threads run
several times slower than the same loops one after another.  A thread that
solves holding a :class:`Baton` runs its Python alone, and hands the baton
over only at a host sync (:func:`any_`), where it waits for its device
anyway, and only once it has held the baton for a time slice.
"""

from __future__ import annotations

import contextlib
import sys
import threading
import time
from typing import Optional

import torch

_local = threading.local()


class Baton:
    """The lock that threads solving at once run their Python under
    (:meth:`held`), handed over at a host sync once a thread has held it
    for ``hold_s`` seconds (default: the interpreter's switch interval,
    ``sys.getswitchinterval()``; 0: at every sync)."""

    def __init__(self, hold_s: Optional[float] = None):
        self.lock = threading.Lock()
        self.hold_s = sys.getswitchinterval() if hold_s is None else hold_s

    @contextlib.contextmanager
    def held(self):
        with self.lock:
            _local.baton, _local.since = self, time.perf_counter()
            try:
                yield
            finally:
                _local.baton = None


def any_(t: torch.Tensor) -> bool:
    """``bool(t.any())``: the host waits for the device.  A thread that has
    held its :class:`Baton` for its time slice waits without it."""
    flag = t.any()
    baton = getattr(_local, "baton", None)
    if baton is None or time.perf_counter() - _local.since < baton.hold_s:
        return bool(flag)
    baton.lock.release()
    try:
        return bool(flag)
    finally:
        baton.lock.acquire()
        _local.since = time.perf_counter()
