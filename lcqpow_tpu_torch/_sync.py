"""The solve loops' host syncs, and the baton that threads solving at once
hand over there (:func:`.parallel.solve_batch_sharded`).

PyTorch releases the GIL while it dispatches and launches each op, so
threads that run op-by-op loops at once hand the GIL to one another on
every op, and every hand-over wakes a sleeping thread: such threads run
several times slower than the same loops one after another.  A thread that
solves holding a :class:`Baton` runs its Python alone, and hands the baton
over only at a host sync (:func:`any_`, :func:`nonzero`), where it waits
for its device anyway, and only once it has held the baton for a time
slice.

Every host wait of the solve goes through here and is counted in
``sync_count``; the solve makes its scalars on the device by fills, so it
copies nothing from the host, which would wait too.
"""

from __future__ import annotations

import contextlib
import sys
import threading
import time
from typing import Optional

import torch

_local = threading.local()

#: Host waits for the device (:func:`any_`, :func:`nonzero`) in this
#: process.
sync_count = 0
#: Guards the count: threads solve at once
#: (``parallel.solve_batch_sharded``).
_count_lock = threading.Lock()


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


def _wait(read):
    """``read()``, which waits for the device, counted; a thread that has
    held its :class:`Baton` for its time slice waits without it."""
    global sync_count
    with _count_lock:
        sync_count += 1
    baton = getattr(_local, "baton", None)
    if baton is None or time.perf_counter() - _local.since < baton.hold_s:
        return read()
    baton.lock.release()
    try:
        return read()
    finally:
        baton.lock.acquire()
        _local.since = time.perf_counter()


def any_(t: torch.Tensor) -> bool:
    """``bool(t.any())``: the host waits for the device."""
    flag = t.any()
    return _wait(lambda: bool(flag))


def nonzero(t: torch.Tensor) -> torch.Tensor:
    """``torch.nonzero(t).flatten()``: the host waits for the device to
    learn how many there are."""
    return _wait(lambda: torch.nonzero(t).flatten())
