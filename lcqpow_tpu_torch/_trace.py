"""The solve's own spans, for ``torch.profiler``.

:func:`span` marks one stage of the solve (the entry, the predictor, an
inner QP, the corrector, an escalation round) as a ``record_function``
range named ``PREFIX + name``.  The profiler holds the ranges beside its
own events, on the clock of its device trace, and writes them out with
them; nothing here keeps a span.  With no profiler running a span is one read of the
profiler's flag and a shared no-op context manager, so the spans stay in
the solve.
"""

from __future__ import annotations

import contextlib

import torch
import torch.autograd.profiler as _profiler

#: Prefix of every span's name.
PREFIX = "lcqpow::"

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``record_function`` range ``PREFIX + name`` while a profiler
    runs, else a no-op context manager."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(PREFIX + name)
