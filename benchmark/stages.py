"""The card's idle time inside the program's own spans, split over the
solve's stages.

The program marks its stages with ``record_function`` ranges named
``lcqpow::<stage>`` (``lcqpow_tpu_torch/_trace.py``); :mod:`devtrace`
keeps them as host operations (``Trace.host_name``, ``host_start``,
``host_end``), on the clock of the card's timeline.  A stage is the time
inside some of its spans and outside every span it leaves to another stage
(``STAGES``); its idle time is the part of it in the traced window in which
the card ran nothing (the window less ``Trace.busy_segments()``), cut
exactly at the spans' edges, so a gap that straddles two stages is shared
between them by time.  The stages partition ``lcqpow::call``: their idle
shares add up to the window's idle share less the idle time outside every
``lcqpow::call`` (:func:`outside_idle_pct`), the harness's own time between
calls.  Nothing here imports the program.
"""

from __future__ import annotations

import numpy as np

#: Prefix of the program's span names.
PREFIX = "lcqpow::"
#: Span around each call of the program's entry.
CALL = "call"
#: Each stage: (spans it is made of, spans it leaves to other stages).
STAGES = {
    "predictor": (("predictor",), ("inner_qp",)),
    "inner_qp": (("inner_qp",), ()),
    "corrector": (("corrector",), ()),
    "entry": ((CALL,), ("predictor", "inner_qp", "corrector")),
}


def program_spans(trace) -> dict:
    """The program's spans in ``trace``: name without the prefix ->
    (starts, ends) in ns."""
    out: dict = {}
    for i, name in enumerate(trace.host_name):
        if name.startswith(PREFIX):
            out.setdefault(name[len(PREFIX):], []).append(i)
    return {k: (trace.host_start[v], trace.host_end[v])
            for k, v in out.items()}


def _cover(sets: dict):
    """The elementary segments between every edge of the interval sets
    ``sets`` (name -> (starts, ends), overlaps allowed): their lengths and,
    for each name, whether each segment lies inside that set."""
    names = list(sets)
    pts = np.concatenate([np.concatenate(sets[k]) for k in names])
    order = np.argsort(pts, kind="stable")
    lengths = np.diff(pts[order])
    inside = {}
    at = 0
    for k in names:
        s, e = sets[k]
        delta = np.zeros(pts.size, dtype=np.int64)
        delta[at:at + s.size] = 1
        delta[at + s.size:at + s.size + e.size] = -1
        at += s.size + e.size
        inside[k] = np.cumsum(delta[order])[:-1] > 0
    return lengths, inside


def _split(trace):
    """(idle ns of each stage, idle ns outside every ``lcqpow::call``,
    window ns), or ``None`` without a window, a device operation or the
    program's ``lcqpow::call`` span."""
    if trace is None or trace.window() is None or trace.dev_start.size == 0:
        return None
    spans = program_spans(trace)
    if CALL not in spans:
        return None
    lo, hi = trace.window()
    empty = (np.zeros(0, dtype=np.int64),) * 2
    sets = {"window": (np.array([lo]), np.array([hi])),
            "busy": trace.busy_segments()}
    for made_of, left in STAGES.values():
        for name in made_of + left:
            sets[name] = spans.get(name, empty)
    lengths, inside = _cover(sets)
    idle = inside["window"] & ~inside["busy"]
    split = {}
    for stage, (made_of, left) in STAGES.items():
        mask = idle & np.logical_or.reduce([inside[k] for k in made_of])
        for k in left:
            mask &= ~inside[k]
        split[stage] = int(lengths[mask].sum())
    outside = int(lengths[idle & ~inside[CALL]].sum())
    return split, outside, hi - lo


def idle_pct(trace, stage: str) -> float | None:
    """Idle time of the card inside ``stage`` (``STAGES``), in percent of
    the traced window; ``None`` as :func:`_split`."""
    got = _split(trace)
    if got is None:
        return None
    split, _, window = got
    return 100.0 * split[stage] / window


def outside_idle_pct(trace) -> float | None:
    """Idle time of the card in the window outside every ``lcqpow::call``,
    in percent of the window; ``None`` as :func:`_split`."""
    got = _split(trace)
    if got is None:
        return None
    _, outside, window = got
    return 100.0 * outside / window
