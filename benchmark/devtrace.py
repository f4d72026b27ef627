"""The traced run's profiler, and the reduction of its trace to the
device's timeline: busy and idle time, kernels, and the device time of
the kernels launched inside each of the harness's ``record_function``
ranges.

The profiler is ``torch.profiler`` (CUPTI through Kineto).  Its raw
events are read once into arrays; nothing here depends on the program.
Device operations are kernels, copies and sets on the card.  An event on
the card is a kernel only when its correlation id is that of a launch
call of the runtime or the driver on the host and the event is no user
annotation (``is_user_annotation``: the ``record_function`` ranges that
Kineto mirrors onto the card's timeline, whatever their names, whose ids
can equal a launch's); copies and sets go by their names; anything else
on the card is no operation.
A kernel belongs to a range when its launch call started inside the
range.  The events' activity types, which some builds of torch lack, are
not read.
"""

from __future__ import annotations

import contextlib
import types
from dataclasses import dataclass, field

import numpy as np
import torch

#: Prefix of the harness's own ``record_function`` ranges.
RANGE_PREFIX = "bench::"
#: Range around each traced call of the entry.
CALL_RANGE = RANGE_PREFIX + "call"
#: Entries of each ``breakdown`` list.
TOP = 10
#: Characters kept of a name in the breakdown.
NAME_CHARS = 120
#: Label of idle time in which the host ran no traced call.
BETWEEN_OPS = "host between ops"


@contextlib.contextmanager
def profiled(device: torch.device):
    """``torch.profiler`` over the block, with the card's activity when
    ``device`` is a CUDA device; yields a holder whose ``.events`` is the
    raw event list once the block has ended."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    holder = types.SimpleNamespace(events=[])
    with profile(activities=acts) as prof:
        yield holder
    holder.events = prof.profiler.kineto_results.events()


def _host_kind(name: str) -> str:
    """What a host event is, by its name: one of the harness's ranges, a
    call of the CUDA runtime or driver, or an operation."""
    if name.startswith(RANGE_PREFIX):
        return "range"
    if name.startswith("cuda") or (name.startswith("cu")
                                   and name[2:3].isupper()):
        return "runtime"
    return "op"


def _is_launch(name: str) -> bool:
    """A runtime or driver call that launches kernels (``cudaLaunchKernel``,
    ``cuLaunchKernelEx``, ``cudaGraphLaunch``, ...)."""
    return "Launch" in name


@dataclass
class Trace:
    """The events of a traced window, as arrays (times in ns, one clock)."""

    kernel_start: np.ndarray
    kernel_dur: np.ndarray
    kernel_name: list
    kernel_launch: np.ndarray          # host start of the launching call
    dev_start: np.ndarray              # every device operation
    dev_end: np.ndarray
    host_start: np.ndarray             # runtime calls and host operations
    host_end: np.ndarray
    host_name: list
    host_is_runtime: np.ndarray
    ranges: dict = field(default_factory=dict)   # name -> (starts, ends)

    @classmethod
    def from_events(cls, events) -> "Trace":
        kernels, devops, host, ranges = [], [], [], {}
        launch_start: dict = {}
        on_card = []
        for e in events:
            start, dur = int(e.start_ns()), int(e.duration_ns())
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                on_card.append(e)
                continue
            name = e.name()
            kind = _host_kind(name)
            if kind == "range":
                ranges.setdefault(name, []).append((start, start + dur))
            else:
                host.append((start, start + dur, name, kind == "runtime"))
                if kind == "runtime" and _is_launch(name):
                    launch_start[e.correlation_id()] = start
        for e in on_card:
            start, dur = int(e.start_ns()), int(e.duration_ns())
            name = e.name()
            if name.startswith(("Memcpy", "Memset")):
                devops.append((start, start + dur))
            elif e.correlation_id() in launch_start \
                    and not e.is_user_annotation():
                kernels.append((start, dur, name,
                                launch_start[e.correlation_id()]))
                devops.append((start, start + dur))
        host.sort()
        return cls(
            kernel_start=np.array([k[0] for k in kernels], dtype=np.int64),
            kernel_dur=np.array([k[1] for k in kernels], dtype=np.int64),
            kernel_name=[k[2] for k in kernels],
            kernel_launch=np.array([k[3] for k in kernels],
                                   dtype=np.int64),
            dev_start=np.array([d[0] for d in devops], dtype=np.int64),
            dev_end=np.array([d[1] for d in devops], dtype=np.int64),
            host_start=np.array([h[0] for h in host], dtype=np.int64),
            host_end=np.array([h[1] for h in host], dtype=np.int64),
            host_name=[h[2] for h in host],
            host_is_runtime=np.array([h[3] for h in host], dtype=bool),
            ranges={k: (np.array(sorted(v))[:, 0], np.array(sorted(v))[:, 1])
                    for k, v in ranges.items()})

    # ---- the window ---------------------------------------------------------
    def window(self) -> tuple[int, int] | None:
        """From the first traced call's start to the last one's end."""
        calls = self.ranges.get(CALL_RANGE)
        if calls is None:
            return None
        return int(calls[0].min()), int(calls[1].max())

    def busy_segments(self) -> tuple[np.ndarray, np.ndarray]:
        """The union of device operations inside the window, as disjoint
        sorted segments."""
        lo, hi = self.window()
        s = np.clip(self.dev_start, lo, hi)
        e = np.clip(self.dev_end, lo, hi)
        keep = e > s
        s, e = s[keep], e[keep]
        if s.size == 0:
            return s, e
        order = np.argsort(s, kind="stable")
        s, e = s[order], e[order]
        reach = np.maximum.accumulate(e)
        new = np.ones(s.size, dtype=bool)
        new[1:] = s[1:] > reach[:-1]
        starts = s[new]
        last = np.flatnonzero(new)
        ends = np.maximum.reduceat(e, last)
        return starts, ends

    def busy_ns(self) -> int:
        s, e = self.busy_segments()
        return int((e - s).sum())

    def window_ns(self) -> int:
        lo, hi = self.window()
        return hi - lo

    def kernels_in_window(self) -> int:
        lo, hi = self.window()
        return int(((self.kernel_start >= lo) & (self.kernel_start < hi)).sum())

    def range_device_ns(self, name: str) -> tuple[int, int] | None:
        """(kernel launches, their device ns) of the kernels launched
        inside range ``name``; ``None`` if the trace has no such range."""
        rng = self.ranges.get(name)
        if rng is None:
            return None
        starts, ends = rng
        i = np.searchsorted(starts, self.kernel_launch, side="right") - 1
        inside = (i >= 0) & (self.kernel_launch
                             <= ends[np.clip(i, 0, None)])
        return int(inside.sum()), int(self.kernel_dur[inside].sum())

    def range_busy_pct(self, name: str) -> float | None:
        """The device time of the kernels launched inside range ``name``,
        in percent of the window's busy time; ``None`` without the range
        or without device time."""
        inside = self.range_device_ns(name)
        busy = self.busy_ns() if self.window() is not None else 0
        if inside is None or busy == 0:
            return None
        return 100.0 * inside[1] / busy

    # ---- the breakdown ------------------------------------------------------
    def top_device_ops(self) -> list:
        """Kernels with the most device time, by name, in seconds."""
        total: dict = {}
        for name, dur in zip(self.kernel_name, self.kernel_dur.tolist()):
            total[name] = total.get(name, 0) + dur
        top = sorted(total.items(), key=lambda kv: -kv[1])[:TOP]
        return [[name[:NAME_CHARS], ns / 1e9] for name, ns in top]

    def idle_gaps(self) -> list:
        """Idle time of the device inside the window, by what the host was
        doing at each gap's middle: the runtime call running then, else
        the innermost host operation, else ``BETWEEN_OPS``; in seconds."""
        lo, hi = self.window()
        s, e = self.busy_segments()
        gap_lo = np.concatenate([[lo], e])
        gap_hi = np.concatenate([s, [hi]])
        keep = gap_hi > gap_lo
        gap_lo, gap_hi = gap_lo[keep], gap_hi[keep]
        mid = (gap_lo + gap_hi) // 2
        rt = self.host_is_runtime
        labels = np.full(mid.size, -1, dtype=np.int64)
        for want in (True, False):
            idx = np.flatnonzero(rt == want)
            starts, ends = self.host_start[idx], self.host_end[idx]
            pos = np.searchsorted(starts, mid, side="right") - 1
            # Host operations nest; look back a few for the innermost one
            # that still runs at the gap's middle.
            for back in range(8 if not want else 1):
                p = pos - back
                ok = (labels < 0) & (p >= 0)
                pc = np.clip(p, 0, None)
                hit = ok & (ends[pc] >= mid) if idx.size else ok & False
                labels[hit] = idx[pc[hit]]
        total: dict = {}
        for lab, ns in zip(labels.tolist(), (gap_hi - gap_lo).tolist()):
            name = self.host_name[lab] if lab >= 0 else BETWEEN_OPS
            total[name] = total.get(name, 0) + ns
        top = sorted(total.items(), key=lambda kv: -kv[1])[:TOP]
        return [[name[:NAME_CHARS], ns / 1e9] for name, ns in top]
