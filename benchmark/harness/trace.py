"""The device trace of a run: `torch.profiler` over the measured window, read
in memory and reduced to intervals.

- busy: the union of the card's kernel, copy and set intervals inside the
  window, so work that overlaps on two streams counts once;
- device time per operation: a kernel belongs to the host range that
  launched it (the program's `launch_range` names around its kernels),
  found through the launch's correlation, or by the table of CUDA function
  names a metric gives;
- idle gaps: the stretches of the window with nothing on the card, each
  named by the innermost host range the main thread was in at its middle.
"""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict
from dataclasses import dataclass
from typing import Optional

import torch

WINDOW_RANGE = "benchmark.window"
_DEVICE_KINDS = ("kernel", "memcpy", "memset")


@dataclass
class DeviceEvent:
    name: str
    start: int        # ns
    end: int
    linked: int       # correlation id of the host op it was launched under (0: none)
    corr: int = 0     # its launch's correlation id (the runtime call's)


@dataclass
class HostEvent:
    name: str
    start: int
    end: int
    corr: int
    thread: int
    runtime: bool = False     # a CUDA runtime or driver call, not an op or a range


@dataclass
class Reduced:
    """What the metrics read from a trace."""

    window: tuple                     # (start, end) ns
    busy_ns: int
    by_kernel: dict                   # kernel name -> ns
    by_range: dict                    # launching range name -> ns
    unattributed: dict                # kernel name -> ns, launched outside every range
    idle_by_host: dict                # host range name -> ns of idle gaps

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    @property
    def busy_s(self) -> float:
        return self.busy_ns / 1e9


def union_length(intervals, lo: int, hi: int) -> tuple:
    """(covered ns, gaps [(start, end)]) of `intervals` clipped to [lo, hi]."""
    spans = sorted((max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi)
    covered, gaps, cur = 0, [], lo
    for s, e in spans:
        if s > cur:
            gaps.append((cur, s))
            cur = s
        if e > cur:
            covered += e - cur
            cur = e
    if cur < hi:
        gaps.append((cur, hi))
    return covered, gaps


def innermost_at(host: list, points: list) -> list:
    """For each time in `points` (ascending), the name of the shortest host
    event of `host` (one thread's, properly nested) that covers it, or None."""
    events = sorted(host, key=lambda e: (e.start, -e.end))
    out, stack, i = [], [], 0
    for p in points:
        while i < len(events) and events[i].start <= p:
            while stack and stack[-1].end <= events[i].start:
                stack.pop()
            stack.append(events[i])
            i += 1
        while stack and stack[-1].end <= p:
            stack.pop()
        out.append(stack[-1].name if stack else None)
    return out


def reduce_events(device: list, host: list, ranges: set, name_table: dict,
                  window: Optional[tuple] = None) -> Reduced:
    """Reduce a trace. `ranges` are the host range names that own kernels;
    `name_table` maps a part of a CUDA function's name to a range name, for
    kernels that no range's correlation reaches. The window is the host
    event `WINDOW_RANGE`, unless given."""
    if window is None:
        marks = [e for e in host if e.name == WINDOW_RANGE]
        if not marks:
            raise ValueError(f"the trace holds no {WINDOW_RANGE!r} range")
        window = (marks[0].start, marks[0].end)
        main = marks[0].thread
    else:
        main = None
    lo, hi = window
    ops = {e.corr: e for e in host if not e.runtime}
    calls = {e.corr: e for e in host if e.runtime}
    owners = defaultdict(list)                    # thread -> owning ranges by start
    for e in host:
        if e.name in ranges and not e.runtime:
            owners[e.thread].append(e)
    for lst in owners.values():
        lst.sort(key=lambda e: e.start)
    starts = {t: [e.start for e in lst] for t, lst in owners.items()}

    def enclosing(e: HostEvent) -> Optional[str]:
        j = bisect.bisect_right(starts.get(e.thread, []), e.start) - 1
        if j >= 0 and owners[e.thread][j].end >= e.end:
            return owners[e.thread][j].name
        return None

    def owner_of(ev: DeviceEvent) -> Optional[str]:
        op = ops.get(ev.linked) if ev.linked else None
        if op is not None:
            found = op.name if op.name in ranges else enclosing(op)
            if found:
                return found
        call = calls.get(ev.corr) if ev.corr else None
        if call is not None:
            found = enclosing(call)
            if found:
                return found
        for key, name in name_table.items():
            if key in ev.name:
                return name
        return None

    by_kernel, by_range, unattributed = defaultdict(int), defaultdict(int), defaultdict(int)
    intervals = []
    for ev in device:
        if ev.end <= lo or ev.start >= hi:
            continue
        dur = min(ev.end, hi) - max(ev.start, lo)
        intervals.append((ev.start, ev.end))
        by_kernel[ev.name] += dur
        owner = owner_of(ev)
        if owner is None:
            unattributed[ev.name] += dur
        else:
            by_range[owner] += dur
    busy, gaps = union_length(intervals, lo, hi)
    main_host = [e for e in host if main is None or e.thread == main]
    mids = [(s + e) // 2 for s, e in gaps]
    order = sorted(range(len(mids)), key=lambda i: mids[i])
    labels = innermost_at(main_host, [mids[i] for i in order])
    idle = defaultdict(int)
    for i, label in zip(order, labels):
        s, e = gaps[i]
        idle[label or "(outside every host range)"] += e - s
    return Reduced(window=window, busy_ns=busy, by_kernel=dict(by_kernel),
                   by_range=dict(by_range), unattributed=dict(unattributed),
                   idle_by_host=dict(idle))


def breakdown(red: Reduced, top: int = 10) -> dict:
    """The result line's breakdown: device operations by time (kernels
    owned by a range under that range's name, the rest as
    "unattributed: <kernel>"), and idle gaps by what the host was doing."""
    ops = {f"range {k}": v for k, v in red.by_range.items()}
    ops.update({f"unattributed: {k[:120]}": v for k, v in red.unattributed.items()})
    first = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(red.idle_by_host.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v / 1e9] for k, v in first],
            "idle_gaps": [[k[:120], v / 1e9] for k, v in gaps]}


class Capture:
    """`torch.profiler` (host and card) around the window, or nothing."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None
        self.device: list = []
        self.host: list = []

    @contextlib.contextmanager
    def window(self):
        """The measured window: under a capture, inside the `WINDOW_RANGE`
        range."""
        if not self.enabled:
            yield
            return
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        try:
            with torch.profiler.record_function(WINDOW_RANGE):
                yield
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.prof.stop()

    def read(self) -> None:
        """Copy the capture's events out of the profiler (after the window)."""
        if self.prof is None:
            return
        for e in self.prof.profiler.kineto_results.events():
            kind = str(e.activity_type()).lower() if hasattr(e, "activity_type") else (
                "user_annotation" if e.is_user_annotation() else "kernel")
            start = int(e.start_ns())
            end = start + int(e.duration_ns())
            if str(e.device_type()).endswith("CPU"):
                self.host.append(HostEvent(e.name(), start, end, int(e.correlation_id()),
                                           int(e.start_thread_id()),
                                           runtime=kind.startswith("cuda_")))
            elif any(k in kind for k in _DEVICE_KINDS):
                self.device.append(DeviceEvent(e.name(), start, end,
                                               int(e.linked_correlation_id()),
                                               int(e.correlation_id())))
        self.prof = None
