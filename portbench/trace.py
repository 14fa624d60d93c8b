"""The traced phase: torch.profiler over the card, a marker kernel at each
end of the window, and the reductions every device metric reads.

The profiler now and then loses a window's events, or its first ones.  A
trace that lacks either marker, or that holds no device event between
them, is retried and never read as an idle card."""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch

MARKER = "spin_kernel"          # torch.cuda._sleep's kernel
MARKER_CYCLES = 1_000_000


@dataclass
class Interval:
    name: str
    start: float                # us, the profiler's clock
    end: float


@dataclass
class Trace:
    events: list                # device Intervals inside the window
    window_us: float
    busy_us: float
    gaps: list                  # (start_us, end_us) idle inside the window
    anchor: tuple = ()          # (profiler us, time.time()) of one instant


def union_us(intervals) -> float:
    """Length of the union of the intervals: the time some operation ran,
    however many ran at once."""
    total, end = 0.0, None
    for iv in sorted(intervals, key=lambda i: i.start):
        a, b = iv.start, iv.end
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def idle_gaps(intervals, lo: float, hi: float) -> list:
    """The parts of [lo, hi] that no interval covers, as (start, end)."""
    gaps, cur = [], lo
    for iv in sorted(intervals, key=lambda i: i.start):
        if iv.start > cur:
            gaps.append((cur, min(iv.start, hi)))
        cur = max(cur, iv.end)
        if cur >= hi:
            break
    if cur < hi:
        gaps.append((cur, hi))
    return [g for g in gaps if g[1] > g[0]]


def window_of(device_events, anchor=()) -> Trace:
    """The window between the two markers' kernels, or None where the
    trace lacks either marker or any event between them."""
    marks = sorted((e for e in device_events if MARKER in e.name),
                   key=lambda e: e.start)
    if len(marks) < 2:
        return None
    lo, hi = marks[0].end, marks[-1].start
    inside = [e for e in device_events
              if MARKER not in e.name and e.start >= lo and e.end <= hi]
    if not inside or hi <= lo:
        return None
    return Trace(inside, hi - lo, union_us(inside), idle_gaps(inside, lo, hi),
                 anchor)


def _intervals(prof) -> tuple:
    """(device intervals, host intervals) of a profile."""
    dev, cpu = [], []
    for e in prof.events():
        iv = Interval(e.name, float(e.time_range.start),
                      float(e.time_range.end))
        if e.device_type == torch.autograd.DeviceType.CUDA and \
                not getattr(e, "is_user_annotation", False):
            dev.append(iv)
        else:
            cpu.append(iv)
    return dev, cpu


def traced(fn, tries: int = 3):
    """Run ``fn()`` under the profiler between two marker kernels; the
    Trace of its window.  ``fn`` runs again (at most ``tries`` times) where
    a trace is lost."""
    from torch.profiler import ProfilerActivity, profile, record_function
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            with record_function("portbench.anchor"):
                wall = time.time()
            torch.cuda._sleep(MARKER_CYCLES)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
            torch.cuda._sleep(MARKER_CYCLES)
            torch.cuda.synchronize()
        dev, cpu = _intervals(prof)
        anchors = [c for c in cpu if c.name == "portbench.anchor"]
        anchor = (anchors[0].start, wall) if anchors else ()
        tr = window_of(dev, anchor)
        if tr is not None:
            return tr
    return None


def top_ops(tr: Trace, n: int = 10) -> list:
    """[[name, seconds]] of the device operations that took the most time
    in the window, summed by name."""
    by = {}
    for e in tr.events:
        by[e.name] = by.get(e.name, 0.0) + (e.end - e.start) / 1e6
    return [[k[:120], v] for k, v in
            sorted(by.items(), key=lambda kv: kv[1], reverse=True)[:n]]


def labelled_gaps(tr: Trace, host_intervals, n: int = 10) -> list:
    """[[label, seconds]] of the longest idle gaps in the window.  The label
    is the innermost host interval (a port span, or the harness's own
    ``to_rows`` / ``client`` stage) open at the gap's midpoint; host
    intervals are (name, start, end) in time.time() seconds."""
    if not tr.anchor:
        return [["unlabelled", (b - a) / 1e6] for a, b in
                sorted(tr.gaps, key=lambda g: g[0] - g[1])[:n]]
    a_us, a_wall = tr.anchor
    out = []
    for a, b in sorted(tr.gaps, key=lambda g: g[0] - g[1])[:n]:
        mid = a_wall + ((a + b) / 2 - a_us) / 1e6
        best = None
        for name, s, e in host_intervals:
            if s <= mid <= e and (best is None or s > best[1]):
                best = (name, s)
        out.append([best[0] if best else "client", (b - a) / 1e6])
    return out
