"""Hierarchical spans (OpenTelemetry-style): the port of
myscaledb_tpu/runtime/tracing.py, extended for the card.

Reference analog: thread-local TracingContextOnThread + RAII SpanHolder
(src/Common/OpenTelemetryTraceContext.h) with every query getting a root span
(executeQuery.cpp:373) flushed to system.opentelemetry_span_log.  Here spans
are a thread-local stack; finished spans append to a bounded ring that
system.span_log exposes.

- A span's ``start`` is ``time.time()`` (the clock system.span_log shows);
  its duration is measured on ``time.perf_counter_ns()`` and ``end`` is
  ``start`` plus it, so a step of the wall clock cannot make a span negative.
- Span and trace ids come from one process counter.  A statement's spans
  share its trace id (``statement()``); a span may name its parent
  explicitly (``parent=``), as ``Table.to_rows`` names its query's.
- While a ``torch.profiler`` runs, a span is also a ``record_function``
  range, so the profiler's trace holds the program's spans on its own
  clock beside the device's kernels.  With no profiler the check is the
  only cost.
- A closing span appends itself to the ring; the full ring drops its
  oldest span and counts it in the ``SpansDropped`` event.
  ``timings_snapshot()`` sums every closed span's seconds by name, those
  gone from the ring included (system.timings, ``/metrics``).
- ``clear_span_log()`` removes what the calling thread's last
  ``span_log_snapshot()`` returned, so a reader that drains the ring loses
  no span closed between the two calls.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import defaultdict, deque
from typing import Optional

import torch

from myscaledb_tpu_torch.runtime import metrics as M

MAX_SPANS = 10_000
SPANS_DROPPED = "SpansDropped"

_profiling = torch._C._autograd._profiler_enabled
_wall = time.time
_perf_ns = time.perf_counter_ns


def hex_id(i: Optional[int]) -> str:
    """An id as system.span_log shows it ("" for no parent)."""
    return f"{i:016x}" if i else ""


class _Local(threading.local):
    def __init__(self):
        self.stack = []
        self.trace_id = None     # the open statement's (``statement()``)
        self.seen = None         # the last span of its last snapshot


_tls = _Local()
_ids = itertools.count(1)
_lock = threading.Lock()
_span_log: deque = deque()       # closed spans, oldest first
_gone = defaultdict(float)       # seconds of the spans that left the ring


def _leave(spans) -> None:
    """Fold the seconds of spans leaving the ring into ``_gone`` (under
    ``_lock``)."""
    for s in spans:
        _gone[s.name] += s.end - s.start


class Span:
    """``with Span(name, **attributes) as s`` (``span``): a span under the
    thread's innermost open span, or under ``parent`` (a (trace_id,
    span_id) pair) where it is given.  The closed span is its own record
    in the ring."""

    __slots__ = ("name", "trace_id", "span_id", "parent_span_id", "start",
                 "end", "attributes", "_stack", "_t0", "_rf")

    def __init__(self, name: str, *, parent: Optional[tuple] = None,
                 **attributes):
        st = self._stack = _tls.stack
        if parent is not None:
            self.trace_id, self.parent_span_id = parent
        elif st:
            self.trace_id, self.parent_span_id = st[-1].trace_id, \
                st[-1].span_id
        else:
            self.trace_id, self.parent_span_id = \
                _tls.trace_id or next(_ids), None
        self.name = name
        self.span_id = next(_ids)
        self.attributes = attributes
        self.start = self.end = 0.0

    @property
    def duration_us(self) -> int:
        return int((self.end - self.start) * 1e6)

    def __enter__(self) -> "Span":
        self._stack.append(self)
        if _profiling():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        else:
            self._rf = None
        self.start = _wall()
        self._t0 = _perf_ns()
        return self

    def __exit__(self, *exc) -> None:
        dt = (_perf_ns() - self._t0) * 1e-9
        self.end = self.start + dt
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        self._stack.pop()
        with _lock:
            _span_log.append(self)
            full = len(_span_log) > MAX_SPANS
            if full:
                _leave((_span_log.popleft(),))
        if full:
            M.increment(SPANS_DROPPED)


span = Span


class statement:
    """``with statement():`` the root spans the thread opens inside share
    one new trace id: one statement's ``lock_wait``, ``query`` and the
    spans of the work it calls."""

    __slots__ = ("prev",)

    def __enter__(self) -> int:
        self.prev = _tls.trace_id
        _tls.trace_id = next(_ids)
        return _tls.trace_id

    def __exit__(self, *exc) -> None:
        _tls.trace_id = self.prev


def sync(site: str) -> Span:
    """A ``sync`` span: the host waits for the card at ``site``."""
    return Span("sync", site=site)


def current_span() -> Optional[Span]:
    st = _tls.stack
    return st[-1] if st else None


def span_log_snapshot() -> list[Span]:
    with _lock:
        spans = list(_span_log)
    _tls.seen = spans[-1] if spans else False      # False: saw none
    return spans


def clear_span_log() -> None:
    """Remove the spans the thread's last ``span_log_snapshot()`` returned
    (every span, where the thread took none since its last clear)."""
    last, _tls.seen = _tls.seen, None
    with _lock:
        n = len(_span_log) if last is None else next(
            (i + 1 for i, s in enumerate(_span_log) if s is last), 0)
        _leave([_span_log.popleft() for _ in range(n)])


def timings_snapshot() -> dict[str, float]:
    """Seconds by span name, summed over every span closed in the process:
    system.timings and ``/metrics``' ``msdb_seconds_<name>``."""
    with _lock:
        out = defaultdict(float, _gone)
        for s in _span_log:
            out[s.name] += s.end - s.start
    return dict(out)
