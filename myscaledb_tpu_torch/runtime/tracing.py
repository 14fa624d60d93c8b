"""Copy of myscaledb_tpu/runtime/tracing.py (JAX-free; imports renamed to this package).

Hierarchical spans (OpenTelemetry-style).

Reference analog: thread-local TracingContextOnThread + RAII SpanHolder
(src/Common/OpenTelemetryTraceContext.h) with every query getting a root span
(executeQuery.cpp:373) flushed to system.opentelemetry_span_log.  Here spans
are a thread-local stack; finished spans append to a bounded ring that
system.span_log exposes.
"""

from __future__ import annotations

import threading
import time
import uuid
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Optional

MAX_SPANS = 10_000


@dataclass
class Span:
    name: str
    trace_id: str
    span_id: str
    parent_span_id: Optional[str]
    start: float
    end: float = 0.0
    attributes: dict = field(default_factory=dict)

    @property
    def duration_us(self) -> int:
        return int((self.end - self.start) * 1e6)


_tls = threading.local()
_log_lock = threading.Lock()
_span_log: deque[Span] = deque(maxlen=MAX_SPANS)


def _stack() -> list:
    if not hasattr(_tls, "stack"):
        _tls.stack = []
    return _tls.stack


@contextmanager
def span(name: str, **attributes):
    st = _stack()
    parent = st[-1] if st else None
    s = Span(name=name,
             trace_id=parent.trace_id if parent else uuid.uuid4().hex,
             span_id=uuid.uuid4().hex[:16],
             parent_span_id=parent.span_id if parent else None,
             start=time.time(), attributes=dict(attributes))
    st.append(s)
    try:
        yield s
    finally:
        s.end = time.time()
        st.pop()
        with _log_lock:
            _span_log.append(s)


def current_span() -> Optional[Span]:
    st = _stack()
    return st[-1] if st else None


def span_log_snapshot() -> list[Span]:
    with _log_lock:
        return list(_span_log)


def clear_span_log() -> None:
    with _log_lock:
        _span_log.clear()
