"""The port's spans (runtime/tracing.py) on a CPU session, through the entry
every wire server calls: ``Session.sql_as`` and then ``to_rows()``."""

import itertools
import threading
import time
from collections import deque

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

import myscaledb_tpu_torch
from myscaledb_tpu_torch.runtime import metrics as M
from myscaledb_tpu_torch.runtime import tracing

SELECT = "SELECT g, sum(x) FROM w WHERE x > 1 GROUP BY g ORDER BY g"


@pytest.fixture(scope="module")
def session():
    s = myscaledb_tpu_torch.connect(device="cpu")
    s.create_table("w", {"x": np.arange(64, dtype=np.int64),
                         "g": np.arange(64, dtype=np.int64) % 5})
    return s


def statement_spans(session, sql=SELECT):
    """The spans of one statement run through ``sql_as`` and ``to_rows``."""
    rows = session.sql_as(None, sql).to_rows()
    spans = tracing.span_log_snapshot()
    trace = next(s.trace_id for s in reversed(spans) if s.name == "to_rows")
    return rows, [s for s in spans if s.trace_id == trace]


def test_statement_spans_share_one_trace(session):
    rows, spans = statement_spans(session)
    x = np.arange(2, 64)
    assert rows == [(g, int(x[x % 5 == g].sum())) for g in range(5)]
    by = {}
    for s in spans:
        by.setdefault(s.name, []).append(s)
    (lock,), (query,), (parse,), (to_rows,) = (
        by["lock_wait"], by["query"], by["parse"], by["to_rows"])
    assert lock.parent_span_id is None and query.parent_span_id is None
    assert parse.parent_span_id == query.span_id
    assert to_rows.parent_span_id == query.span_id
    assert lock.end <= query.start <= parse.start <= parse.end <= query.end
    assert query.end <= to_rows.start
    # every other span of the statement lies under its query span
    ids = {s.span_id for s in spans}
    for s in spans:
        if s.name not in ("lock_wait", "query"):
            assert s.parent_span_id in ids


def test_sync_spans_name_their_site_and_never_nest(session):
    _, spans = statement_spans(session)
    syncs = [s for s in spans if s.name == "sync"]
    assert syncs
    sync_ids = {s.span_id for s in syncs}
    for s in syncs:
        assert s.attributes["site"]
        assert s.parent_span_id not in sync_ids


def test_durations_survive_a_wall_clock_stepping_back(session, monkeypatch):
    back = itertools.count(2e9, -10.0)     # each call 10 s earlier
    monkeypatch.setattr(time, "time", lambda: next(back))
    _, spans = statement_spans(session)
    assert spans
    for s in spans:
        assert s.end >= s.start and s.duration_us >= 0


def test_clear_keeps_a_span_closed_after_the_snapshot():
    with tracing.span("before"):
        pass
    seen = tracing.span_log_snapshot()
    assert seen[-1].name == "before"
    t = threading.Thread(target=_closed_span, args=("between",))
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    tracing.clear_span_log()
    left = [s.name for s in tracing.span_log_snapshot()]
    assert "between" in left and "before" not in left
    tracing.clear_span_log()
    assert not any(s.name == "between" for s in tracing.span_log_snapshot())


def _closed_span(name):
    with tracing.span(name):
        pass


def test_full_ring_counts_dropped_spans(monkeypatch):
    monkeypatch.setattr(tracing, "_span_log", deque())
    monkeypatch.setattr(tracing, "MAX_SPANS", 32)
    before = M.events_snapshot().get(tracing.SPANS_DROPPED, 0)
    seconds = tracing.timings_snapshot().get("ring", 0.0)
    spans = []
    for _ in range(35):
        with tracing.span("ring") as s:
            spans.append(s)
    assert list(tracing._span_log) == spans[3:]
    assert M.events_snapshot()[tracing.SPANS_DROPPED] == before + 3
    # the dropped spans' seconds stay in the timings
    assert tracing.timings_snapshot()["ring"] == pytest.approx(
        seconds + sum(s.end - s.start for s in spans))


def test_system_timings_gain_query_seconds(session):
    def seconds():
        return dict(session.sql("SELECT name, seconds FROM system.timings")
                    .to_rows()).get("query", 0.0)
    before = seconds()
    _, spans = statement_spans(session)
    (query,) = [s for s in spans if s.name == "query"]
    assert seconds() >= before + query.duration_us / 1e6


def test_profiler_holds_the_spans_as_user_annotations(session):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        session.sql_as(None, SELECT).to_rows()
    names = {e.name for e in prof.events()
             if getattr(e, "is_user_annotation", False)}
    assert {"lock_wait", "query", "parse", "to_rows"} <= names


def test_spans_nest_on_the_thread_or_under_a_named_parent():
    with tracing.span("outer") as outer:
        with tracing.span("inner") as inner:
            assert tracing.current_span() is inner
        assert tracing.current_span() is outer
        with tracing.span("adopted", parent=(7, 8)) as adopted:
            pass
    assert tracing.current_span() is None
    assert (inner.trace_id, inner.parent_span_id) == (outer.trace_id,
                                                      outer.span_id)
    assert (adopted.trace_id, adopted.parent_span_id) == (7, 8)
    with tracing.statement() as trace:
        with tracing.span("a") as a:
            pass
        with tracing.span("b") as b:
            pass
    assert a.trace_id == b.trace_id == trace
    assert a.parent_span_id is None and b.parent_span_id is None


def test_drain_under_many_closing_threads_loses_and_repeats_nothing(
        monkeypatch):
    """Sixteen threads close spans while one drains the ring, as the
    benchmark does: every span is drained once, and the timings hold
    every span's seconds."""
    import sys
    monkeypatch.setattr(tracing, "_span_log", deque())
    seconds = tracing.timings_snapshot().get("stress", 0.0)
    closed, drained, done = [], [], threading.Event()

    def work():
        mine = []
        for _ in range(400):
            with tracing.span("stress") as s:
                pass
            mine.append(s)
        closed.extend(mine)

    def drain():
        while not done.is_set():
            drained.extend(tracing.span_log_snapshot())
            tracing.clear_span_log()
        drained.extend(tracing.span_log_snapshot())
        tracing.clear_span_log()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        drainer = threading.Thread(target=drain)
        drainer.start()
        workers = [threading.Thread(target=work) for _ in range(16)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        done.set()
        drainer.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not drainer.is_alive() and not any(w.is_alive() for w in workers)
    assert len(closed) == 16 * 400
    assert sorted(map(id, drained)) == sorted(map(id, closed))
    assert tracing.timings_snapshot()["stress"] == pytest.approx(
        seconds + sum(s.end - s.start for s in closed))
