import pytest

from portbench import trace
from portbench.trace import Interval


def iv(a, b, name="k"):
    return Interval(name, float(a), float(b))


def test_union_counts_overlaps_once():
    evs = [iv(0, 10), iv(5, 15), iv(20, 30), iv(22, 25)]
    assert trace.union_us(evs) == 25.0
    assert trace.union_us([]) == 0.0


def test_idle_gaps_and_share():
    evs = [iv(10, 20), iv(15, 30), iv(50, 60)]
    gaps = trace.idle_gaps(evs, 0.0, 100.0)
    assert gaps == [(0.0, 10.0), (30.0, 50.0), (60.0, 100.0)]
    assert sum(b - a for a, b in gaps) + trace.union_us(evs) == 100.0


def test_window_between_markers():
    m = trace.MARKER
    evs = [iv(0, 5, m), iv(6, 8, "early"), iv(10, 20), iv(30, 40),
           iv(50, 55, m)]
    tr = trace.window_of([iv(-100, -90, "before")] + evs)
    assert tr.window_us == 45.0
    assert tr.busy_us == 22.0          # "early" too: it ran in the window
    assert 100.0 * (1 - tr.busy_us / tr.window_us) == pytest.approx(
        100 * 23 / 45)


def test_lost_trace_is_never_an_idle_card():
    m = trace.MARKER
    assert trace.window_of([iv(0, 5, m), iv(10, 20)]) is None   # one marker
    assert trace.window_of([iv(0, 5, m), iv(50, 55, m)]) is None  # no event
    assert trace.window_of([iv(10, 20)]) is None


def test_breakdown_names_ops_and_labels_gaps():
    m = trace.MARKER
    tr = trace.window_of([iv(0, 10, m), iv(10, 30, "a"), iv(40, 50, "b"),
                          iv(60, 70, "a"), iv(100, 110, m)],
                         (0.0, 1000.0))
    ops = trace.top_ops(tr)
    assert ops[0][0] == "a" and ops[0][1] == pytest.approx(30e-6)
    # gaps: 30-40, 50-60, 70-100 us; host wall time = 1000 s + us / 1e6
    host = [("query", 1000.0, 1000.001), ("parse", 1000.00001, 1000.00008)]
    gaps = trace.labelled_gaps(tr, host)
    assert gaps[0] == ["query", pytest.approx(30e-6)]
    assert sorted(g[0] for g in gaps[1:]) == ["parse", "parse"]
    assert trace.labelled_gaps(tr, [])[0][0] == "client"
