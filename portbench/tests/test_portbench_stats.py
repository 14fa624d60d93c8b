import math
import statistics

import pytest

from portbench import stats


def test_percentile_matches_linear_interpolation():
    xs = [5.0, 1.0, 4.0, 2.0, 3.0]
    assert stats.percentile(xs, 50) == 3.0
    assert stats.percentile(xs, 0) == 1.0
    assert stats.percentile(xs, 100) == 5.0
    assert stats.percentile(xs, 95) == pytest.approx(4.8)
    assert stats.percentile(list(range(1, 101)), 95) == pytest.approx(95.05)


def test_failures_count_as_missing_every_limit():
    ok = [10.0] * 99
    # one failure in 100: it sorts last, so p95 stays finite and p100 is
    # infinite; ten failures in 100 make p95 infinite
    assert stats.percentile(ok + [stats.FAILED], 95) == 10.0
    assert math.isinf(stats.percentile(ok + [stats.FAILED], 100))
    assert math.isinf(stats.percentile([10.0] * 90 + [stats.FAILED] * 10,
                                       95))
    # a failure is slower than any statement that came back
    assert stats.percentile([1e9, stats.FAILED], 50) == math.inf


def test_latency_metrics_over_the_window():
    lat = [10.0] * 50 + [20.0] * 50
    m = stats.latency_metrics(lat, 100, 2.0)
    assert m["qps"] == 50.0
    assert m["latency_p50_ms"] == pytest.approx(15.0)
    assert m["latency_p95_ms"] == pytest.approx(20.0)


def test_spread_is_the_quartile_distance_over_the_median():
    v = [10.0, 10.2, 9.8, 10.1, 9.9, 10.0]
    q1, q2, q3 = statistics.quantiles(v, n=4)
    assert stats.spread(v) == pytest.approx((q3 - q1) / q2)


def test_client_metrics_count_failures_and_a_starved_client():
    from portbench import run, spec
    from portbench.window import Done

    def rec(client, ms, error=None):
        return Done(0, 0.0, ms / 1e3, [], error, "window", client=client)
    # client 0 completes 8 statements, client 1 two and one failure
    records = [rec(0, 10.0)] * 8 + [rec(1, 100.0)] * 2 + \
        [rec(1, 5.0, "RuntimeError: x")]
    r = run.Reading(traffic={"clients": 2}, window_records=records)
    assert spec.metric_reader("client_fairness").read(r) == \
        pytest.approx(100.0 * 2 * 2 / 10)
    assert spec.metric_reader("client_latency_p50_ms").read(r) == \
        pytest.approx(10.0)
    assert math.isinf(spec.metric_reader("client_latency_p95_ms").read(r))
    one = run.Reading(traffic={"clients": 1}, window_records=records)
    assert spec.metric_reader("client_fairness").read(one) is None
