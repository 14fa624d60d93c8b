import pytest

from portbench import roofline
from portbench.run import Reading
from portbench.spec import metric_reader
from portbench.trace import Interval, Trace


def test_k1_bytes_count_each_input_once():
    n, d = 8_000_000, 768
    b = roofline.k1_bytes(n, d, 1)
    # int8 codes, three f32 sides and the f32 mask a row, the query, one
    # f32 bound a 128-row segment
    assert b == n * d + n * 16 + d * 4 + (n // 128) * 4
    assert roofline.bound_s(b) == pytest.approx(b / 3.35e12)
    assert roofline.k2_bytes(n, d, 1) == n * d * 4 + n * 8 + d * 4 \
        + (n // 128) * 4


def test_k1_roofline_from_the_trace():
    n, d = 8_000_000, 768
    least = roofline.bound_s(roofline.k1_bytes(n, d, 1))
    evs = [Interval("segmin_sq8_wgmma<16, 1>", 0.0, least * 2e6),
           Interval("quantize_queries_kernel", 0.0, 0.0),
           Interval("segmin_sq8_wgmma<16, 1>", 10.0, 10.0 + least * 2e6),
           Interval("segmin_f32_kernel<1>", 0.0, 1e4)]
    r = Reading(cfg={"rows": n, "dim": d},
                trace=Trace(evs, 1e5, 1e4, []))
    share = metric_reader("k1_roofline").read(r)
    assert share == pytest.approx(50.0)
    r.trace = Trace([Interval("segmin_f32_kernel<1>", 0.0, 1.0)], 10, 1, [])
    assert metric_reader("k1_roofline").read(r) is None
    r.trace = None
    assert metric_reader("k1_roofline").read(r) is None


def test_device_readers():
    r = Reading(trace=Trace([], 1000.0, 250.0, []), traced_statements=5)
    assert metric_reader("device_idle_share").read(r) == pytest.approx(75.0)
    assert metric_reader("device_ms_per_query").read(r) == pytest.approx(
        0.05)
    r = Reading(launches={"segmin_sq8": 40, "segmin_f32": 10})
    assert metric_reader("sq8_fallback_share").read(r) == 25.0
    r = Reading(launches={"segmin_sq8": 0, "segmin_f32": 3})
    assert metric_reader("sq8_fallback_share").read(r) is None
    r = Reading(spans=[("parse", 1.0, 1.002), ("query", 1.0, 1.01),
                       ("parse", 2.0, 2.004)])
    assert metric_reader("parse_ms").read(r) == pytest.approx(3.0)
    r = Reading(syncs=12, sync_statements=4)
    assert metric_reader("host_syncs_per_query").read(r) == 3.0
    r = Reading(syncs=None, sync_statements=0)
    assert metric_reader("host_syncs_per_query").read(r) is None
