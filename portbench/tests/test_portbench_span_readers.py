"""The readers of the port's spans over a synthetic window of ``(name,
start, end)`` spans: their arithmetic, the ``.c10`` twins, and ``None``
where a run holds none of the spans a reader reads."""

import pytest

from portbench import spec
from portbench.run import Reading

# two statements: lock wait, query (parse, syncs, aggregate inside), rows
SPANS = [
    ("lock_wait", 0.000, 0.001),
    ("query", 0.001, 0.011),
    ("parse", 0.001, 0.003),
    ("aggregate", 0.004, 0.010),
    ("sync", 0.005, 0.006),
    ("sync", 0.007, 0.009),
    ("to_rows", 0.011, 0.012),
    ("lock_wait", 0.012, 0.015),
    ("query", 0.015, 0.021),
    ("parse", 0.015, 0.016),
    ("sync", 0.017, 0.020),
    ("to_rows", 0.021, 0.024),
]

# per statement, in ms
WANT = {
    "lock_wait_ms": (1 + 3) / 2,
    "executor_host_ms": ((10 + 6) - (2 + 1) - (1 + 2 + 3)) / 2,
    "sync_wait_ms": (1 + 2 + 3) / 2,
    "to_rows_ms": (1 + 3) / 2,
    "aggregate_ms": 6 / 2,
}


def read(name, spans):
    return spec.metric_reader(name).read(Reading(spans=spans))


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_arithmetic(name):
    assert read(name, SPANS) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", ["executor_host_ms", "sync_wait_ms",
                                  "to_rows_ms"])
def test_c10_twin_reads_its_base(name):
    assert read(name + ".c10", SPANS) == read(name, SPANS)


@pytest.mark.parametrize("name", sorted(WANT))
def test_none_without_the_spans(name):
    assert read(name, []) is None
    # a run of the program before these spans: only query and parse
    older = [s for s in SPANS if s[0] in ("query", "parse")]
    if name == "executor_host_ms":
        assert read(name, older) == pytest.approx((16 - 3) / 2)
    else:
        assert read(name, older) is None
