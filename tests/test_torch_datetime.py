"""Date/DateTime values and the calendar functions of
myscaledb_tpu_torch/exec/datetime_fns.py against the JAX package on the
CPU: one seeded numpy table built into both packages with
``interop.table_from_numpy(..., dtypes=...)`` (DataType.DATE and
DATETIME), the same SQL through both, rows compared exactly.  The edges
day 0 and 65535 and DateTime 0 and 2^32-1 are rows of the table.  The
civil-calendar math is compared bit for bit over every Date day
0..65535; ``now()``/``today()`` are checked as tests/test_datetime.py
checks them: type, format and a window around the host's clock."""

import datetime as dt

import numpy as np
import pytest
import torch

import myscaledb_tpu
import myscaledb_tpu_torch
from myscaledb_tpu.core.types import DataType as JDataType
from myscaledb_tpu_torch.core.types import DataType
from myscaledb_tpu_torch.interop import table_from_numpy

torch.set_num_threads(1)

N = 400


def _data(rng):
    days = rng.integers(0, 65536, N).astype(np.int32)
    secs = rng.integers(0, 2 ** 32, N).astype(np.int64)
    days[:2] = [0, 65535]
    secs[:2] = [0, 2 ** 32 - 1]
    return {"id": np.arange(N, dtype=np.int64), "d": days, "ts": secs,
            "k": rng.integers(-30, 30, N).astype(np.int32),
            "s": np.array([dt.date(1970, 1, 1).isoformat(), "2024-02-29",
                           "1999-12-31 23:59:59"] * (N // 3) +
                          ["2000-01-01"] * (N - 3 * (N // 3)), dtype=object)}


@pytest.fixture(scope="module")
def sessions():
    data = _data(np.random.default_rng(8))
    j = myscaledb_tpu.connect()
    p = myscaledb_tpu_torch.connect(device="cpu")
    j.create_table("ev", data, dtypes={"d": JDataType.DATE,
                                       "ts": JDataType.DATETIME})
    p.register("ev", table_from_numpy(
        data, "cpu", dtypes={"d": DataType.DATE, "ts": DataType.DATETIME}))
    return j, p


def _exact(rows):
    return [tuple(repr(x) for x in r) for r in rows]


SQL = [
    "SELECT id, d, ts FROM ev",
    "SELECT toYear(d), toMonth(d), toDayOfMonth(d), toDayOfWeek(d), "
    "toDayOfYear(d), toQuarter(d) FROM ev",
    "SELECT toYear(ts), toMonth(ts), toHour(ts), toMinute(ts), toSecond(ts),"
    " toDayOfWeek(ts) FROM ev",
    "SELECT toYYYYMM(d), toYYYYMMDD(d), toYYYYMMDDhhmmss(ts), "
    "toYYYYMM(ts) FROM ev",
    "SELECT toStartOfYear(d), toStartOfQuarter(d), toStartOfMonth(d), "
    "toMonday(d), toStartOfWeek(d), toStartOfDay(d) FROM ev",
    "SELECT toStartOfHour(ts), toStartOfMinute(ts), "
    "toStartOfFifteenMinutes(ts), toStartOfFiveMinutes(ts), "
    "toStartOfMonth(ts) FROM ev",
    "SELECT addDays(d, k), addWeeks(d, -3), addMonths(d, k), addYears(d, 1),"
    " addQuarters(d, 2), subtractMonths(d, 13), subtractDays(d, 1) FROM ev",
    "SELECT addHours(ts, k), addMinutes(ts, 7), addSeconds(ts, -1), "
    "subtractSeconds(ts, 30), addMonths(ts, k), addDays(ts, 2), "
    "subtractWeeks(ts, 1) FROM ev",
    "SELECT dateAdd('month', 3, d), dateSub('day', k, d), "
    "date_add('hour', 5, ts), timestampSub('minute', 2, ts) FROM ev",
    "SELECT dateDiff('day', d, toDate('2024-01-01')), "
    "dateDiff('week', d, toDate('2024-01-01')), "
    "dateDiff('month', d, toDate('2024-01-01')), "
    "dateDiff('quarter', d, toDate('2024-01-01')), "
    "dateDiff('year', d, toDate('2024-01-01')), "
    "dateDiff('hour', ts, toDateTime('2024-01-01 00:00:00')), "
    "dateDiff('second', toDateTime(d), ts) FROM ev",
    "SELECT d + 1, d - 1, d - k, ts + 60, ts - ts, d - toDate('2000-01-01') "
    "FROM ev",
    "SELECT toDate(ts), toDateTime(d), toDate(k + 19000), "
    "toDateTime(k * 100000 + 1000000000), toUnixTimestamp(ts), "
    "toUnixTimestamp(d), fromUnixTimestamp(id * 86400) FROM ev",
    "SELECT toDate(s), toDateTime(s), toUnixTimestamp(s) FROM ev",
    "SELECT toString(d), toString(ts), concat('d=', toString(d)), "
    "formatDateTime(ts, '%Y/%m/%d %H:%M:%S'), formatDateTime(d, '%F %j') "
    "FROM ev",
    "SELECT id FROM ev WHERE d >= '2024-01-01' ORDER BY id",
    "SELECT id FROM ev WHERE ts < '1990-06-01 12:00:00' AND d != '1970-01-01'"
    " ORDER BY id",
    "SELECT id FROM ev WHERE d BETWEEN '2000-01-01' AND '2030-12-31' "
    "ORDER BY id",
    "SELECT id FROM ev WHERE toDate(ts) = '2106-02-07' OR d = '2149-06-06'",
    "SELECT min(d), max(d), min(ts), max(ts), any(d) FROM ev",
    "SELECT toStartOfMonth(d) AS m, count() AS c FROM ev GROUP BY m "
    "ORDER BY m",
    "SELECT toHour(ts) AS h, count(), min(ts) FROM ev GROUP BY h ORDER BY h",
    "SELECT d, ts FROM ev ORDER BY d DESC, ts LIMIT 20",
    "SELECT makeDate(2024, 2, 29), makeDateTime(2024, 2, 29, 13, 45, 7), "
    "makeDate(1970 + k % 5, 1 + k % 12 + 12, 31) FROM ev LIMIT 5",
    "SELECT dateDiff('day', toDate('2024-01-01'), toDate('2024-03-01')), "
    "toDate('2024-03-01') - toDate('2024-02-01'), "
    "toUnixTimestamp(toDateTime('2024-01-01 00:00:00')), "
    "fromUnixTimestamp(1704067200), toDate('2149-06-06') + 0",
]


@pytest.mark.parametrize("sql", SQL)
def test_statement_matches(sessions, sql):
    j, p = sessions
    # the JAX package floors %, the port truncates as ClickHouse does
    # (ROADMAP section 3): its side runs the truncating form spelled out
    jsql = sql.replace("k % 5", "if(k < 0, -((-k) % 5), k % 5)").replace(
        "k % 12", "if(k < 0, -((-k) % 12), k % 12)")
    assert _exact(p.sql(sql).to_rows()) == _exact(j.sql(jsql).to_rows())
    assert p.sql_tsv(sql) == j.sql_tsv(jsql)


def test_result_types_match(sessions):
    j, p = sessions
    sql = ("SELECT d, ts, d + 1, toStartOfMinute(ts), toYear(d), "
           "toDate(ts), dateDiff('day', d, d) FROM ev LIMIT 1")
    assert [f.dtype.value for f in p.sql(sql).schema()] == \
        [f.dtype.value for f in j.sql(sql).schema()]


def test_civil_calendar_is_bit_equal_over_every_date():
    from myscaledb_tpu.exec import datetime_fns as jd
    from myscaledb_tpu_torch.exec import datetime_fns as pd
    import jax.numpy as jnp
    days = np.arange(0, 65536, dtype=np.int64)
    jy, jm, jdd = (np.asarray(a) for a in jd.civil_from_days(
        jnp.asarray(days)))
    py, pm, pdd = (a.numpy() for a in pd.civil_from_days(
        torch.from_numpy(days)))
    assert (py == jy).all() and (pm == jm).all() and (pdd == jdd).all()
    back = pd.days_from_civil(torch.from_numpy(py), torch.from_numpy(pm),
                              torch.from_numpy(pdd)).numpy()
    jback = np.asarray(jd.days_from_civil(jnp.asarray(jy), jnp.asarray(jm),
                                          jnp.asarray(jdd)))
    assert (back == days).all() and (jback == days).all()


def test_insert_date_literals_through_ddl():
    j = myscaledb_tpu.connect()
    p = myscaledb_tpu_torch.connect(device="cpu")
    for s in (j, p):
        s.sql("CREATE TABLE e2 (d Date, ts DateTime, n UInt8) "
              "ENGINE = MergeTree ORDER BY n")
        s.sql("INSERT INTO e2 VALUES ('2024-06-01', '2024-06-01 12:00:00', 1),"
              " ('1970-01-01', '1970-01-01 00:00:00', 2), "
              "('2149-06-06', '2106-02-07 06:28:15', 3), (19000, 0, 4)")
    sql = "SELECT d, ts, n, toYYYYMM(d), d + 1 FROM e2 ORDER BY n"
    assert p.sql_tsv(sql) == j.sql_tsv(sql)
    assert p.sql("SELECT d, ts FROM e2 ORDER BY n").to_rows()[0] == \
        (dt.date(2024, 6, 1), dt.datetime(2024, 6, 1, 12))


def test_now_and_today_follow_the_host_clock():
    p = myscaledb_tpu_torch.connect(device="cpu")
    before = dt.datetime.now().replace(microsecond=0)
    t = p.sql("SELECT now() AS n, today() AS t, yesterday() AS y, "
              "toTypeName(now()) AS tn, toTypeName(today()) AS dn")
    after = dt.datetime.now()
    (n, d, y, tn, dn), = t.to_rows()
    assert before - dt.timedelta(seconds=1) <= n <= after
    assert d in (before.date(), after.date())
    assert y == d - dt.timedelta(days=1)
    assert (tn, dn) == ("DateTime", "Date")
    assert [f.dtype for f in t.schema()][:3] == \
        [DataType.DATETIME, DataType.DATE, DataType.DATE]
    line = p.sql_tsv("SELECT now(), today()").split("\t")
    dt.datetime.strptime(line[0], "%Y-%m-%d %H:%M:%S")
    dt.date.fromisoformat(line[1].strip())


def test_bad_date_literal_errors_in_both():
    j, p = myscaledb_tpu.connect(), myscaledb_tpu_torch.connect(device="cpu")
    for s in (j, p):
        with pytest.raises(Exception, match="cannot parse date literal"):
            s.sql("SELECT toDate('2024-13-45')")
