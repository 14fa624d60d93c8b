"""Five faults of the port against the JAX package, each held by statements
run through both packages on the CPU (ROADMAP section 3): OFFSET past the
end of the rows, the NULL branch of if() and CASE without ELSE (with
string branches), LEFT/FULL JOIN onto an empty table with a String column,
UInt64 aggregates past 2^63-1 or over no rows, and arithmetic over UInt
columns; and a fault of the reference the port repairs, min/max/any over a
String column.  Where the port keeps another answer than the JAX
package's, the test pins both and points to the ROADMAP entry."""

import numpy as np
import pytest
import torch

import myscaledb_tpu
import myscaledb_tpu_torch
from myscaledb_tpu_torch.exec.expr import EvalError

torch.set_num_threads(1)

N, D = 300, 8
_rng = np.random.default_rng(6)
EMB = _rng.standard_normal((N, D)).astype(np.float32)
PRICE = _rng.integers(0, 100, N).astype(np.int32)
Q = "[" + ",".join(repr(float(v)) for v in EMB[3]) + "]"


@pytest.fixture(scope="module")
def sessions():
    out = []
    for s in (myscaledb_tpu.connect(),
              myscaledb_tpu_torch.connect(device="cpu")):
        s.sql("CREATE TABLE e (id UInt32, n Nullable(Int32), u UInt64, "
              "w UInt32, s UInt16, c Nullable(String)) "
              "ENGINE = MergeTree ORDER BY id")
        s.sql("INSERT INTO e VALUES "
              "(1, NULL, 9223372036854775807, 4294967295, 65535, 'p'), "
              "(2, 5, 1, 1, 1, NULL), (3, NULL, 6, 2, 2, 'q')")
        s.create_table("t", {"id": np.arange(N, dtype=np.int64),
                             "p": PRICE, "emb": EMB})
        s.sql("CREATE TABLE tb (id UInt32, p Int32, bv FixedString(4)) "
              "ENGINE = MergeTree ORDER BY id")
        s.sql("INSERT INTO tb SELECT number, number % 100, "
              "char(number, number * 3, number * 7, 1) FROM numbers(300)")
        s.sql("CREATE TABLE l (id UInt32, k Int32) "
              "ENGINE = MergeTree ORDER BY id")
        s.sql("INSERT INTO l VALUES (1, 10), (2, 20), (3, 30)")
        for t in ("r0", "rx"):
            s.sql(f"CREATE TABLE {t} (k Int32, c String, "
                  "cn Nullable(String)) ENGINE = MergeTree ORDER BY k")
        s.sql("INSERT INTO rx VALUES (99, 'x', NULL), (98, 'y', 'z')")
        out.append(s)
    return tuple(out)


def _same(sessions, sql):
    j, p = sessions
    want = j.sql(sql).to_rows()
    got = p.sql(sql).to_rows()
    assert repr(got) == repr(want)


@pytest.mark.parametrize("sql", [
    "SELECT id FROM e ORDER BY id LIMIT 2 OFFSET 5",
    "SELECT id FROM e WHERE id > 1 ORDER BY id DESC LIMIT 10 OFFSET 4",
    # fused distance top-k: k = LIMIT + OFFSET, the WHERE leaves 1 row
    f"SELECT id, distance(emb, {Q}) AS d FROM t WHERE p < 1 "
    "ORDER BY d LIMIT 3 OFFSET 5",
    # binary distance top-k over FixedString, the same way
    "SELECT id, distance(bv, char(1, 2, 3, 4)) AS d FROM tb WHERE p < 1 "
    "ORDER BY d LIMIT 3 OFFSET 5",
])
def test_offset_past_the_end_returns_no_rows(sessions, sql):
    _same(sessions, sql)


@pytest.mark.parametrize("sql", [
    "SELECT id, if(id > 2, 1, NULL) FROM e ORDER BY id",
    "SELECT id, if(id > 2, NULL, w) FROM e ORDER BY id",
    "SELECT CASE WHEN id = 1 THEN 0 END FROM e ORDER BY id",
    "SELECT id, if(id > 1, 'a', NULL) FROM e ORDER BY id",
    "SELECT id, if(id > 1, 'a', 'bb') FROM e ORDER BY id",
    "SELECT id, if(id > 1, c, 'z') FROM e ORDER BY id",
    "SELECT id, if(id > 1, NULL, c) FROM e ORDER BY id",
    "SELECT id, CASE WHEN id = 2 THEN c ELSE 'none' END FROM e ORDER BY id",
    "SELECT if(id = 3, c, 'x') AS v, count() FROM e GROUP BY v ORDER BY v",
])
def test_if_null_and_string_branches(sessions, sql):
    _same(sessions, sql)


@pytest.mark.parametrize("sql,port,jax", [
    ("SELECT if(id > 2, n, 0) FROM e ORDER BY id",
     [(0,), (0,), (None,)], [(None,), (0,), (None,)]),
    ("SELECT CASE WHEN id = 1 THEN 10 WHEN id = 2 THEN 20 END FROM e "
     "ORDER BY id", [(10,), (20,), (None,)], [(None,), (20,), (None,)]),
])
def test_if_takes_the_chosen_branch_validity(sessions, sql, port, jax):
    """A fault of the reference, pinned (ROADMAP section 3, "Known faults
    in the reference itself"): the JAX package's if() over two numeric
    branches takes t.valid & f.valid for every row; the port, as
    ClickHouse, the validity of the branch the condition chose."""
    j, p = sessions
    assert j.sql(sql).to_rows() == jax
    assert p.sql(sql).to_rows() == port


@pytest.mark.parametrize("kind", ["LEFT", "FULL"])
@pytest.mark.parametrize("col", ["c", "cn"])
def test_join_onto_an_empty_table_pads_strings_with_null(sessions, kind,
                                                         col):
    """The JAX package fails on an empty right table (ROADMAP section 3),
    so the port's rows over the empty r0 are held against the JAX
    package's over rx, whose rows match no key: the left rows, with NULL
    in the String and the Nullable(String) column (FULL adds rx's own
    rows, left out here)."""
    j, p = sessions
    got = p.sql(f"SELECT l.id, r0.{col} FROM l {kind} JOIN r0 "
                "ON l.k = r0.k ORDER BY l.id").to_rows()
    want = [r for r in j.sql(f"SELECT l.id, rx.{col} FROM l {kind} JOIN rx "
                             "ON l.k = rx.k ORDER BY l.id").to_rows()
            if r[0] is not None]
    assert got == want == [(1, None), (2, None), (3, None)]


@pytest.mark.parametrize("sql", [
    "SELECT sum(u), avg(u), sum(w), min(u), max(u) FROM e",
    "SELECT max(u), min(u), max(w), min(w), max(s), min(s), sum(u), "
    "avg(u), count() FROM e WHERE id > 10",
    "SELECT id % 2 AS g, sum(u) AS su FROM e GROUP BY g ORDER BY g",
    "SELECT id % 2 AS g, sum(u) AS su FROM e GROUP BY g ORDER BY su DESC",
    "SELECT id % 2 AS g, sum(u) AS su FROM e GROUP BY g ORDER BY su LIMIT 1",
])
def test_uint64_aggregates(sessions, sql):
    """sum(u) past 2^63-1 and its avg, and min/max over no rows, as the
    JAX package gives them (the result column holds such a value on the
    host; ingest still refuses it)."""
    _same(sessions, sql)


@pytest.mark.parametrize("expr,row,port,jax", [
    ("w * 2", 1, 8589934590, 4294967294),
    ("u - 2", 2, -1, 18446744073709551615),
    ("-w", 1, -4294967295, 1),
    ("s * 2", 1, 131070, 65534),
    ("s * s", 1, 4294836225, 1),
    ("w + 1", 1, 4294967296, 0),
])
def test_uint_arithmetic_follows_clickhouse_types(sessions, expr, row, port,
                                                  jax):
    """Pinned per operator (ROADMAP section 3, "Known faults in the
    reference itself"): the JAX package wraps UInt arithmetic in the
    operand's width; the port gives ClickHouse's results, whose types
    widen (UInt32 * UInt8 is UInt64, UInt16 * UInt16 UInt32) and whose
    minus and negate are signed."""
    j, p = sessions
    sql = f"SELECT {expr} FROM e WHERE id = {row}"
    assert j.sql(sql).to_rows() == [(jax,)]
    assert p.sql(sql).to_rows() == [(port,)]


@pytest.mark.parametrize("expr", ["u + u", "u + 1", "u * 2", "w * w"])
def test_uint64_result_past_int64_is_refused(sessions, expr):
    """A UInt64 result above 2^63-1 cannot be held by the port's int64
    storage: it raises, where int64 arithmetic would print it wrapped
    (u + u at u = 2^63-1 gave -2).  The JAX package, whose UInt64 is
    native, prints 18446744073709551614 for u + u."""
    j, p = sessions
    sql = f"SELECT {expr} FROM e WHERE id = 1"
    if expr == "u + u":
        assert j.sql(sql).to_rows() == [(18446744073709551614,)]
    with pytest.raises(EvalError, match="above 2\\^63-1"):
        p.sql(sql)


def test_uint_arithmetic_tests_overflow_only_where_types_allow_it(
        sessions, monkeypatch):
    """The overflow test reads the device (a host sync), so it runs only
    where the operands' types let the result pass 2^63-1: not for UInt32
    or UInt16 plus or times a literal, nor for UInt16 times UInt32, and
    chained results keep their bound; UInt32 times UInt32 and any UInt64
    operand still take it."""
    from myscaledb_tpu_torch.exec import expr
    _j, p = sessions
    tested = []
    real = expr._refuse_overflow
    monkeypatch.setattr(expr, "_refuse_overflow",
                        lambda *a: tested.append(a[0]) or real(*a))
    rows = p.sql("SELECT w * 2, id + 1, s * w, (w + 1) * 2, s * s + w "
                 "FROM e WHERE id = 1").to_rows()
    assert rows == [(8589934590, 2, 281470681677825, 8589934592,
                     8589803520)]
    assert tested == []
    p.sql("SELECT w * w, u + 1 FROM e WHERE id = 3")
    assert tested == ["*", "+"]


@pytest.fixture(scope="module")
def fruit():
    out = []
    for s in (myscaledb_tpu.connect(),
              myscaledb_tpu_torch.connect(device="cpu")):
        s.sql("CREATE TABLE u (id UInt32, s String, g UInt8, "
              "ns Nullable(String)) ENGINE = MergeTree ORDER BY id")
        s.sql("INSERT INTO u VALUES (1, 'pear', 0, NULL), "
              "(2, 'apple', 1, 'b'), (3, 'zebra', 0, 'a'), "
              "(4, 'mango', 1, NULL)")
        out.append(s)
    return tuple(out)


@pytest.mark.parametrize("sql,port,jax", [
    ("SELECT min(s), max(s), any(s), anyLast(s) FROM u",
     [("apple", "zebra", "pear", "mango")], [(0, 3, 0, "mango")]),
    ("SELECT g, min(s), max(s), minIf(s, id > 1), maxIf(s, id < 4), any(s) "
     "FROM u GROUP BY g ORDER BY g",
     [(0, "pear", "zebra", "zebra", "zebra", "pear"),
      (1, "apple", "mango", "apple", "apple", "apple")],
     [(0, 0, 2, 2, 2, 0), (1, 1, 3, 1, 1, 1)]),
    ("SELECT min(ns), max(ns), any(ns) FROM u", [("a", "b", "b")],
     [(0, 1, 0)]),
    ("SELECT g, max(s) AS m FROM u GROUP BY g ORDER BY m DESC",
     [(0, "zebra"), (1, "mango")], [(1, 3), (0, 2)]),
])
def test_string_min_max_any_return_strings(fruit, sql, port, jax):
    """A fault of the reference, pinned (ROADMAP section 3): the JAX
    package's min/max/minIf/maxIf/any over a String column return the
    dictionary id; the port, as ClickHouse, compares by the dictionary's
    sort rank and returns the string."""
    j, p = fruit
    assert j.sql(sql).to_rows() == jax
    assert p.sql(sql).to_rows() == port


@pytest.mark.parametrize("sql,rows", [
    ("SELECT min(s), max(s), any(s) FROM u WHERE id > 10", [("", "", "")]),
    ("SELECT min(ns), maxIf(ns, id > 3), any(ns) FROM u WHERE id = 1",
     [(None, None, None)]),
    ("SELECT g, minIf(s, id > 3), maxIf(ns, id > 2) FROM u GROUP BY g "
     "ORDER BY g", [(0, "", "a"), (1, "mango", None)]),
])
def test_string_min_max_any_of_no_rows(fruit, sql, rows):
    """Over no rows a String min/max/any gives '' (NULL for a Nullable
    argument), as ClickHouse; the JAX package fails on the empty set or
    prints ids, so only the port's rows are held."""
    _j, p = fruit
    assert p.sql(sql).to_rows() == rows


def test_string_min_max_any_over_a_host_resident_table():
    """A host-resident column sends an aggregation through the streaming
    path, whose merged states would compare dictionary ids: a String
    min/max/any leaves it for the resident path and still returns the
    dictionary's order and the first row's string, while the same
    statement without them streams."""
    from myscaledb_tpu_torch.runtime import metrics as M
    rng = np.random.default_rng(7)
    n = 3000
    words = np.array(["pear", "apple", "zebra", "mango", "kiwi", "fig"])
    g = rng.integers(0, 4, n).astype(np.int32)
    s = [str(w) for w in words[rng.integers(0, 6, n)]]
    v = rng.integers(0, 10000, n).astype(np.int64)
    p = myscaledb_tpu_torch.connect(myscaledb_tpu_torch.config.Settings(
        max_hbm_bytes_per_column=1024, stream_chunk_rows=1000), device="cpu")
    p.create_table("h", {"g": g, "v": v, "s": s})
    assert p.tables["h"]["v"].is_host
    want = []
    for k in range(4):
        rows = np.flatnonzero(g == k)
        grp = [s[i] for i in rows]
        want.append((k, min(grp), max(grp), grp[0], int(v[rows].sum())))
    before = M.events_snapshot().get("StreamingAggregations", 0)
    got = p.sql("SELECT g, min(s), max(s), any(s), sum(v) FROM h "
                "GROUP BY g ORDER BY g").to_rows()
    assert got == want
    assert M.events_snapshot().get("StreamingAggregations", 0) == before
    assert p.sql("SELECT g, sum(v) FROM h GROUP BY g ORDER BY g").to_rows() \
        == [(k, w[-1]) for k, w in enumerate(want)]
    assert M.events_snapshot().get("StreamingAggregations", 0) == before + 1


@pytest.fixture(scope="module")
def fruit_nulls():
    """ROADMAP section 3's table u of the five faults PR 11 repaired."""
    out = []
    for s in (myscaledb_tpu.connect(),
              myscaledb_tpu_torch.connect(device="cpu")):
        s.sql("CREATE TABLE u (id UInt32, g UInt32, s String, "
              "n Nullable(Int32)) ENGINE = MergeTree ORDER BY id")
        s.sql("INSERT INTO u VALUES (1, 0, 'pear', NULL), "
              "(2, 1, 'apple', 3), (3, 0, 'zebra', 4), (4, 1, 'mango', NULL), "
              "(5, 2, 'pear', 1)")
        out.append(s)
    return tuple(out)


@pytest.mark.parametrize("sql,port,jax", [
    ("SELECT id, count(n) OVER (PARTITION BY g) FROM u ORDER BY id",
     [1, 1, 1, 1, 1], [2, 2, 2, 2, 1]),
    ("SELECT id, avg(n) OVER () FROM u ORDER BY id",
     [pytest.approx(8 / 3)] * 5, [pytest.approx(1.6)] * 5),
    ("SELECT id, min(n) OVER (ORDER BY id) FROM u ORDER BY id",
     [None, 3, 3, 3, 1], [0, 0, 0, 0, 0]),
    ("SELECT id, max(s) OVER (ORDER BY id) FROM u ORDER BY id",
     ["pear", "pear", "zebra", "zebra", "zebra"], [0, 1, 2, 3, 3]),
    ("SELECT id, min(s) OVER (PARTITION BY g) FROM u ORDER BY id",
     ["pear", "apple", "pear", "apple", "pear"], [0, 1, 0, 1, 0]),
    ("SELECT id, sum(n) OVER (ORDER BY id) FROM u ORDER BY id",
     [None, 3, 7, 7, 8], [0, 3, 7, 7, 8]),
])
def test_window_aggregates_skip_nulls_and_compare_strings(fruit_nulls, sql,
                                                          port, jax):
    """Window sum/count/avg/min/max skip NULLs, a frame with no value
    gives NULL, and String min/max compare by the dictionary's sort rank
    and return the string, as ClickHouse does; the JAX package reads the
    raw data and the dictionary ids (ROADMAP section 3)."""
    j, p = fruit_nulls
    assert [r[1] for r in p.sql(sql).to_rows()] == port
    assert [r[1] for r in j.sql(sql).to_rows()] == jax


def test_window_sum_of_a_string_raises(fruit_nulls):
    """sum/avg OVER a String column raise, as ClickHouse does; the JAX
    package sums the dictionary ids (6 on every row)."""
    j, p = fruit_nulls
    assert j.sql("SELECT sum(s) OVER () FROM u").to_rows() == [(6,)] * 5
    for fn in ("sum", "avg"):
        with pytest.raises(Exception, match="String"):
            p.sql(f"SELECT {fn}(s) OVER () FROM u")


@pytest.mark.parametrize("sql,port,jax", [
    ("SELECT -5 % 3, 5 % -3, intDiv(-5, 3), intDiv(5, -3)",
     [(-2, 2, -1, -1)], [(1, -1, -2, -2)]),
    ("SELECT (id - 10) % 4 FROM u ORDER BY id",
     [(-1,), (0,), (-3,), (-2,), (-1,)], [(3,), (0,), (1,), (2,), (3,)]),
    ("SELECT moduloOrZero(-7, 2), intDivOrZero(-7, 2), -5.5 % 3",
     [(-1, -3, -2.5)], None),
])
def test_modulo_and_intdiv_truncate(fruit_nulls, sql, port, jax):
    """% and intDiv round toward zero, as ClickHouse does; the JAX package
    floors (and wraps (id - 10) over UInt32 first)."""
    j, p = fruit_nulls
    assert p.sql(sql).to_rows() == port
    if jax is not None:
        assert j.sql(sql).to_rows() == jax


@pytest.mark.parametrize("sql,rows,jax", [
    ("SELECT g, arrayFilter(x -> x > 1, [g, 2]) AS a FROM u "
     "GROUP BY a, g ORDER BY g", [(0, [2]), (1, [2]), (2, [2, 2])], None),
    ("SELECT a, count() FROM (SELECT arrayFilter(x -> x > 0, [g]) AS a "
     "FROM u) GROUP BY a", [([], 2), ([1], 2), ([2], 1)], None),
    ("SELECT a, count() FROM (SELECT [s] AS a FROM u) GROUP BY a "
     "ORDER BY a DESC", [(["zebra"], 1), (["pear"], 2), (["mango"], 1),
                         (["apple"], 1)],
     [("zebra", 1), ("pear", 2), ("mango", 1), ("apple", 1)]),
    ("SELECT countDistinct(a), uniqExact(a) FROM "
     "(SELECT [g, 1] AS a FROM u)", [(3, 3)], None),
])
def test_group_by_and_distinct_over_arrays(fruit_nulls, sql, rows, jax):
    """GROUP BY, ORDER BY and count(DISTINCT) over an array compare whole
    arrays, as ClickHouse does; the JAX package fails on these (None
    below: a shape error in its sort or broadcast) or, over one-element
    String arrays, returns the element (ROADMAP section 3)."""
    j, p = fruit_nulls
    assert p.sql(sql).to_rows() == rows
    if jax is None:
        with pytest.raises((TypeError, ValueError), match="shapes"):
            j.sql(sql)
    else:
        assert j.sql(sql).to_rows() == jax


def test_type_name_of_widened_unsigned_arithmetic(fruit_nulls):
    """UInt32 * 2 and UInt32 + 1 are UInt64 in ClickHouse, the type the
    port's arithmetic follows; the JAX package, which wraps in the
    operand's width, says UInt32."""
    j, p = fruit_nulls
    sql = "SELECT toTypeName(id * 2), toTypeName(id + 1), toTypeName(id) " \
          "FROM u LIMIT 1"
    assert p.sql(sql).to_rows() == [("UInt64", "UInt64", "UInt32")]
    assert j.sql(sql).to_rows() == [("UInt32", "UInt32", "UInt32")]


def test_hex_escapes_are_raw_bytes(fruit_nulls):
    """'\\xHH' escapes are raw bytes: '\\xC3\\xA9' holds the bytes of 'é'
    and reads as it, as in ClickHouse; a byte that is not UTF-8 stays the
    engine's one-byte character (char(), unhex()).  The JAX package
    decodes each escape to a code point ('\\xC3\\xA9' is 'Ã©')."""
    j, p = fruit_nulls
    sql = "SELECT '\\xC3\\xA9' = 'é', '\\xe4\\xbd\\xa0\\xe5\\xa5\\xbd', " \
          "'\\xC3' = char(195), '\\xC3' = unhex('C3'), 'a\\x41\\x7a'"
    assert p.sql(sql).to_rows() == [(True, "你好", True, True, "aAz")]
    assert j.sql(sql).to_rows() == [(False, "ä½\xa0å¥½", True, True, "aAz")]
