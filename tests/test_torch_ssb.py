"""The Star Schema Benchmark's 13 statements and the join path they take,
on the CPU.

- SSB at a few thousand lineorder rows: the benchmark's generator
  (``portbench/datagen/ssb.py``) with its row counts scaled down, the
  statements of ``portbench/traffic/ssb13_serial.json`` through
  ``Session.sql_as`` and ``to_rows()``, each compared exactly with the
  plain reference (``portbench/reference/ssb_sf100.py``).
- The join path against the JAX package (values, NULLs and row order):
  ALL joins over unique build keys (the ANY probe) and over duplicate keys
  (the fan-out) under every direction; WHERE conjuncts moved below the
  joins only where the join kind keeps their meaning; ``SELECT *`` across
  two joins; no row index copied to the host on the unique-key path; the
  ``join`` span and its three children; a per-query memory limit that
  refuses a large join."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import myscaledb_tpu
import myscaledb_tpu_torch
from myscaledb_tpu_torch.ops import join
from myscaledb_tpu_torch.runtime import metrics as M
from myscaledb_tpu_torch.runtime.memory import MemoryLimitExceeded
from myscaledb_tpu_torch.runtime import tracing
from myscaledb_tpu_torch.sql import executor
from myscaledb_tpu_torch.sql.parser import parse_sql
from myscaledb_tpu_torch.sql.render import render
from portbench import load
from portbench.datagen import ssb
from portbench.reference import ssb_sf100 as reference

torch.set_num_threads(1)

BENCH = Path(__file__).resolve().parents[1] / "portbench"
CFG = json.loads((BENCH / "configs" / "ssb_sf100.json").read_text())
TRAFFIC = json.loads((BENCH / "traffic" / "ssb13_serial.json").read_text())
STATEMENTS = {s["name"]: s["sql"] for s in TRAFFIC["statements"]}
SEED = 2 ** 33 + 2022


@pytest.fixture(scope="module")
def star():
    cfg = dict(CFG, rows=6000)          # ~6,000 lineorder rows
    data = ssb.make(cfg, SEED, "cpu")
    return load.open_session(cfg, data, "cpu"), data


def test_the_scaled_tables_keep_the_spec_shapes(star):
    _, data = star
    t = data["tables"]
    assert set(t) == set(CFG["tables"])
    for name, schema in CFG["tables"].items():
        assert [c for c, _ in schema] == list(t[name])
    lo = t["lineorder"]
    n = lo["lo_orderkey"].shape[0]
    assert 3000 < n < 9000 and t["dwdate"]["d_datekey"].shape[0] == 2556
    ext = lo["lo_extendedprice"].long()
    assert torch.equal(ext, lo["lo_quantity"].long() * ssb.retail_cents(
        lo["lo_partkey"]).long())
    assert torch.equal(lo["lo_revenue"].long(),
                       ext * (100 - lo["lo_discount"].long()) // 100)
    assert int(lo["lo_linenumber"].max()) <= 7
    assert bool((lo["lo_custkey"] % 3 != 0).all())
    assert bool((lo["lo_commitdate"] > lo["lo_orderdate"]).all())
    # String columns that name one key each hold distinct values
    for tname, col in (("customer", "c_name"), ("customer", "c_address"),
                       ("customer", "c_phone"), ("supplier", "s_address")):
        values = t[tname][col][1]
        assert len(set(values)) == len(values)


@pytest.mark.parametrize("name", sorted(STATEMENTS))
def test_ssb_statement_equals_the_reference(star, name):
    session, data = star
    rows = session.sql_as(None, STATEMENTS[name]).to_rows()
    want = reference.answer(data, name)
    assert reference.matches(name, rows, want), (rows[:5], want[:5])


def test_the_control_breaks_the_guarantee(star):
    """lo_revenue summed in float32 comes out wrong in some statement."""
    _, data = star
    items = [({"name": n}, reference.answer(data, n)) for n in STATEMENTS]
    assert reference.judge(CFG, data, items)["numbers"][
        "wrong_statements"] == 0
    rows = reference.control_rows(CFG, data, items)
    assert reference.judge(CFG, data, [
        (p, r) for (p, _), r in zip(items, rows)])["numbers"][
        "wrong_statements"] > 0


# ---------------------------------------------------------------------------
# the join path against the JAX package


def _tables():
    rng = np.random.default_rng(22)
    n = 400
    return {
        "l": {"k": rng.integers(0, 90, n).astype(np.int32),
              "lv": np.arange(n, dtype=np.int64),
              "t": rng.integers(0, 100, n).astype(np.int32),
              "s": [("ab", "cd", "ef")[i] for i in rng.integers(0, 3, n)]},
        # unique build keys, some never probed and some probes missing
        "u": {"k": rng.permutation(np.arange(10, 110)).astype(np.int32),
              "uv": 1000 + np.arange(100, dtype=np.int64),
              "t": rng.integers(0, 100, 100).astype(np.int32)},
        # duplicate build keys: the fan-out
        "d": {"k": rng.integers(10, 110, 150).astype(np.int32),
              "uv": 2000 + np.arange(150, dtype=np.int64),
              "t": rng.integers(0, 100, 150).astype(np.int32)},
        "w": {"uv": 1000 + np.arange(0, 100, 2, dtype=np.int64),
              "x": np.arange(50, dtype=np.int32)},
        # sparse unique keys over a wide range: the binary-search probe
        "sp": {"k": (np.arange(0, 100) * 1_000_003).astype(np.int64),
               "sv": np.arange(100, dtype=np.int64)},
    }


@pytest.fixture(scope="module")
def sessions():
    j = myscaledb_tpu.connect()
    p = myscaledb_tpu_torch.connect(device="cpu")
    for name, data in _tables().items():
        j.create_table(name, data)
        p.create_table(name, data)
    return j, p


def _rows(t):
    return [tuple(repr(x) for x in r) for r in t.to_rows()]


def _same(sessions, sql):
    j, p = sessions
    jt, pt = j.sql(sql), p.sql(sql)
    assert pt.column_names == jt.column_names, sql
    assert _rows(pt) == _rows(jt), sql
    return pt


@pytest.mark.parametrize("how", ["INNER", "LEFT", "RIGHT", "FULL"])
@pytest.mark.parametrize("build", ["u", "d"])
def test_unique_key_all_join_against_the_fan_out(sessions, monkeypatch,
                                                 build, how):
    calls = []
    real = join.probe_all
    monkeypatch.setattr(join, "probe_all",
                        lambda *a: calls.append(1) or real(*a))
    before = M.events_snapshot().get(M.JOIN_ROWS_TO_HOST, 0)
    _same(sessions, f"SELECT lv, uv, {build}.t FROM l {how} JOIN {build} "
                    f"ON l.k = {build}.k")
    # unique keys take the ANY probe; duplicates fan out by binary search
    assert bool(calls) == (build == "d")
    assert M.events_snapshot().get(M.JOIN_ROWS_TO_HOST, 0) == before


@pytest.mark.parametrize("sql", [
    "SELECT lv, sv FROM l INNER JOIN sp ON l.lv = sp.k",
    "SELECT lv, sv FROM l LEFT JOIN sp ON l.lv = sp.k",
    "SELECT lv, uv FROM l ANY LEFT JOIN d ON l.k = d.k",
    "SELECT lv, uv FROM l ANY INNER JOIN d ON l.k = d.k",
    "SELECT * FROM l SEMI LEFT JOIN d ON l.k = d.k",
    "SELECT * FROM l ANTI LEFT JOIN d ON l.k = d.k",
])
def test_probe_without_a_probe_side_sort(sessions, monkeypatch, sql):
    """Single integer keys never reach the merge sort of build plus probe
    rows, and copy no row index to the host."""
    monkeypatch.setattr(join, "build_join_table", None)
    monkeypatch.setattr(join, "probe_join_table", None)
    before = M.events_snapshot().get(M.JOIN_ROWS_TO_HOST, 0)
    _same(sessions, sql)
    assert M.events_snapshot().get(M.JOIN_ROWS_TO_HOST, 0) == before


# (statement, conjuncts left in WHERE, conjuncts moved per source: the
# FROM table, then each join's table)
PUSHDOWN = [
    ("SELECT lv, uv FROM l INNER JOIN u ON l.k = u.k "
     "WHERE l.t < 50 AND u.t > 30", [], [["t < 50"], ["t > 30"]]),
    # a right-side conjunct of a LEFT join stays: its NULL rows must go
    ("SELECT lv, uv FROM l LEFT JOIN u ON l.k = u.k "
     "WHERE l.t < 50 AND u.t > 30", ["u.t > 30"], [["t < 50"], []]),
    # under RIGHT ALL the right side is the kept one
    ("SELECT lv, uv FROM l RIGHT JOIN u ON l.k = u.k "
     "WHERE l.t < 50 AND u.t > 30", ["l.t < 50"], [[], ["t > 30"]]),
    ("SELECT lv, uv FROM l FULL JOIN u ON l.k = u.k "
     "WHERE l.t < 50 AND u.t > 30", ["l.t < 50", "u.t > 30"], [[], []]),
    # ANY picks the lowest matching build row first: its build side stays
    ("SELECT lv, uv FROM l ANY INNER JOIN d ON l.k = d.k "
     "WHERE l.t < 50 AND d.t > 30", ["d.t > 30"], [["t < 50"], []]),
    ("SELECT lv, uv FROM l SEMI LEFT JOIN d ON l.k = d.k "
     "WHERE l.t < 50 AND d.t > 30", ["d.t > 30"], [["t < 50"], []]),
    ("SELECT lv, uv FROM l ANTI LEFT JOIN d ON l.k = d.k WHERE l.t < 50",
     [], [["t < 50"], []]),
    ("SELECT lv, uv, d.t FROM l INNER JOIN d ON l.k = d.k "
     "WHERE d.t > 30 AND l.s = 'cd' AND l.t + d.t < 120",
     ["l.t + d.t < 120"], [["s = 'cd'"], ["t > 30"]]),
    # a later RIGHT join keeps the earlier sides where they stand
    ("SELECT lv, uv, x FROM l INNER JOIN u ON l.k = u.k RIGHT JOIN w "
     "ON u.uv = w.uv WHERE l.t < 50 AND u.t > 30 AND w.x > 3",
     ["l.t < 50", "u.t > 30"], [[], [], ["x > 3"]]),
    # names of both sides (t) are left unqualified only where unique
    ("SELECT lv, uv, x FROM l INNER JOIN u ON l.k = u.k INNER JOIN w "
     "ON u.uv = w.uv WHERE t < 50 AND x > 3 AND lv > 10",
     ["t < 50"], [["lv > 10"], [], ["x > 3"]]),
    # a SELECT alias and a non-deterministic call stay
    ("SELECT lv AS v, uv FROM l INNER JOIN u ON l.k = u.k "
     "WHERE v > 10 AND rand() >= 0", ["v > 10", "rand() >= 0"], [[], []]),
]


@pytest.mark.parametrize("sql,stays,moved", PUSHDOWN)
def test_where_conjuncts_below_the_joins(sessions, monkeypatch, sql, stays,
                                         moved):
    _, p = sessions
    calls = []
    real = executor._filter_side
    monkeypatch.setattr(
        executor, "_filter_side",
        lambda s, t, terms, keep=None: calls.append(
            [render(x) for x in terms]) or real(s, t, terms, keep))
    q = parse_sql(sql)
    new_q, _base, plan = executor._plan_joins(p, q, p.tables[q.table])
    assert [render(t) for t in executor._split_conjuncts(new_q.where)] \
        == stays
    assert calls[:1] + [[render(t) for t in terms]
                        for _r, terms, _k in plan] == moved
    if "rand()" not in sql:
        _same(sessions, sql)


def test_select_star_across_two_joins_returns_every_column(sessions):
    t = _same(sessions, "SELECT * FROM l INNER JOIN u ON l.k = u.k "
                        "INNER JOIN w ON u.uv = w.uv WHERE l.t < 60")
    assert t.column_names == ["k", "lv", "t", "s", "u.k", "uv", "u.t",
                              "w.uv", "x"]


def test_a_join_carries_only_what_the_statement_reads(sessions):
    before = M.events_snapshot().get(M.JOIN_CARRIED_BYTES, 0)
    _same(sessions, "SELECT sum(uv) FROM l INNER JOIN u ON l.k = u.k "
                    "WHERE l.t < 60")
    carried = M.events_snapshot()[M.JOIN_CARRIED_BYTES] - before
    _, p = sessions
    n = len(p.sql("SELECT lv FROM l INNER JOIN u ON l.k = u.k "
                  "WHERE l.t < 60").to_rows())
    assert carried == 8 * n          # uv alone (int64): no key, no lv


def test_count_over_a_join_that_reads_no_column(sessions):
    _same(sessions, "SELECT count() FROM l INNER JOIN u ON l.k = u.k")
    _same(sessions, "SELECT count() FROM l LEFT JOIN d ON l.k = d.k "
                    "WHERE l.t > 20")


def test_join_span_tree(sessions):
    _, p = sessions
    tracing.span_log_snapshot()
    tracing.clear_span_log()
    p.sql("SELECT lv, uv FROM l INNER JOIN u ON l.k = u.k "
          "INNER JOIN d ON l.k = d.k").to_rows()
    spans = tracing.span_log_snapshot()
    tracing.clear_span_log()
    joins = [s for s in spans if s.name == "join"]
    assert len(joins) == 2
    for j in joins:
        kids = sorted((s.name, s.start) for s in spans
                      if s.parent_span_id == j.span_id)
        assert sorted(k for k, _ in kids) == ["join_build", "join_gather",
                                              "join_probe"]
        order = [k for k, _ in sorted(kids, key=lambda x: x[1])]
        assert order == ["join_build", "join_probe", "join_gather"]
        assert j.attributes["how"] == "INNER"
    query = next(s for s in spans if s.name == "query")
    assert all(j.parent_span_id == query.span_id for j in joins)


@pytest.mark.parametrize("sql", [
    "SELECT count(), sum(uv) FROM big INNER JOIN u ON big.k = u.k",
    "SELECT count(), sum(uv) FROM big ALL INNER JOIN d ON big.k = d.k",
    "SELECT count(), sum(uv) FROM big ANY LEFT JOIN d ON big.k = d.k",
    "SELECT count(), sum(uv) FROM big INNER JOIN u ON big.k = u.k "
    "SETTINGS join_algorithm = 'grace_hash'",
])
def test_a_small_memory_limit_refuses_a_large_join(sql):
    """The probe's tensors over 200,000 rows are charged to the query's
    budget: a 1 MiB limit refuses the join that the default one runs."""
    p = myscaledb_tpu_torch.connect(device="cpu")
    j = myscaledb_tpu.connect()
    big = {"k": np.random.default_rng(5).integers(0, 120, 200_000)
           .astype(np.int32)}
    for s in (p, j):
        s.create_table("big", big)
        for name in ("u", "d"):
            s.create_table(name, _tables()[name])
    assert p.sql(sql).to_rows() == j.sql(sql).to_rows()
    p.settings.max_memory_bytes_per_query = 1 << 20
    with pytest.raises(MemoryLimitExceeded, match="join_probe"):
        p.sql(sql)
