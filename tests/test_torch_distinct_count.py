"""Exact distinct counts on the CPU: K6's plain version
(ops/kernels/distinct_count.py::distinct_count_plain), the sort path it
replaced for one integer key (sql/agg_fns.py::_distinct_first_hit and a
bincount) and the JAX package through SQL agree on every case; and the
``system.events`` counters name the route each distinct aggregate took:
``HashDistinctAggregates`` for the single-key uniq kinds,
``SortDistinctAggregates`` for sumDistinct, avgDistinct, several
arguments and array arguments.  The kernel itself runs on the card only
(tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

import myscaledb_tpu
import myscaledb_tpu_torch
from myscaledb_tpu.config import Settings as JSettings
from myscaledb_tpu_torch.config import Settings
from myscaledb_tpu_torch.exec.expr import Value
from myscaledb_tpu_torch.interop import table_from_numpy
from myscaledb_tpu_torch.ops.kernels.distinct_count import (
    distinct_count, distinct_count_plain)
from myscaledb_tpu_torch.runtime import metrics as M
from myscaledb_tpu_torch.sql.agg_fns import (_distinct_first_hit,
                                             _distinct_key)

torch.set_num_threads(1)

N = 3000
I64 = np.iinfo(np.int64)
WORDS = ["alpha", "beta", "", "gamma", "delta"]


def _data(rng):
    i64 = rng.integers(-40, 40, N).astype(np.int64) * (2 ** 40 + 3)
    i64[:4] = [I64.min, I64.max, 0, -1]
    f = rng.choice(np.array([0.0, -0.0, 1.5, -2.25, np.nan],
                            dtype=np.float32), N)
    return {
        "g": rng.integers(0, 7, N).astype(np.int32),
        "h": rng.integers(0, 400, N).astype(np.int32),
        "w": np.arange(N, dtype=np.int64),
        "i16": rng.integers(-300, 300, N).astype(np.int16),
        "i32": rng.integers(-2 ** 31, 2 ** 31 - 1, N).astype(np.int32) % 997,
        "i64": i64,
        "c": np.full(N, 42, dtype=np.int32),
        "s": [WORDS[i] for i in rng.integers(0, len(WORDS), N)],
        "f": f,
        "b": rng.random(N) < 0.3,
    }


@pytest.fixture(scope="module")
def sessions():
    data = _data(np.random.default_rng(11))
    j = myscaledb_tpu.connect(JSettings())
    p = myscaledb_tpu_torch.connect(Settings(), device="cpu")
    j.create_table("t", data)
    p.register("t", table_from_numpy(data, "cpu"))
    ddl = ("CREATE TABLE n (k Int32, y Nullable(Int64), s Nullable(String)) "
           "ENGINE = MergeTree ORDER BY k")
    rows = ", ".join(f"({i % 4}, {'NULL' if i % 3 == 0 else (i * 7) % 11}, "
                     f"{'NULL' if i % 5 == 0 else repr(str(i % 6))})"
                     for i in range(90))
    ddl_a = ("CREATE TABLE a (k Int32, xs Array(Int32)) ENGINE = MergeTree "
             "ORDER BY k")
    arrays = ", ".join(f"({i % 3}, {[i % 4, (i * 5) % 3][:i % 3]})"
                       for i in range(30))
    for s in (j, p):
        s.sql(ddl)
        s.sql(f"INSERT INTO n VALUES {rows}")
        s.sql(ddl_a)
        s.sql(f"INSERT INTO a VALUES {arrays}")
    return j, p, data


# (table, argument, GROUP BY key or None, WHERE)
CASES = {
    "int16_one_group": ("t", "i16", None, ""),
    "int32_many_groups": ("t", "i32", "h", ""),
    "int64_extremes": ("t", "i64", "g", ""),
    "one_value_in_every_group": ("t", "c", "h", ""),
    "masked_rows": ("t", "i64", "g", "WHERE w % 3 = 0"),
    "dictionary_string": ("t", "s", "g", ""),
    "float_zeros_and_nan": ("t", "f", "g", ""),
    "bool": ("t", "b", "h", ""),
    "empty_selection": ("t", "i32", "g", "WHERE w < 0"),
    "nullable_int": ("n", "y", "k", ""),
    "nullable_string": ("n", "s", None, ""),
}


def _events(*names):
    ev = M.events_snapshot()
    return tuple(ev.get(k, 0) for k in names)


def _port_inputs(p, table, arg, grp, where):
    """(gid, key, mask, G) of the statement's distinct count, made from the
    port's own columns as the executor makes them."""
    t = p.tables[table]
    col = t[arg]
    n = col.data.shape[0]
    key = _distinct_key(Value(col.data, col.valid, col.dictionary), n)
    mask = torch.ones(n, dtype=torch.bool)
    if col.valid is not None:
        mask &= col.valid
    w = t["w"].data if "w" in t else None
    if where == "WHERE w % 3 = 0":
        mask &= w % 3 == 0
    elif where == "WHERE w < 0":
        mask &= w < 0
    if grp is None:
        return torch.zeros(n, dtype=torch.int32), key, mask, 1
    g = t[grp].data.to(torch.int32)
    return g, key, mask, int(g.max()) + 1


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_sort_path_and_jax_agree(sessions, case):
    j, p, _data_ = sessions
    table, arg, grp, where = CASES[case]
    aggs = f"count(DISTINCT {arg}), uniq({arg}), uniqExact({arg})"
    sql = (f"SELECT {aggs} FROM {table} {where}" if grp is None else
           f"SELECT {grp}, {aggs} FROM {table} {where} GROUP BY {grp} "
           f"ORDER BY {grp}")
    before = _events("HashDistinctAggregates", "SortDistinctAggregates")
    got = p.sql(sql).to_rows()
    after = _events("HashDistinctAggregates", "SortDistinctAggregates")
    assert after[0] - before[0] == 3 and after[1] == before[1]
    assert got == j.sql(sql).to_rows()
    assert p.sql_tsv(sql) == j.sql_tsv(sql)

    gid, key, mask, G = _port_inputs(p, table, arg, grp, where)
    plain = distinct_count_plain(gid, key, mask, G)
    wrapper = distinct_count(gid, key, mask, G)
    n = key.shape[0]
    _rows, groups = _distinct_first_hit([Value(key)], gid, mask, n)
    sort_path = torch.bincount(groups, minlength=G)[:G]
    want = np.zeros(G, dtype=np.int64)
    kn, gn, mn = key.numpy(), gid.numpy(), mask.numpy()
    for gg in range(G):
        want[gg] = len(set(kn[(gn == gg) & mn].tolist()))
    assert plain.tolist() == wrapper.tolist() == sort_path.tolist() \
        == want.tolist()


def test_plain_version_skips_rows_outside_the_groups():
    gid = torch.tensor([0, 1, 2, -1, 5, 1, 0], dtype=torch.int32)
    key = torch.tensor([7, 7, 7, 7, 7, 8, 7], dtype=torch.int64)
    mask = torch.tensor([1, 1, 1, 1, 1, 1, 0], dtype=torch.bool)
    assert distinct_count_plain(gid, key, mask, 3).tolist() == [1, 2, 1]
    assert distinct_count(gid, key, mask, 3).tolist() == [1, 2, 1]


def test_wrapper_refuses_what_the_kernel_cannot_take():
    gid = torch.zeros(4, dtype=torch.int32)
    mask = torch.ones(4, dtype=torch.bool)
    with pytest.raises(ValueError, match="integer"):
        distinct_count(gid, torch.zeros(4), mask, 1)
    with pytest.raises(ValueError, match="shape"):
        distinct_count(gid[:3], torch.zeros(4, dtype=torch.int64), mask, 1)
    with pytest.raises(ValueError, match="num_groups"):
        distinct_count(gid, torch.zeros(4, dtype=torch.int64), mask, 0)
    with pytest.raises(ValueError, match="power of two"):
        distinct_count(gid, torch.zeros(4, dtype=torch.int64), mask, 1,
                       capacity_slots=48)


def test_table_is_charged_to_the_query_budget():
    from myscaledb_tpu_torch.ops.kernels.distinct_count import (
        SLOT_BYTES, capacity)
    from myscaledb_tpu_torch.runtime.memory import (MemoryLimitExceeded,
                                                    query_scope)
    assert capacity(0) == 64 and capacity(100) == 256
    assert capacity(100_000_000) == 2 ** 28
    assert capacity(100_000_000) * SLOT_BYTES == 2 ** 32
    n = 5000
    gid = torch.zeros(n, dtype=torch.int32)
    key = torch.arange(n, dtype=torch.int64)
    mask = torch.ones(n, dtype=torch.bool)
    table = capacity(n) * SLOT_BYTES
    with query_scope(table):
        assert distinct_count(gid, key, mask, 1).tolist() == [n]
    with query_scope(table - 1):
        with pytest.raises(MemoryLimitExceeded, match="distinct_hash"):
            distinct_count(gid, key, mask, 1)


# statement -> (HashDistinctAggregates, SortDistinctAggregates) it adds
ROUTES = {
    "SELECT g, uniq(i64), uniqExact(s), countDistinct(f), "
    "count(DISTINCT b), uniqCombined(i16) FROM t GROUP BY g ORDER BY g":
        (5, 0),
    "SELECT g, sumDistinct(i16) FROM t GROUP BY g ORDER BY g": (0, 1),
    "SELECT avgDistinct(i32), sum(DISTINCT h) FROM t": (0, 2),
    "SELECT g, uniqExact(i16, s), count(DISTINCT g, h) FROM t GROUP BY g "
    "ORDER BY g": (0, 2),
    "SELECT k, uniqExact(xs) FROM a GROUP BY k ORDER BY k": (0, 1),
    "SELECT uniqHLL12(i64) FROM t": (0, 0),
}
# the JAX package fails on an array argument of uniqExact (its sort gets
# the flat elements beside the rows), so that statement's rows are given:
# k = 0 holds only empty arrays, k = 1 [0], [1], [2], [3], k = 2 [0, 1],
# [1, 1], [2, 1], [3, 1]
ARRAY_ROWS = [(0, 1), (1, 4), (2, 4)]


@pytest.mark.parametrize("sql", sorted(ROUTES))
def test_distinct_routes_are_counted(sessions, sql):
    j, p, _data_ = sessions
    before = _events("HashDistinctAggregates", "SortDistinctAggregates")
    got = p.sql(sql).to_rows()
    after = _events("HashDistinctAggregates", "SortDistinctAggregates")
    assert (after[0] - before[0], after[1] - before[1]) == ROUTES[sql]
    want = ARRAY_ROWS if "FROM a " in sql else j.sql(sql).to_rows()
    assert repr(got) == repr(want)
