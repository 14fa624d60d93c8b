"""The -State/-Merge combinators and finalizeAggregation through both
packages (after tests/test_combinators.py): state strings byte-equal to
the JAX package's for sum/count/min/max/avg/uniq over integers, floats
and strings; a state written by either package merges in the other; and
the -State path takes no pass over all rows per group."""

import time

import numpy as np
import pytest
import torch

import myscaledb_tpu
import myscaledb_tpu_torch

torch.set_num_threads(1)


def _data(n=600, seed=3):
    rng = np.random.default_rng(seed)
    return {"k": rng.integers(0, 7, n).astype(np.uint32),
            "v": rng.integers(-500, 500, n).astype(np.int64),
            "i": rng.integers(-100, 100, n).astype(np.int32),
            "f": rng.standard_normal(n).astype(np.float64) * 1e3,
            "g": rng.standard_normal(n).astype(np.float32),
            "s": np.array(["ant", "bee", "cat", "", "dog"])[
                rng.integers(0, 5, n)]}


@pytest.fixture(scope="module")
def sessions():
    j = myscaledb_tpu.connect()
    p = myscaledb_tpu_torch.connect(device="cpu")
    for s in (j, p):
        s.create_table("t", _data())
    return j, p


STATE_SQL = [
    "SELECT k, sumState(v), countState(v), minState(v), maxState(v), "
    "avgState(v) FROM t GROUP BY k ORDER BY k",
    "SELECT k, sumState(i), minState(i), avgState(i) FROM t GROUP BY k "
    "ORDER BY k",
    "SELECT k, sumState(f), avgState(f), minState(f), maxState(f), "
    "sumState(g), maxState(g) FROM t GROUP BY k ORDER BY k",
    "SELECT k, uniqState(s), uniqState(v), uniqState(f) FROM t GROUP BY k "
    "ORDER BY k",
    "SELECT sumState(v), countState(i), uniqState(i) FROM t",
    "SELECT k, sumState(v), minState(f) FROM t WHERE v > 400 GROUP BY k "
    "ORDER BY k",
    "SELECT k, quantileTDigestState(f) FROM t GROUP BY k ORDER BY k",
]


@pytest.mark.parametrize("sql", STATE_SQL)
def test_state_strings_are_byte_equal(sessions, sql):
    j, p = sessions
    want, got = j.sql(sql).to_rows(), p.sql(sql).to_rows()
    assert got == want


MERGE_SQL = [
    "SELECT {fn}Merge(st) FROM (SELECT k, {fn}State(v) AS st FROM t "
    "GROUP BY k)",
    "SELECT {fn}Merge(st) FROM (SELECT k, {fn}State(f) AS st FROM t "
    "GROUP BY k)",
    "SELECT k % 2 AS h, {fn}Merge(st) FROM (SELECT k, {fn}State(i) AS st "
    "FROM t GROUP BY k) GROUP BY h ORDER BY h",
]


@pytest.mark.parametrize("fn", ["sum", "count", "min", "max", "avg",
                                "uniq"])
@pytest.mark.parametrize("sql", MERGE_SQL)
def test_merge_matches_the_jax_package(sessions, fn, sql):
    j, p = sessions
    sql = sql.format(fn=fn)
    assert p.sql_tsv(sql) == j.sql_tsv(sql)


def test_merge_equals_the_plain_aggregate(sessions):
    """The two-phase shape of tests/test_combinators.py: per-key states
    merged equal the aggregate over the rows."""
    _j, p = sessions
    for fn in ("sum", "count", "min", "max", "avg"):
        merged = p.sql_tsv(f"SELECT {fn}Merge(st) FROM (SELECT k, "
                           f"{fn}State(v) AS st FROM t GROUP BY k)")
        assert merged == p.sql_tsv(f"SELECT {fn}(v) FROM t"), fn
    est = p.sql("SELECT uniqMerge(st) FROM (SELECT k, uniqState(s) AS st "
                "FROM t GROUP BY k)").to_rows()[0][0]
    assert abs(est - 5) <= 1


@pytest.mark.parametrize("sql", [
    "SELECT k, finalizeAggregation(st) FROM (SELECT k, sumState(v) AS st "
    "FROM t GROUP BY k) ORDER BY k",
    "SELECT k, finalizeAggregation(a), finalizeAggregation(u), "
    "finalizeAggregation(m), finalizeAggregation(q) FROM (SELECT k, "
    "avgState(f) AS a, uniqState(s) AS u, minState(v) AS m, "
    "quantileTDigestState(f) AS q FROM t GROUP BY k) ORDER BY k",
    "SELECT k, finalizeAggregation(c) FROM (SELECT k, countState(f) AS c "
    "FROM t WHERE f > 2000 GROUP BY k) ORDER BY k",
    "SELECT quantileTDigestMerge(0.9)(st) FROM (SELECT k, "
    "quantileTDigestState(f) AS st FROM t GROUP BY k)",
])
def test_finalize_and_tdigest_match(sessions, sql):
    j, p = sessions
    assert p.sql_tsv(sql) == j.sql_tsv(sql)


def _states(s, sql):
    return [r[1] for r in s.sql(sql).to_rows()]


@pytest.mark.parametrize("fn,col", [("sum", "v"), ("avg", "f"),
                                    ("max", "i"), ("uniq", "s"),
                                    ("count", "g")])
def test_states_merge_across_packages(sessions, fn, col):
    """A state column written by one package is merged by the other, and
    both merges equal the writer's own."""
    j, p = sessions
    sql = f"SELECT k, {fn}State({col}) AS st FROM t GROUP BY k ORDER BY k"
    merge = f"SELECT {fn}Merge(st) FROM x"
    for writer, reader in ((j, p), (p, j)):
        st = _states(writer, sql)
        for s in (writer, reader):
            s.create_table("x", {"st": np.asarray(st, dtype=object)})
        assert reader.sql_tsv(merge) == writer.sql_tsv(merge)
        for s in (writer, reader):
            s.sql("DROP TABLE x")


def test_state_path_is_not_a_pass_per_group():
    """5000 groups over 200k rows: the -State and -Merge partials come from
    one pass over the rows (the JAX package's loop reads every row once
    per group: 10^9 comparisons here).  On the CPU the whole statement
    pair takes well under 5 s."""
    rng = np.random.default_rng(8)
    n = 200_000
    p = myscaledb_tpu_torch.connect(device="cpu")
    p.create_table("big", {"k": rng.integers(0, 5000, n).astype(np.int64),
                           "v": rng.integers(-9, 9, n).astype(np.int64)})
    t0 = time.perf_counter()
    st = p.sql("SELECT k, sumState(v) AS s, countState(v) AS c, "
               "maxState(v) AS m FROM big GROUP BY k")
    p.register("st", st)
    got = p.sql("SELECT sumMerge(s), countMerge(c), maxMerge(m) FROM st"
                ).to_rows()
    assert time.perf_counter() - t0 < 5.0
    assert st.n_rows == 5000
    assert got == p.sql("SELECT sum(v), count(v), max(v) FROM big").to_rows()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_float_sums_follow_numpys_order(seed):
    """numpy_order_sums, the device sum under float sumState/avgState,
    equals numpy's slice.sum() bit for bit at every length class: under
    8, the eight-lane blocks up to 128, the halving above it, and more
    than one 8192-value buffer."""
    from myscaledb_tpu_torch.sql.agg_fns import numpy_order_sums
    rng = np.random.default_rng(seed)
    lens = np.concatenate([np.arange(0, 140), [255, 1000, 8191, 8192,
                                               8193, 20000, 65537],
                           rng.integers(0, 3000, 20)])
    rng.shuffle(lens)
    n = int(lens.sum())
    vals = rng.standard_normal(n) * 10.0 ** rng.uniform(-3, 6, n)
    got = numpy_order_sums(torch.as_tensor(vals), torch.as_tensor(lens))
    start = np.cumsum(lens) - lens
    want = np.array([vals[a:a + c].sum() for a, c in zip(start, lens)])
    assert got.numpy().tobytes() == want.tobytes()


def test_float_states_of_large_groups_are_byte_equal():
    """Float sumState/avgState over groups of 5 to 20000 rows (past
    pairwise_sum's 128-value blocks and numpy's 8192-value buffers) are
    the JAX package's strings."""
    rng = np.random.default_rng(11)
    sizes = [5, 100, 129, 8193, 20000]
    k = np.repeat(np.arange(len(sizes)), sizes)
    rng.shuffle(k)
    data = {"k": k.astype(np.int64),
            "f": rng.standard_normal(len(k)) * 1e4,
            "g": rng.standard_normal(len(k)).astype(np.float32)}
    sql = ("SELECT k, sumState(f), avgState(f), sumState(g), avgState(g) "
           "FROM t WHERE f > -2e4 GROUP BY k ORDER BY k")
    out = []
    for s in (myscaledb_tpu.connect(),
              myscaledb_tpu_torch.connect(device="cpu")):
        s.create_table("t", data)
        out.append(s.sql(sql).to_rows())
    assert out[1] == out[0]


def test_merge_parses_each_state_once_per_epoch(sessions, monkeypatch):
    """-Merge reads each distinct state string of a dictionary once and
    keeps the parsed numbers in the session's derived-state cache until
    the next mutation."""
    from myscaledb_tpu_torch.sql import agg_fns
    _j, p = sessions
    calls = []
    real = agg_fns._parse_states
    monkeypatch.setattr(agg_fns, "_parse_states",
                        lambda d, dev: calls.append(len(d)) or real(d, dev))
    p.sql("CREATE TABLE ms (k UInt32, st AggregateFunction(sum, Int64)) "
          "ENGINE = AggregatingMergeTree ORDER BY k")
    p.sql("INSERT INTO ms SELECT k, sumState(v) FROM t GROUP BY k")
    for _ in range(3):
        p.sql("SELECT sumMerge(st) FROM ms").to_rows()
    assert len(calls) == 1
    p.sql("INSERT INTO ms SELECT k, sumState(v) FROM t GROUP BY k")
    p.sql("SELECT sumMerge(st) FROM ms").to_rows()
    assert len(calls) == 2
    p.sql("DROP TABLE ms")


@pytest.mark.parametrize("sql", [
    "SELECT sumState(s) FROM t",
    "SELECT countState(s) FROM t",
    "SELECT sumMerge(v) FROM t",
    "SELECT sumState(v, i) FROM t",
])
def test_combinator_errors_match(sessions, sql):
    j, p = sessions
    with pytest.raises(Exception) as want:
        j.sql(sql)
    with pytest.raises(Exception) as got:
        p.sql(sql)
    assert str(got.value) == str(want.value)
