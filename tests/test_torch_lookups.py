"""Join and Set engines, joinGet/joinGetOrDefault/joinGetOrNull, ``x IN
set_table`` and table-sourced dictionaries with dictGet/dictGetOrDefault/
dictHas, through both packages (after tests/test_join_set_engines.py and
the table-source cases of tests/test_dictionaries.py)."""

import numpy as np
import pytest
import torch

import myscaledb_tpu
import myscaledb_tpu_torch

torch.set_num_threads(1)


def _setup(s):
    s.sql("CREATE TABLE jt (k UInt32, v String, w Int32) "
          "ENGINE = Join(ANY, LEFT, k)")
    s.sql("INSERT INTO jt VALUES (1, 'one', 10), (2, 'two', 20), "
          "(3, 'three', 30), (2, 'dup', 99)")
    s.sql("CREATE TABLE facts (id UInt32, k UInt32) ENGINE = Memory")
    s.sql("INSERT INTO facts VALUES (100, 1), (101, 3), (102, 9), (103, 2)")
    s.sql("CREATE TABLE js (name String, code Int32) "
          "ENGINE = Join(ANY, LEFT, name)")
    s.sql("INSERT INTO js VALUES ('aa', 7), ('bb', 8)")
    # joinGet's join builds: a dense key range (the direct lookup), a
    # sparse one (binary search) and two keys probed with NULLs
    s.sql("CREATE TABLE jdense (k Int64, v Int32) "
          "ENGINE = Join(ANY, LEFT, k)")
    s.sql("INSERT INTO jdense VALUES (0, 50), (1, 51), (2, 52), (3, 53), "
          "(2, 99), (4, 54), (5, 55), (6, 56), (7, 57)")
    s.sql("CREATE TABLE jsparse (k Int64, v String) "
          "ENGINE = Join(ANY, LEFT, k)")
    s.sql("INSERT INTO jsparse VALUES (5, 'five'), (1000000000000, 'tera'), "
          "(1000000000000000, 'peta'), (5, 'dup')")
    s.sql("CREATE TABLE probe2 (k Int64) ENGINE = Memory")
    s.sql("INSERT INTO probe2 VALUES (5), (1000000000000000), (17), "
          "(1000000000000)")
    s.sql("CREATE TABLE j2 (a Int32, b String, v Int32) "
          "ENGINE = Join(ANY, LEFT, a, b)")
    s.sql("INSERT INTO j2 VALUES (1, 'x', 10), (1, 'y', 11), (2, 'x', 20), "
          "(1, 'x', 99)")
    s.sql("CREATE TABLE np (id UInt32, a Nullable(Int32), b String) "
          "ENGINE = Memory")
    s.sql("INSERT INTO np VALUES (1, 1, 'x'), (2, NULL, 'x'), (3, 2, 'x'), "
          "(4, 1, 'y'), (5, 2, 'z'), (6, NULL, 'y')")
    s.sql("CREATE TABLE st (k UInt32) ENGINE = Set")
    s.sql("INSERT INTO st VALUES (1), (9)")
    s.create_table("countries", {
        "code": np.array([1, 2, 7, 100], dtype=np.uint64),
        "name": ["France", "Germany", "Japan", "Nowhere"],
        "pop_m": np.array([68.0, 84.0, 125.0, 0.0], dtype=np.float64)})
    s.create_table("events", {
        "id": np.arange(6, dtype=np.int64),
        "country": np.array([1, 2, 7, 7, 99, 1], dtype=np.uint64)})
    s.sql("CREATE DICTIONARY country_dict (code UInt64, name String, "
          "pop_m Float64) PRIMARY KEY code SOURCE(TABLE 'countries') "
          "LAYOUT(FLAT()) LIFETIME(0)")
    s.create_table("m", {"k": np.array([10**12, 5, 10**15], dtype=np.int64),
                         "v": ["a", "b", "c"]})
    s.create_table("probe", {"k": np.array([5, 10**15, 17], dtype=np.int64)})
    s.sql("CREATE DICTIONARY d (k Int64, v String) PRIMARY KEY k "
          "SOURCE(TABLE 'm') LAYOUT(HASHED())")
    s.sql("CREATE DICTIONARY d2 (k Int64, v String) PRIMARY KEY k "
          "SOURCE(CLICKHOUSE(TABLE 'm')) LAYOUT(FLAT())")
    s.create_table("mm", {"name": ["fr", "de", "jp"],
                          "capital": ["Paris", "Berlin", "Tokyo"]})
    s.create_table("q", {"c": ["de", "xx", "fr"]})
    s.sql("CREATE DICTIONARY geo (name String, capital String) PRIMARY KEY "
          "name SOURCE(TABLE 'mm') LAYOUT(COMPLEX_KEY_HASHED())")


@pytest.fixture(scope="module")
def sessions():
    out = (myscaledb_tpu.connect(), myscaledb_tpu_torch.connect(device="cpu"))
    for s in out:
        _setup(s)
    return out


QUERIES = [
    "SELECT id, joinGet('jt', 'v', k) AS v, joinGet('jt', 'w', k) AS w "
    "FROM facts ORDER BY id",
    "SELECT joinGet('jt', 'v', 2)",
    "SELECT joinGetOrNull('jt', 'v', k) FROM facts ORDER BY id",
    "SELECT joinGetOrDefault('jt', 'w', k, -1) FROM facts ORDER BY id",
    "SELECT joinGetOrDefault('jt', 'v', k, 'none') FROM facts ORDER BY id",
    "SELECT f.id, j.v FROM facts AS f ANY LEFT JOIN jt AS j ON f.k = j.k "
    "ORDER BY f.id",
    "SELECT id FROM facts WHERE k IN st ORDER BY id",
    "SELECT id FROM facts WHERE k NOT IN st ORDER BY id",
    "SELECT joinGet('js', 'code', 'bb')",
    "SELECT joinGet('js', 'code', name) FROM (SELECT 'aa' AS name)",
    "SELECT joinGet('js', 'code', 'zz')",
    "SELECT id, joinGetOrDefault('jdense', 'v', k, -1) FROM facts "
    "ORDER BY id",
    "SELECT k, joinGetOrNull('jsparse', 'v', k) FROM probe2 ORDER BY k",
    "SELECT id, joinGetOrNull('j2', 'v', a, b) FROM np ORDER BY id",
    "SELECT id, joinGet('j2', 'v', a, b) FROM np ORDER BY id",
    "SELECT id, dictGet('country_dict', 'name', country) AS n FROM events "
    "ORDER BY id",
    "SELECT id, dictGetOrDefault('country_dict', 'pop_m', country, -1.0) "
    "AS p FROM events ORDER BY id",
    "SELECT id FROM events WHERE NOT dictHas('country_dict', country) "
    "ORDER BY id",
    "SELECT dictGet('country_dict', 'name', 7)",
    "SELECT dictHas('country_dict', 99)",
    "SELECT dictGet('d', 'v', k) FROM probe",
    "SELECT dictGet('d2', 'v', 5)",
    "SELECT dictGet('geo', 'capital', c) FROM q",
    "SELECT dictGet('geo', 'capital', 'jp')",
    "SELECT dictGet('country_dict', 'name', country) AS n, count() FROM "
    "events WHERE dictHas('country_dict', country) GROUP BY n ORDER BY n",
    "SELECT name, key, layout, source, element_count FROM "
    "system.dictionaries",
    "SHOW DICTIONARIES",
]


@pytest.mark.parametrize("sql", QUERIES)
def test_lookups_match_the_jax_package(sessions, sql):
    j, p = sessions
    assert p.sql_tsv(sql) == j.sql_tsv(sql)


@pytest.mark.parametrize("sql", [
    "SELECT joinGet('facts', 'k', 1)",
    "SELECT joinGet('jt', 'v', 1, 2)",
    "SELECT joinGet('jt', 'nope', 1)",
    "SELECT dictGet('nope', 'name', 1)",
    "SELECT dictGet('geo', 'capital', 1)",
])
def test_lookup_errors_match(sessions, sql):
    j, p = sessions
    with pytest.raises(Exception) as want:
        j.sql(sql)
    with pytest.raises(Exception) as got:
        p.sql(sql)
    assert str(got.value) == str(want.value)


def test_reload_truncate_and_drop(tmp_path, monkeypatch):
    """A dictionary is a snapshot until SYSTEM RELOAD; TRUNCATE empties a
    Join table; DROP DICTIONARY forgets it; a file source (since the
    formats slice) snapshots the file as the JAX package does."""
    out = []
    stmts = ["INSERT INTO countries VALUES (8, 'Italy', 59.0)",
             "SELECT dictGet('country_dict', 'name', 8)",
             "SYSTEM RELOAD DICTIONARY country_dict",
             "SELECT dictGet('country_dict', 'name', 8)",
             "SELECT element_count FROM system.dictionaries WHERE name = "
             "'country_dict'",
             "TRUNCATE TABLE jt",
             "SELECT joinGet('jt', 'v', 2)",
             "DROP DICTIONARY country_dict",
             "DROP DICTIONARY IF EXISTS country_dict",
             "SHOW DICTIONARIES"]
    for s in (myscaledb_tpu.connect(),
              myscaledb_tpu_torch.connect(device="cpu")):
        _setup(s)
        out.append([s.sql_tsv(q) for q in stmts])
        with pytest.raises(Exception):
            s.sql("SELECT dictGet('country_dict', 'name', 1)")
    assert out[0] == out[1]
    monkeypatch.chdir(tmp_path)
    (tmp_path / "ref.csv").write_text("3,gamma\n1,alpha\n2,beta\n")
    files = []
    for s in (myscaledb_tpu.connect(),
              myscaledb_tpu_torch.connect(device="cpu")):
        s.sql("CREATE DICTIONARY fd (k UInt64, v String) PRIMARY KEY k "
              "SOURCE(FILE(PATH 'ref.csv' FORMAT 'CSV'))")
        files.append([s.sql_tsv(q) for q in (
            "SELECT dictGet('fd', 'v', 2)",
            "SELECT name, source, element_count FROM system.dictionaries")])
    assert files[0] == files[1]


def test_join_keys_are_sorted_once_per_epoch(monkeypatch):
    """joinGet over one key probes the Join table's keys sorted once per
    mutation epoch (the session's derived-state cache), not per query."""
    import torch as T
    p = myscaledb_tpu_torch.connect(device="cpu")
    _setup(p)
    sorts = []
    real = T.sort
    monkeypatch.setattr(T, "sort", lambda *a, **k: sorts.append(1)
                        or real(*a, **k))
    for _ in range(3):
        p.sql("SELECT joinGet('jt', 'w', k) FROM facts").to_rows()
    first = len(sorts)
    p.sql("INSERT INTO jt VALUES (9, 'nine', 90)")
    assert p.sql("SELECT joinGet('jt', 'w', k) FROM facts").to_rows() == \
        [(10,), (30,), (90,), (20,)]
    assert first == 1 and len(sorts) == 2
