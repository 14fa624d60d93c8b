"""ORDER BY ... WITH FILL through SQL against the JAX package on the CPU:
the five WITH FILL cases of tests/test_fill_sample.py (with their own
expected rows), Nullable columns, floats, LIMIT and OFFSET after the fill,
and the error texts (the STEP's sign, a non-numeric or missing fill
column)."""

import numpy as np
import pytest
import torch

import myscaledb_tpu
import myscaledb_tpu_torch

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def sessions():
    j = myscaledb_tpu.connect()
    p = myscaledb_tpu_torch.connect(device="cpu")
    for s in (j, p):
        s.create_table("m", {"t": np.array([1, 3, 4, 7], dtype=np.int64),
                             "v": np.array([10.0, 30.0, 40.0, 70.0])})
        s.create_table("lab", {"t": np.array([1, 3], dtype=np.int64),
                               "tag": ["a", "c"]})
        s.create_table("fl", {"x": np.array([0.5, 2.0, 1.25],
                                            dtype=np.float32),
                              "u": np.array([3, 9, 1], dtype=np.uint32)})
        s.sql("CREATE TABLE n (k Nullable(Int32), s Nullable(String), "
              "w Nullable(Float64)) ENGINE = Memory")
        s.sql("INSERT INTO n VALUES (2, 'x', 1.5), (NULL, NULL, NULL), "
              "(6, 'y', NULL), (3, NULL, 2.5)")
    return j, p


# tests/test_fill_sample.py's WITH FILL cases, with its expected rows
FILL_SAMPLE_CASES = [
    ("SELECT t, v FROM m ORDER BY t WITH FILL",
     [(1, 10.0), (2, 0.0), (3, 30.0), (4, 40.0), (5, 0.0), (6, 0.0),
      (7, 70.0)]),
    ("SELECT t FROM m ORDER BY t WITH FILL FROM 0 TO 10 STEP 2",
     [(0,), (1,), (2,), (3,), (4,), (6,), (7,), (8,)]),
    ("SELECT t FROM m ORDER BY t DESC WITH FILL",
     [(7,), (6,), (5,), (4,), (3,), (2,), (1,)]),
    ("SELECT t, tag FROM lab ORDER BY t WITH FILL",
     [(1, "a"), (2, ""), (3, "c")]),
    ("SELECT t FROM m ORDER BY t WITH FILL LIMIT 3", [(1,), (2,), (3,)]),
]


@pytest.mark.parametrize("stmt,rows", FILL_SAMPLE_CASES)
def test_fill_sample_case(sessions, stmt, rows):
    j, p = sessions
    assert p.sql(stmt).to_rows() == rows
    assert p.sql_tsv(stmt) == j.sql_tsv(stmt)


MORE_CASES = [
    "SELECT t, v FROM m ORDER BY t DESC WITH FILL STEP -2",
    "SELECT t FROM m ORDER BY t WITH FILL FROM -2 TO 5",
    "SELECT t FROM m ORDER BY t WITH FILL LIMIT 4 OFFSET 2",
    "SELECT t FROM m WHERE t > 100 ORDER BY t WITH FILL",
    "SELECT t FROM m WHERE t > 100 ORDER BY t WITH FILL FROM 1 TO 4",
    "SELECT x, u FROM fl ORDER BY x WITH FILL STEP 0.25",
    "SELECT u, x FROM fl ORDER BY u WITH FILL STEP 3",
    # Nullable columns: the NULL row's stored value takes part in the
    # grid; filled rows are not NULL in the fill column, NULL-free
    # defaults elsewhere
    "SELECT k, s, w FROM n ORDER BY k WITH FILL",
    "SELECT k, w FROM n ORDER BY k DESC NULLS FIRST WITH FILL",
    "SELECT w, k FROM n ORDER BY w WITH FILL STEP 0.5",
]


@pytest.mark.parametrize("stmt", MORE_CASES)
def test_fill_matches_jax(sessions, stmt):
    j, p = sessions
    assert p.sql_tsv(stmt) == j.sql_tsv(stmt)


def test_fill_unsigned_desc(sessions):
    """Pinned divergence: DESC WITH FILL over a UInt32 column.  The JAX
    package computes min + STEP in the column's uint32 and fails
    (OverflowError); the port stores UInt32 widened to int64 and fills."""
    j, p = sessions
    stmt = "SELECT u FROM fl ORDER BY u DESC WITH FILL STEP -3"
    with pytest.raises(OverflowError):
        j.sql(stmt)
    assert p.sql(stmt).to_rows() == [(9,), (6,), (3,), (1,), (0,)]


ERROR_CASES = [
    "SELECT t FROM m ORDER BY t WITH FILL STEP -1",
    "SELECT t FROM m ORDER BY t DESC WITH FILL STEP 1",
    "SELECT t FROM m ORDER BY t WITH FILL STEP 0",
    "SELECT t, tag FROM lab ORDER BY tag WITH FILL",
    "SELECT v FROM m ORDER BY t WITH FILL",
]


@pytest.mark.parametrize("stmt", ERROR_CASES)
def test_fill_error_texts(sessions, stmt):
    j, p = sessions
    with pytest.raises(Exception) as je:
        j.sql(stmt)
    with pytest.raises(Exception) as pe:
        p.sql(stmt)
    assert (type(pe.value).__name__, str(pe.value)) == \
        (type(je.value).__name__, str(je.value))
