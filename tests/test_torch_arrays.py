"""Array functions and higher-order functions (exec/arrays.py) on the CPU:
one data dict into myscaledb_tpu.connect() and
myscaledb_tpu_torch.connect(device="cpu"), the same SQL through both,
compared on to_rows() and sql_tsv().  Numeric, float and string arrays,
empty arrays, and NULL rows (the right side of a LEFT JOIN that found no
row); floats are multiples of 1/4, so every sum is exact and the two
packages' rows are bit-equal."""

import numpy as np
import pytest
import torch

import myscaledb_tpu
import myscaledb_tpu_torch
from myscaledb_tpu_torch.core.table import DeviceOffsets
from myscaledb_tpu_torch.exec import arrays as A
from myscaledb_tpu_torch.exec.expr import Env
from myscaledb_tpu_torch.sql.ast import Ident

torch.set_num_threads(1)

N = 16


@pytest.fixture(scope="module")
def sessions():
    rng = np.random.default_rng(11)
    words = ["x", "y", "zz", "", "x"]
    lens = rng.integers(0, 5, N)
    lens[3] = 0                                  # empty arrays
    lens[7] = 0
    lens[-1] = 2           # (the JAX package's arrayDistinct fails on a
                           # last row that is empty: see below)
    a = [rng.integers(-3, 6, n).tolist() for n in lens]
    a[5] = [2, 2, 1, 2]                          # repeats
    f = [(rng.integers(-8, 8, n) / 4.0).tolist() for n in lens]
    f[9] = [0.0, -0.0, 1.5, 0.0][:len(f[9])] if len(f[9]) else [0.0, -0.0]
    s = [[words[i] for i in rng.integers(0, 5, n)] for n in lens]
    b = [rng.integers(-3, 6, n).tolist() for n in rng.integers(0, 4, N)]
    data = {"id": np.arange(N, dtype=np.int64), "a": a, "b": b, "s": s,
            "k": rng.integers(-4, 5, N).astype(np.int64),
            "name": [["ab", "", "xyz", None][i % 4] for i in range(N)]}
    fdata = {"id": np.arange(N, dtype=np.int64), "f": f}
    keys = {"rid": np.arange(0, N, 2, dtype=np.int64)}
    j = myscaledb_tpu.connect()
    p = myscaledb_tpu_torch.connect(device="cpu")
    for sess in (j, p):
        sess.create_table("t", data)
        sess.create_table("tf", fdata)
        sess.create_table("l", keys)
        sess.create_table("te", {"a": [[1, 1, 2], []]})
    return j, p


def _same(j, p, sql):
    assert p.sql_tsv(sql) == j.sql_tsv(sql)
    # repr: a NaN equals the other side's NaN, -0.0 only -0.0
    assert repr(p.sql(sql).to_rows()) == repr(j.sql(sql).to_rows())


FUNCTIONS = [
    # membership
    "has(a, 3)", "has(s, 'x')", "has(s, 'nope')", "has(a, k)",
    "indexOf(a, 2)", "indexOf(s, 'zz')", "countEqual(a, 2)",
    "countEqual(s, 'x')", "hasAll(a, [1, 2])", "hasAny(a, [5, -3])",
    "hasAll(a, b)", "hasAny(a, b)", "hasAll(s, ['x', ''])",
    "hasAny(s, ['zz'])", "hasAll(a, [])",
    # element access and slices
    "arrayElement(a, 1)", "a[-1]", "a[10]", "a[0]", "s[2]", "s[-9]",
    "arrayElement(a, k)", "arraySlice(a, 2)", "arraySlice(a, -2, 1)",
    "arraySlice(a, 0, 2)", "arraySlice(s, 2, 9)", "arraySlice(a, k, 2)",
    # reordering and building
    "arrayReverse(a)", "reverse(s)", "reverse(name)", "arrayConcat(a, b)",
    "arrayConcat(s, ['q'], s)", "arrayPushBack(a, 9)",
    "arrayPushFront(s, 'q')", "arrayPushBack(a, k)", "arrayPushBack(a, 2.5)",
    "arrayPopBack(a)", "arrayPopFront(s)", "arraySort(a)",
    "arrayReverseSort(a)", "arraySort(s)", "arrayReverseSort(s)",
    "arrayDistinct(a)", "arrayDistinct(s)", "arrayUniq(a)", "arrayUniq(s)",
    "arrayEnumerate(s)", "range(k)", "range(1, k + 4, 2)",
    # per-row aggregates and shape
    "arraySum(a)", "arrayProduct(a)", "arrayMin(a)", "arrayMax(a)",
    "arrayAvg(a)", "arrayCumSum(a)", "notEmpty(a)", "notEmpty(name)",
    "empty(s)", "length(s)",
]


@pytest.mark.parametrize("expr", FUNCTIONS)
def test_array_functions_match(sessions, expr):
    j, p = sessions
    _same(j, p, f"SELECT id, {expr} AS r FROM t ORDER BY id")


FLOAT_FUNCTIONS = [
    "arraySum(f)", "arrayMin(x -> x + 1, f)", "arrayMax(f)", "arrayAvg(f)",
    "arrayCumSum(f)", "arrayReverseSort(f)", "arrayDistinct(f)",
    "arrayUniq(f)", "has(f, 0.0)", "indexOf(f, 0.0)", "countEqual(f, 1.5)",
]


@pytest.mark.parametrize("expr", FLOAT_FUNCTIONS)
def test_float_array_functions_match(sessions, expr):
    j, p = sessions
    _same(j, p, f"SELECT id, {expr} AS r FROM tf ORDER BY id")


HOFS = [
    "arrayMap(x -> x * 2, a)", "arrayMap(x -> x + k, a)",
    "arrayMap(x -> concat(x, '!'), s)", "arrayMap((x, y) -> x - y, a, a)",
    "arrayMap(x -> 7, a)", "arrayMap(x -> name, s)",
    "arrayFilter(x -> x > 1, a)", "arrayFilter(x -> x != 'x', s)",
    "arrayFilter(x -> x < k, a)", "arrayExists(x -> x = 3, a)",
    "arrayAll(x -> x > -2, a)", "arrayCount(x -> x > 1, a)",
    "arrayFirst(x -> x > 1, a)", "arrayFirst(x -> x = 'zz', s)",
    "arrayFirstIndex(x -> x > 1, a)", "arraySum(x -> x * 2, a)",
    "arrayMin(x -> -x, a)", "arrayMax(x -> x * k, a)",
    "arrayAvg(x -> x + 1, a)", "arraySort(x -> -x, a)",
    "arrayReverseSort(x -> x, s)", "length(arrayFilter(x -> x > 0, a))",
]


@pytest.mark.parametrize("expr", HOFS)
def test_higher_order_functions_match(sessions, expr):
    j, p = sessions
    _same(j, p, f"SELECT id, {expr} AS r FROM t ORDER BY id")


@pytest.mark.parametrize("expr", [
    "has(t.a, 2)", "arraySum(t.a)", "length(t.s)", "arrayMap(x -> x * 2, t.a)",
    "arrayFilter(x -> x != '', t.s)", "notEmpty(t.a)",
])
def test_null_rows_match(sessions, expr):
    """Arrays of rows the LEFT JOIN did not find are NULL."""
    j, p = sessions
    _same(j, p, f"SELECT l.rid, {expr} AS r FROM l LEFT JOIN t "
                "ON l.rid = t.k ORDER BY l.rid, t.id")


@pytest.mark.parametrize("sql", [
    "SELECT id, arrayMap(x -> x, a, b) FROM t",
    "SELECT id, arrayMap((x, y) -> x, a) FROM t",
    "SELECT id, arrayMap(x -> x, a, s) FROM t",
    "SELECT id, upper(x -> x, a) FROM t",
    "SELECT id, has(a, 'x') FROM t",
    "SELECT id, arraySum(s) FROM t",
    "SELECT id, arrayConcat(a, s) FROM t",
    "SELECT id, arrayMap(x -> a, a) FROM t",
    "SELECT id, range(0, 3, 0) FROM t",
    "SELECT reverse(id) FROM t",
])
def test_error_texts_match(sessions, sql):
    j, p = sessions
    with pytest.raises(Exception) as want:
        j.sql(sql)
    with pytest.raises(Exception) as got:
        p.sql(sql)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("sql,want", [
    # a negated literal needle: the JAX package fails ("axis 0 is out of
    # bounds")
    ("SELECT indexOf([1.0, -0.0, 0.0], -0.0)", [(2,)]),
    # an empty last row: the JAX package's np.add.reduceat fails
    ("SELECT arrayDistinct(a) FROM te", [([1, 2],), ([],)]),
])
def test_where_the_jax_package_fails(sessions, sql, want):
    """Pinned in ROADMAP section 3: the port answers, the JAX package
    raises."""
    j, p = sessions
    with pytest.raises(Exception):
        j.sql(sql)
    assert p.sql(sql).to_rows() == want


def test_element_ids_come_from_the_device_offsets(sessions):
    """A Column's host offsets get one device copy, kept and reused; the
    row ids and positions are the JAX package's np.repeat forms; an array
    a function makes carries device offsets, copied to the host once."""
    from myscaledb_tpu_torch.exec.expr import eval_expr
    from myscaledb_tpu_torch.sql.parser import Parser
    _, p = sessions
    env = Env(p.tables["t"], device="cpu")
    _, off, _ = A.as_array(env.resolve(Ident("a")), env)
    assert isinstance(off, np.ndarray)
    assert A.device_offsets(off, "cpu") is A.device_offsets(off, "cpu")
    lens = np.diff(off)
    rid = np.repeat(np.arange(N), lens)
    assert np.array_equal(A._rid(off, "cpu").numpy(), rid)
    assert np.array_equal(A._pos(off, "cpu").numpy(),
                          np.arange(off[-1]) - np.repeat(off[:-1], lens))
    q = Parser("SELECT arrayFilter(x -> x > 1, a) FROM t").parse_select()
    made = eval_expr(q.items[0].expr, env).offsets
    assert isinstance(made, DeviceOffsets)
    host = np.asarray(made)
    assert np.asarray(made) is host
    assert A.device_offsets(host, "cpu") is made.dev
    flat = p.tables["t"]["a"].data.numpy()
    keep = np.add.reduceat(np.append(flat > 1, False), off[:-1]) \
        * (lens > 0)
    assert np.array_equal(np.diff(host), keep)
