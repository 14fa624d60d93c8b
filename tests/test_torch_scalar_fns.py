"""The scalar function registry of myscaledb_tpu_torch (exec/expr.py and
exec/scalar_fns.py) against the JAX package on the CPU, in the shapes of
tests/test_scalar_fns.py and tests/test_string_fns.py: one seeded numpy
table built into both packages with ``interop.table_from_numpy``, the same
SQL through both.  Integers, ids and strings are compared exactly; f32
math within rtol 1e-5 and atol 1e-5 (torch and XLA round some
transcendental functions differently in the last places: lgamma differs
by up to 4e-6 near its roots, and tgamma = exp(lgamma) carries it on).

UInt64 results (the 64-bit hashes, toUInt64) are int64 bits in the port:
these tests print, compare, take ``%`` of and ORDER BY values above
2^63-1 and hold them to the JAX package's unsigned results, and hold the
device closed forms to the copied host specs of xxHash64, SipHash-2-4
and CityHash64.  One test asserts that the port's registry is the JAX
package's minus the functions of later slices."""

import numpy as np
import pytest
import torch

import myscaledb_tpu
import myscaledb_tpu_torch
from myscaledb_tpu.core.types import DataType as JDataType
from myscaledb_tpu_torch.core.types import DataType
from myscaledb_tpu_torch.errors import NotPortedError
from myscaledb_tpu_torch.exec.expr import EvalError
from myscaledb_tpu_torch.interop import table_from_numpy

torch.set_num_threads(1)

N = 300
WORDS = ["hello", "", "World", "a=1&b=2", "xyz", "Hello World", "gOOgle",
         "http://www.example.com:8080/p/a/t/h?x=1&y=two#frag",
         "https://clickhouse.com/docs?q=hash", '{"a": 1, "b": "x", '
         '"c": [1,2,3], "d": {"e": 2.5}}', '{"flag": true}', "1.2.3.4",
         "10.0.0.255", "not json"]


def _data(rng):
    return {
        "i": np.concatenate([[0, 1, 5, -3, 255, 1024],
                             rng.integers(-10 ** 9, 10 ** 9, N - 6)]
                            ).astype(np.int64),
        "i32": rng.integers(-2 ** 31, 2 ** 31, N).astype(np.int32),
        "u8": rng.integers(0, 256, N).astype(np.uint8),
        "u16": rng.integers(0, 2 ** 16, N).astype(np.uint16),
        "u32": rng.integers(0, 2 ** 32, N, dtype=np.uint64).astype(np.uint32),
        "f": rng.standard_normal(N).astype(np.float32) * 4,
        "f64": rng.standard_normal(N) * 100,
        "s": np.array([WORDS[k] for k in rng.integers(0, len(WORDS), N)],
                      dtype=object),
        "n": [None if k == 0 else WORDS[k % 5]
              for k in rng.integers(0, 6, N)],
        "d": rng.integers(0, 40000, N).astype(np.int32),
    }


@pytest.fixture(scope="module")
def sessions():
    data = _data(np.random.default_rng(5))
    j = myscaledb_tpu.connect()
    p = myscaledb_tpu_torch.connect(device="cpu")
    j.create_table("t", data, dtypes={"d": JDataType.DATE})
    p.register("t", table_from_numpy(data, "cpu",
                                     dtypes={"d": DataType.DATE}))
    return j, p


def _exact(rows):
    return [tuple(repr(x) for x in r) for r in rows]


# The JAX package floors intDiv and %; the port truncates toward zero, as
# ClickHouse does (ROADMAP section 3, "Faults of the reference").  For
# these statements the JAX side runs the truncating form spelled out.
JAX_FORM = {
    "SELECT intExp2(u8 % 40), intExp10(u8 % 19), gcd(i, 12), lcm(i32 % 100,"
    " 6), intDivOrZero(i, u8), moduloOrZero(i, u8), trunc(f64) FROM t":
    "SELECT intExp2(u8 % 40), intExp10(u8 % 19), gcd(i, 12), "
    "lcm(if(i32 < 0, -((-i32) % 100), i32 % 100), 6), "
    "if(i < 0, -intDivOrZero(-i, u8), intDivOrZero(i, u8)), "
    "if(i < 0, -moduloOrZero(-i, u8), moduloOrZero(i, u8)), trunc(f64) "
    "FROM t",
}


def _same(j, p, sql, rtol=None):
    jsql = JAX_FORM.get(sql, sql)
    want, got = j.sql(jsql).to_rows(), p.sql(sql).to_rows()
    if rtol is None:
        assert _exact(got) == _exact(want)
        assert p.sql_tsv(sql) == j.sql_tsv(jsql)
        return
    assert len(got) == len(want)
    for rg, rw in zip(got, want):
        for x, y in zip(rg, rw):
            if isinstance(y, float):
                np.testing.assert_allclose(x, y, rtol=rtol, atol=1e-5)
            else:
                assert x == y


EXACT = [
    # bit family
    "SELECT bitAnd(i, 3), bitOr(i, 8), bitXor(i, 5), bitNot(i), "
    "bitShiftLeft(i, 2), bitShiftRight(i, 1), bitNot(i32) FROM t",
    "SELECT bitCount(i), bitCount(i32), bitCount(u8), bitTest(i, 0), "
    "bitTestAll(i, 0, 2), bitTestAny(i, 1, 3), bitHammingDistance(i, 7) "
    "FROM t",
    "SELECT bitRotateLeft(i, 8), bitRotateRight(i, 5), "
    "bitRotateLeft(i32, 3), bitRotateRight(u8, 1) FROM t",
    # integer math and casts
    "SELECT intExp2(u8 % 40), intExp10(u8 % 19), gcd(i, 12), lcm(i32 % 100,"
    " 6), intDivOrZero(i, u8), moduloOrZero(i, u8), trunc(f64) FROM t",
    "SELECT toInt8(i), toInt16(i), toUInt8(i), toUInt16(i), toUInt32(i), "
    "toUInt64(i), toInt8(f), toUInt32(f64), toBool(u8) FROM t",
    "SELECT toTypeName(i), toTypeName(i32), toTypeName(u8), toTypeName(u16),"
    " toTypeName(u32), toTypeName(f), toTypeName(f64), toTypeName(s), "
    "toTypeName(n), toTypeName(d), toTypeName(toUInt64(i)), "
    "toTypeName(toInt16(i)), toTypeName(toUInt8(i)), toTypeName(1), "
    "toTypeName(1.5), toTypeName(xxHash32(s)) FROM t LIMIT 1",
    "SELECT identity(i), materialize(s), ignore(i, s), roundToExp2(u8), "
    "isNaN(f), isFinite(f), isInfinite(f / 0) FROM t",
    # conditionals
    "SELECT multiIf(i < 0, 'neg', i = 0, 'zero', 'pos'), "
    "multiIf(u8 > 128, i, u8 > 64, i32, 0), if(u8 > 100, s, 'low') FROM t",
    "SELECT transform(u8 % 4, [0, 1, 2], [10, 20, 30], -1), "
    "transform(s, ['hello', 'xyz'], ['H', 'X'], 'other'), "
    "transform(u8 % 3, [0, 1], ['a', 'b'], 'c') FROM t",
    # hashes: UInt64 values above 2^63-1 printed
    "SELECT cityHash64(i), sipHash64(i), xxHash64(i), intHash64(i), "
    "intHash32(i), xxHash32(i) FROM t",
    "SELECT cityHash64(i32), sipHash64(u8), xxHash64(u16), cityHash64(u32),"
    " xxHash64(f), sipHash64(f64), cityHash64(d), xxHash32(u16) FROM t",
    "SELECT cityHash64(s), sipHash64(s), xxHash64(s), xxHash32(s), "
    "halfMD5(s), MD5(s), SHA1(s), SHA256(s), halfMD5(i) FROM t",
    "SELECT cityHash64('hello'), xxHash64(1), sipHash64(1.5), halfMD5('x'),"
    " intHash64(-1), toUInt64(-3)",
    # ... compared, taken modulo, ordered, grouped
    "SELECT i, cityHash64(i) % 10, sipHash64(s) % 1000003, "
    "intDiv(xxHash64(i), 7), cityHash64(i) > 9223372036854775807, "
    "xxHash64(i) <= 4611686018427387904, intHash64(i) = intHash64(i), "
    "cityHash64(i) < i FROM t",
    "SELECT i, cityHash64(i) AS h FROM t ORDER BY h LIMIT 50",
    "SELECT sipHash64(s) AS h FROM t ORDER BY h DESC LIMIT 10",
    "SELECT i FROM t WHERE xxHash64(i) > 9000000000000000000 ORDER BY i",
    "SELECT cityHash64(s) AS h, count() FROM t GROUP BY h ORDER BY h",
    "SELECT cityHash64(i) + 1, xxHash64(i) * 3, toUInt64(-3) - 1, "
    "-toUInt64(5), bitXor(cityHash64(i), 1), bitShiftRight(xxHash64(i), 60)"
    " FROM t",
    "SELECT toString(cityHash64(i)), concat('h=', toString(xxHash64(s))), "
    "hex(intHash64(i)), toUInt8(cityHash64(i)) FROM t",
    # encoding
    "SELECT hex(s), unhex(hex(s)), hex(i), hex(i32), hex(u8), hex(f), "
    "bin(i32), bin(u8), base64Encode(s), base64Decode(base64Encode(s)) "
    "FROM t",
    "SELECT hex(255), bin(5), hex('abc'), unbin('0110000101100010'), "
    "char(104, 105), space(3)",
    # strings on the dictionary
    "SELECT lower(s), upper(s), lowerUTF8(s), upperUTF8(s), trim(concat(' ',"
    " s, ' ')), reverse(s), length(s), empty(s) FROM t",
    "SELECT substring(s, 2, 3), substr(s, 4), left(s, 3), right(s, 2), "
    "leftPad(s, 10, '.'), rightPad(s, 8), lpad(s, 3), repeat(s, 2) FROM t",
    "SELECT concat(s, ' ', n), concat(s, '#', i32), concat('a', 'b'), "
    "concatWithSeparator('-', s, n, 'z'), toString(i), toString(f), "
    "toString(u8), toString(d), toString(42) FROM t",
    "SELECT s LIKE '%o%', s NOT LIKE 'h%', s ILIKE '%WORLD%', "
    "notILike(s, 'x%'), like(s, 'a\\\\_%'), startsWith(s, 'h'), "
    "endsWith(s, 'd'), position(s, 'o'), positionCaseInsensitive(s, 'O'), "
    "match(s, '^[a-z]+$'), countSubstrings(s, 'l'), hasToken(s, 'World') "
    "FROM t",
    "SELECT replaceAll(s, 'o', '0'), replaceOne(s, 'l', 'L'), "
    "replace(s, 'e', 'E'), replaceRegexpAll(s, '[aeiou]', '*'), "
    "replaceRegexpAll(s, '(l+)', '<\\\\1>'), extract(s, '[aeiou]+'), "
    "extract(s, '(\\\\w)(\\\\w)') FROM t",
    "SELECT substringIndex(s, '.', 2), substringIndex(s, '/', 1), "
    "ascii(s), multiSearchAny(s, ['oo', 'xy']), "
    "multiSearchFirstIndex(s, ['l', 'o']) FROM t",
    "SELECT splitByChar('=', s), splitByString('/', s), "
    "arrayStringConcat(splitByChar('/', s), '|'), "
    "length(splitByChar('.', s)), empty(splitByChar('x', s)) FROM t",
    "SELECT nullIf(s, 'hello'), nullIf(i32, 0), isNull(n), isNotNull(n), "
    "coalesce(nullIf(i32, 0), i), ifNull(nullIf(u8, 7), 99) FROM t",
    "SELECT concat(s, 'x') AS k, count() FROM t GROUP BY k ORDER BY k",
    "SELECT i FROM t WHERE s LIKE '%ll%' AND NOT empty(s) ORDER BY i",
    # JSON, URL, IPv4
    "SELECT JSONHas(s, 'a'), JSONLength(s), JSONLength(s, 'c'), "
    "JSONType(s, 'c'), JSONExtractString(s, 'b'), JSONExtractInt(s, 'a'), "
    "JSONExtractFloat(s, 'd', 'e'), JSONExtractBool(s, 'flag'), "
    "JSONExtractRaw(s, 'c'), JSONExtractInt(s, 'c', -1), "
    "JSONExtractKeys(s), isValidJSON(s) FROM t",
    "SELECT protocol(s), domain(s), domainWithoutWWW(s), topLevelDomain(s),"
    " path(s), pathFull(s), queryString(s), fragment(s), "
    "queryStringAndFragment(s), cutQueryString(s), cutFragment(s), "
    "cutQueryStringAndFragment(s), cutWWW(s), extractURLParameter(s, 'y'),"
    " firstSignificantSubdomain(s), decodeURLComponent(s), "
    "encodeURLComponent(s) FROM t",
    "SELECT toIPv4(s), IPv4StringToNum(s), IPv4NumToString(u32), "
    "IPv4NumToString(toIPv4(s)), toIPv4('192.168.0.1'), "
    "toTypeName(toIPv4(s)) FROM t",
    "SELECT currentDatabase(), currentUser(), version()",
]


@pytest.mark.parametrize("sql", EXACT)
def test_statement_matches(sessions, sql):
    j, p = sessions
    _same(j, p, sql)


@pytest.mark.parametrize("sql", [
    "SELECT sin(f), cos(f), tan(f), asin(f / 8), acos(f / 8), atan(f), "
    "sinh(f), cosh(f), tanh(f), exp2(f), log2(abs(f)), log10(abs(f)), "
    "cbrt(f), sign(f), sign(i), sqr(f), pi(), e() FROM t",
    "SELECT atan2(f, 2), hypot(f, 3), log1p(abs(f)), expm1(f), degrees(f), "
    "radians(f), asinh(f), acosh(abs(f) + 1), atanh(f / 8), erf(f), "
    "erfc(f), lgamma(abs(f) + 0.5), tgamma(abs(f) + 0.5), exp10(f / 4), "
    "max2(f, 0.5), min2(f, i32), roundBankers(f64, 1), "
    "roundDown(f, [-1, 0, 1.5, 3]) FROM t",
])
def test_float_math_matches(sessions, sql):
    j, p = sessions
    _same(j, p, sql, rtol=1e-5)


def test_coalesce_of_strings_keeps_each_dictionary(sessions):
    """coalesce/ifNull of two String columns, or of a column and a
    literal, re-encodes both into one dictionary.  The JAX package takes
    the second column's ids into the first's dictionary (IndexError or a
    wrong string) and refuses the literal (ROADMAP section 3)."""
    j, p = sessions
    n = p.tables["t"]["n"].to_python()
    s = p.tables["t"]["s"].to_python()
    got = p.sql("SELECT coalesce(n, s), ifNull(n, 'none'), "
                "coalesce(n, n, s) FROM t").to_rows()
    assert got == [(a if a is not None else b,
                    a if a is not None else "none",
                    a if a is not None else b) for a, b in zip(n, s)]
    with pytest.raises(IndexError):
        j.sql("SELECT coalesce(n, s) FROM t").to_rows()


def test_round_to_exp2_is_an_exact_power_of_two(sessions):
    """roundToExp2 of an integer is 2^floor(log2 x), as in ClickHouse.  The
    JAX package's f32 exp2 is off by a few ulp past 2^24 (610005847 gives
    536871168, not 2^29: ROADMAP section 3); the port's is exact."""
    j, p = sessions
    xs = p.tables["t"]["i"].to_numpy()
    got = [r[0] for r in p.sql("SELECT roundToExp2(i) FROM t").to_rows()]
    f32 = xs.astype(np.float32).astype(np.float64)
    want = [0 if x < 1 else 2 ** int(np.floor(np.log2(x))) for x in f32]
    assert got == want
    assert j.sql("SELECT roundToExp2(610005847)").to_rows() == [(536871168,)]
    assert p.sql("SELECT roundToExp2(610005847)").to_rows() == [(2 ** 29,)]


def test_uint64_hash_ordering_is_unsigned(sessions):
    """ORDER BY a hash puts the values past 2^63-1 after the others, as
    the JAX package's uint64 does; the printed values are unsigned."""
    _, p = sessions
    vals = [r[0] for r in p.sql("SELECT cityHash64(i) AS h FROM t "
                                "ORDER BY h").to_rows()]
    assert vals == sorted(vals) and vals[-1] > 2 ** 63
    assert p.sql("SELECT cityHash64(i) FROM t").schema()[0].dtype is \
        DataType.UINT64


def test_uint64_hashes_through_a_subquery_and_insert_select():
    """A hash carried into a column (INSERT ... SELECT, a FROM subquery)
    keeps its unsigned reading: arithmetic, comparison, modulo and order
    as in the JAX package."""
    j = myscaledb_tpu.connect()
    p = myscaledb_tpu_torch.connect(device="cpu")
    for s in (j, p):
        s.sql("CREATE TABLE h (x UInt64) ENGINE = MergeTree ORDER BY x")
        s.sql("INSERT INTO h SELECT cityHash64(number) FROM numbers(20)")
    for sql in ("SELECT x, x + 1, x > 5, x % 7 FROM h ORDER BY x",
                "SELECT y * 3, y < 9223372036854775807 FROM (SELECT "
                "sipHash64(number) AS y FROM numbers(20)) ORDER BY y DESC"):
        assert p.sql_tsv(sql) == j.sql_tsv(sql)


def test_device_closed_forms_match_the_host_specs(sessions):
    from myscaledb_tpu_torch.exec.scalar_fns import (
        _xxh64_bytes, _siphash24_bytes, _cityhash64_bytes)
    _, p = sessions
    vals = p.tables["t"]["i"].to_numpy()
    f = p.tables["t"]["f"].to_numpy()
    i32 = p.tables["t"]["i32"].to_numpy()
    for fn, host in (("xxHash64", _xxh64_bytes),
                     ("sipHash64", _siphash24_bytes),
                     ("cityHash64", _cityhash64_bytes)):
        got = [r[0] for r in p.sql(f"SELECT {fn}(i) FROM t").to_rows()]
        assert got == [host(int(v).to_bytes(8, "little", signed=True))
                       for v in vals]
        got = [r[0] for r in p.sql(f"SELECT {fn}(f) FROM t").to_rows()]
        assert got == [host(v.tobytes()) for v in f]
        got = [r[0] for r in p.sql(f"SELECT {fn}(i32) FROM t").to_rows()]
        if fn != "cityHash64":       # its closed form covers 4 and 8 bytes
            assert got == [host(v.tobytes()) for v in i32]


def test_host_specs_are_the_jax_packages():
    from myscaledb_tpu.exec import scalar_fns as js
    from myscaledb_tpu_torch.exec import scalar_fns as ps
    msgs = [bytes(range(256))[:k] for k in (0, 1, 3, 4, 8, 9, 16, 17, 32,
                                            33, 64, 65, 200)]
    for name in ("_xxh64_bytes", "_xxh32_bytes", "_siphash24_bytes",
                 "_cityhash64_bytes"):
        assert [getattr(ps, name)(m) for m in msgs] == \
            [getattr(js, name)(m) for m in msgs]
    assert ps._xxh64_bytes(b"") == 0xEF46DB3751D8E999


def test_uint64_arithmetic_that_would_change_the_number_raises(sessions):
    """Where the port cannot give the JAX package's unsigned result it
    raises (ROADMAP section 3): '/' of a hash, '%' by a non-literal, and
    sum/min/max/avg or a quantile over one."""
    _, p = sessions
    for sql in ("SELECT cityHash64(i) / 2 FROM t",
                "SELECT cityHash64(i) % i FROM t",
                "SELECT cityHash64(i) % 0 FROM t"):
        with pytest.raises(EvalError, match="UInt64"):
            p.sql(sql)
    for sql in ("SELECT sum(cityHash64(i)) FROM t",
                "SELECT max(xxHash64(s)) FROM t",
                "SELECT quantile(0.5)(intHash64(i)) FROM t"):
        with pytest.raises(myscaledb_tpu_torch.ExecError, match="UInt64"):
            p.sql(sql)


def test_registry_is_the_jax_packages_minus_later_slices():
    """Since the breadth slice no later slice holds a function back: the
    dictGet family, joinGet* and finalizeAggregation are registered."""
    from myscaledb_tpu.exec.expr import _FUNCS as jax_funcs
    from myscaledb_tpu_torch.exec.expr import _FUNCS
    assert set(_FUNCS) == set(jax_funcs)


@pytest.mark.parametrize("sql,slice_name", [
    ("SELECT finalizeAggregation(i) FROM t",
     "expression and function breadth"),
    ("SELECT dictGet('d', 'v', i) FROM t",
     "storage, formats and runtime state"),
])
def test_later_functions_name_their_slice(sessions, sql, slice_name):
    """The functions once held for a later slice (``slice_name``) now fail
    over these arguments as the JAX package's do: no state column, no
    dictionary."""
    j, p = sessions
    with pytest.raises(Exception) as want:
        j.sql(sql)
    with pytest.raises(Exception) as got:
        p.sql(sql)
    assert not isinstance(got.value, NotPortedError)
    assert str(got.value) == str(want.value)


def test_unknown_function_errors_as_in_the_jax_package(sessions):
    j, p = sessions
    sql = "SELECT noSuchFunction(i) FROM t"
    with pytest.raises(Exception) as je:
        j.sql(sql)
    with pytest.raises(Exception) as pe:
        p.sql(sql)
    assert str(pe.value) == str(je.value)
