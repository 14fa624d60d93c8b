"""File formats on the CPU: myscaledb_tpu_torch/runtime/formats.py against
myscaledb_tpu/runtime/formats.py.

After tests/test_formats_cache.py and test_formats_extended.py: every
output format writes the JAX package's bytes for the same table, every
input format reads what either package writes with equal rows, INSERT ...
FORMAT / FROM INFILE / INTO OUTFILE and ``Session.import_file`` /
``export_file`` give the JAX package's rows.  Pinned here: the two
readers the port repairs (Float64 read exactly; JSONEachRow reading its
own Date/DateTime strings) and the text bytes both packages write where
ClickHouse writes others (ROADMAP section 3)."""

import csv
import io
import math

import numpy as np
import pytest

import myscaledb_tpu
import myscaledb_tpu_torch
from myscaledb_tpu.core.table import Table as JTable
from myscaledb_tpu.core.types import DataType as JDT
from myscaledb_tpu.runtime import formats as jf
from myscaledb_tpu_torch.core.table import Table as PTable
from myscaledb_tpu_torch.core.types import DataType as PDT
from myscaledb_tpu_torch.runtime import formats as pf

STRINGS = ["plain", "comma,here", 'quo"te', "tab\there", "new\nline",
           "cr\rhere", "", "ünïcödé ✓", "back\\slash", "=eq", None]


def _data(n=11, f32_prices=False):
    """The sample columns; with ``f32_prices`` the Float64 column holds
    values a Float32 keeps, so the JAX package's text readers (which
    parse Float64 through Float32) read them back exactly."""
    rng = np.random.default_rng(5)
    price = np.array([0.1, 123456789.123456789, 1e20, -2.5e-7, 0.0, -0.0,
                      1e16, 3.0, 1e-4, 5e-324, 2.5][:n])
    if f32_prices:
        price = price.astype(np.float32).astype(np.float64)
    return {
        "id": np.arange(n, dtype=np.int64),
        "u8": rng.integers(0, 255, n).astype(np.uint8),
        "u16": rng.integers(0, 65535, n).astype(np.uint16),
        "u32": rng.integers(0, 2 ** 32 - 1, n).astype(np.uint32),
        "i16": rng.integers(-3000, 3000, n).astype(np.int16),
        "price": price,
        "f": rng.standard_normal(n).astype(np.float32),
        "tag": [STRINGS[i % len(STRINGS)] for i in range(n)],
        "flag": np.arange(n) % 3 == 0,
        "day": (np.array(["2024-01-01", "2024-02-29", "1999-12-31",
                          "1970-01-01", "2038-01-19"] * 3,
                         dtype="datetime64[D]"))[:n],
        "ts": (np.datetime64("2013-07-01T00:00:00") +
               rng.integers(0, 31 * 86400, n).astype("timedelta64[s]")),
        "vec": rng.standard_normal((n, 3)).astype(np.float32),
        "arr": [list(range(i % 4)) for i in range(n)],
    }


def _pair(data, drop=()):
    data = {k: v for k, v in data.items() if k not in drop}
    return (JTable.from_dict(data, name="sample"),
            PTable.from_dict(data, name="sample", device="cpu"))


def _schema(table, enum=None):
    """The table's own Fields (the readers of formats_extra take Fields,
    as ``Session.import_file`` passes them)."""
    return table.schema()


def _norm(rows):
    """Rows with floats by repr (NaN equal to NaN), arrays as lists."""
    def one(v):
        if isinstance(v, float) and math.isnan(v):
            return "nan"
        if isinstance(v, np.ndarray):
            return [one(x) for x in v.tolist()]
        if isinstance(v, list):
            return [one(x) for x in v]
        return v
    return [tuple(one(v) for v in r) for r in rows]


# columns the JAX package cannot write or read back in some formats:
# Avro's writer takes a date for a long, ORC has no unsigned types, the
# JSON-based readers fail on their own date strings (JSONEachRow's is the
# port's repair, pinned below), TSKV and CustomSeparated split a line at
# a raw \r, and CustomSeparated's reader takes True for a float
DROP = {"AVRO": ("day", "ts"), "ORC": ("u8", "u16", "u32"),
        "JSONEACHROW": ("day", "ts"), "MSGPACK": ("day", "ts"),
        "JSONCOMPACTEACHROW": ("day", "ts"), "JSONCOLUMNS": ("day", "ts"),
        "TSKV": ("tag",), "CUSTOMSEPARATED": ("flag", "tag")}
NEEDS = {"PARQUET": "pyarrow", "ARROW": "pyarrow", "ARROWSTREAM": "pyarrow",
         "ORC": "pyarrow", "MSGPACK": "msgpack"}


def _needs(fmt):
    mod = NEEDS.get(pf.normalize_format(fmt))
    if mod:
        pytest.importorskip(mod)


def test_the_registries_are_the_jax_packages():
    assert pf.INPUT_FORMATS == jf.INPUT_FORMATS
    assert pf.OUTPUT_FORMATS == jf.OUTPUT_FORMATS


@pytest.mark.parametrize("fmt", jf.OUTPUT_FORMATS)
def test_same_table_same_bytes(fmt, tmp_path):
    """For the same table both packages write the same bytes (or fail
    alike: CSVWithNames is listed but has no writer in either)."""
    _needs(fmt)
    jt, pt = _pair(_data(), DROP.get(pf.normalize_format(fmt), ()))
    out = []
    for write, t, name in ((jf.write_file, jt, "j"), (pf.write_file, pt, "p")):
        try:
            write(t, str(tmp_path / name), fmt)
            out.append((tmp_path / name).read_bytes())
        except ValueError as e:
            out.append(str(e))
    assert out[0] == out[1]


ROUND_TRIP = [f for f in jf.INPUT_FORMATS
              if f not in ("LineAsString", "Regexp")]


@pytest.mark.parametrize("fmt", ROUND_TRIP)
def test_files_read_across_packages(fmt, tmp_path):
    """A file either package writes reads in both with equal rows."""
    _needs(fmt)
    jt, pt = _pair(_data(f32_prices=True), DROP.get(pf.normalize_format(fmt), ()))
    # CSVWithNames has no writer in either package: CSV writes its header
    wfmt = "CSV" if fmt == "CSVWithNames" else fmt
    jf.write_file(jt, str(tmp_path / "j"), wfmt)
    pf.write_file(pt, str(tmp_path / "p"), wfmt)
    js, ps = _schema(jt, JDT), _schema(pt, PDT)
    got = []
    for src in ("j", "p"):
        path = str(tmp_path / src)
        for read in (lambda: jf.read_file(path, fmt, js),
                     lambda: pf.read_file(path, fmt, ps, device="cpu")):
            try:
                got.append(_norm(read().to_rows()))
            except Exception as e:      # Values: a raw newline in a string
                got.append((type(e).__name__, str(e)))
    assert all(g == got[0] for g in got)
    assert fmt == "Values" or len(got[0]) == jt.n_rows


def test_writers_assemble_in_chunks(tmp_path, monkeypatch):
    """Rows assembled a chunk at a time give the one-chunk bytes."""
    monkeypatch.setattr(pf, "WRITE_CHUNK_ROWS", 3)
    jt, pt = _pair(_data(), ("day", "ts"))
    for fmt in ("CSV", "JSONEachRow", "RowBinary"):
        jf.write_file(jt, str(tmp_path / "j"), fmt)
        pf.write_file(pt, str(tmp_path / "p"), fmt)
        assert (tmp_path / "p").read_bytes() == \
            (tmp_path / "j").read_bytes(), fmt


@pytest.mark.parametrize("values", [
    [""], ["", "x"], ["a,b", '"'], ["\r"], [None, ""]])
def test_one_column_csv_quotes_as_csv_writer(values, tmp_path):
    """csv.writer's rules hold column at a time, the lone-empty-field
    rule of a one-column row included."""
    jt, pt = _pair({"s": values})
    jf.write_file(jt, str(tmp_path / "j"), "CSV")
    pf.write_file(pt, str(tmp_path / "p"), "CSV")
    assert (tmp_path / "p").read_bytes() == (tmp_path / "j").read_bytes()
    sio = io.StringIO(newline="")
    w = csv.writer(sio)
    w.writerow(["s"])
    for v in values:
        w.writerow(["" if v is None else v])
    assert (tmp_path / "p").read_bytes() == sio.getvalue().encode()


def test_float64_is_read_exactly(tmp_path):
    """Satellite repair (ROADMAP section 3): a Float64 column reads its
    text exactly.  The JAX package parses it through its Float32 parser
    (myscaledb_tpu/runtime/formats.py:69-73), so 0.1 comes back as
    0.10000000149011612."""
    path = tmp_path / "x.csv"
    path.write_text("1,0.1\n2,123456789.123456789\n")
    schema_p = [("id", PDT.INT64), ("x", PDT.FLOAT64)]
    schema_j = [("id", JDT.INT64), ("x", JDT.FLOAT64)]
    got = [r[1] for r in pf.read_file(str(path), "CSV", schema_p,
                                      device="cpu").to_rows()]
    assert got == [0.1, 123456789.123456789]
    jax_got = [r[1] for r in jf.read_file(str(path), "CSV", schema_j)
               .to_rows()]
    assert jax_got == [0.10000000149011612, 123456792.0]
    # the TSV reader and the text formats of formats_extra take it too
    path.write_text("1\t0.1\n")
    assert pf.read_file(str(path), "TSV", schema_p,
                        device="cpu").to_rows() == [(1, 0.1)]
    from myscaledb_tpu_torch.core.types import Field
    path.write_text("id=1\tx=0.1\n")
    assert pf.read_file(str(path), "TSKV", [Field(*f) for f in schema_p],
                        device="cpu").to_rows() == [(1, 0.1)]


def test_jsoneachrow_reads_its_own_dates(tmp_path):
    """Port repair (ROADMAP section 3): JSONEachRow writes Date/DateTime
    as strings and the port reads them back; the JAX reader fails on
    them (np.asarray(strings).astype(int32))."""
    jt, pt = _pair({"d": np.array(["2024-02-29", "1970-01-02"],
                                  dtype="datetime64[D]"),
                    "t": np.array(["2013-07-01T10:11:12",
                                   "1999-12-31T23:59:59"],
                                  dtype="datetime64[s]")})
    path = str(tmp_path / "d.json")
    pf.write_file(pt, path, "JSONEachRow")
    back = pf.read_file(path, "JSONEachRow", _schema(pt, PDT), device="cpu")
    assert back.to_rows() == pt.to_rows()
    with pytest.raises(ValueError):
        jf.read_file(path, "JSONEachRow", _schema(jt, JDT))


def test_text_bytes_that_differ_from_clickhouse(tmp_path):
    """Kept as the JAX package writes them (ROADMAP section 3): TSV is
    Python's csv module with a tab, so a field with a quote is quoted
    and doubled, lines end in \\r\\n and NULL is an empty field; Bool is
    True/False; a Float32 prints as the repr of its Float64 widening."""
    _, pt = _pair({"s": ['q"x', "t"], "b": np.array([True, False]),
                   "f": np.array([0.1, 1.5], dtype=np.float32),
                   "n": [None, 3]})
    path = str(tmp_path / "t.tsv")
    pf.write_file(pt, path, "TSV")
    assert open(path, "rb").read() == \
        b'"q""x"\tTrue\t0.10000000149011612\t\r\nt\tFalse\t1.5\t3\r\n'


CSV_CASES = [
    ('1,"a\nb"\n2,c\n', "id Int64, s String"),
    ("1,x\r2,y\r\n3,z", "id Int64, s String"),
    ('1,"x""y"z\n', "id Int64, s String"),
    ("id,s\n1,x\n", "id Int64, s String"),
    ("id,s\nInt64,String\n1,x\n", "id Int64, s String"),
    ("1,x\n\n2,y\n", "id Int64, s String"),
    ("1,x,extra\n2,y,more\n", "id Int64, s String"),
    ("1\n", "id Int64, s String"),
    ("1,2020-01-02 03:04:05,2020-01-02\n",
     "id Int64, t DateTime, d Date"),
    ("1,2020-01-02T03:04:05,2020-1-2\n", "id Int64, t DateTime, d Date"),
    ("1,+7,-3\n", "id Int64, a Int32, b Int16"),
    ("1, 7\n", "id Int64, a Int32"),
    ("1,1e3,nan\n", "id Int64, a Float32, b Float64"),
    ("1,true\n2,0\n3,TRUE\n", "id Int64, b Bool"),
    ('1,"[1.0, 2.5]"\n', "id Int64, v Array(Float32)"),
    ("", "id Int64"),
]


@pytest.mark.parametrize("text,schema", CSV_CASES)
def test_csv_reader_matches_the_jax_package(text, schema, tmp_path):
    """The native CSV split and typed parsers give the rows (or the error)
    of the JAX package's csv.reader path."""
    from myscaledb_tpu.sql.ddl import parse_schema_string as jps
    from myscaledb_tpu_torch.sql.ddl import parse_schema_string as pps
    path = tmp_path / "in.csv"
    path.write_bytes(text.encode())
    out = []
    for read, defs in ((lambda p, s: jf.read_file(p, "CSV", s), jps),
                       (lambda p, s: pf.read_file(p, "CSV", s,
                                                  device="cpu"), pps)):
        schema_l = [(d.name, d.dtype) for d in defs(schema)]
        try:
            out.append(_norm(read(str(path), schema_l).to_rows()))
        except Exception as e:
            out.append((type(e).__name__, str(e)))
    assert out[0] == out[1]


JSON_CASES = [
    '{"id": 1, "s": "x\\u00e9\\ud83d\\ude00"}\n{"s": "y", "id": 2}\n',
    '{"id": 1}\n\n   \n{"id": 2, "s": null}\n',
    '{"id": 1, "s": "a", "extra": {"k": [1, 2]}}\n',
    '{"id": 1.5, "s": "a"}\n{"id": 2, "s": 3}\n',
    '{"id": 1, "s": "\\ud800"}\n',
    '[1, "a"]\n',
    '{"id": 1, "id": 2, "s": "dup"}\r\n',
    '{"id": true, "s": "b"}\n',
]


@pytest.mark.parametrize("text", JSON_CASES)
def test_jsoneachrow_reader_matches_the_jax_package(text, tmp_path):
    """The native JSONEachRow scanner, or Python's json where a line is
    beyond it, gives the JAX package's rows or error."""
    path = tmp_path / "in.json"
    path.write_bytes(text.encode())
    out = []
    for read, dt in ((lambda p, s: jf.read_file(p, "JSONEachRow", s), JDT),
                     (lambda p, s: pf.read_file(p, "JSONEachRow", s,
                                                device="cpu"), PDT)):
        try:
            out.append(_norm(read(str(path), [("id", dt.INT64),
                                              ("s", dt.STRING)]).to_rows()))
        except Exception as e:
            out.append((type(e).__name__, str(e)))
    assert out[0] == out[1]


def _sessions():
    return (myscaledb_tpu.connect(),
            myscaledb_tpu_torch.connect(device="cpu"))


DDL = ("CREATE TABLE t (id UInt32, name String, price Float64, "
       "d Date) ENGINE = MergeTree ORDER BY id")
INLINE = [
    "INSERT INTO t FORMAT CSV\n1,\"a,b\",0.5,2020-01-01\n2,c,1.25,2021-06-30",
    "INSERT INTO t FORMAT TSV 1\tx\t2.5\t2020-01-01\n",
    "INSERT INTO t (id, name) FORMAT CSV 7,seven\n",
    'INSERT INTO t FORMAT JSONEachRow {"id": 3, "name": "j", '
    '"price": 0.1, "d": 18000}\n{"id": 4, "name": "k", "price": 2, '
    '"d": 18001}',
    "INSERT INTO t FORMAT Values (5, 'v', 1.5, '2022-02-02')",
    "INSERT INTO t FORMAT TSKV id=6\tname=tk\tprice=3\td=2020-01-01\n",
    "INSERT INTO t FORMAT CSV",
]


@pytest.mark.parametrize("sql", INLINE)
def test_inline_insert_formats(sql):
    """INSERT ... FORMAT fmt <rows> parses the data tail through the file
    readers, as the JAX package does."""
    out = []
    for s in _sessions():
        s.sql(DDL)
        try:
            s.sql(sql)
            err = None
        except Exception as e:      # TSKV: its reader takes Fields
            err = (type(e).__name__, str(e))
        out.append((err, s.sql_tsv("SELECT * FROM t ORDER BY id")))
    assert out[0] == out[1]


@pytest.mark.parametrize("fmt", ["CSV", "TSVWithNames", "JSONEachRow",
                                 "RowBinary", "Native", "Values"])
def test_outfile_then_infile(fmt, tmp_path):
    """SELECT ... INTO OUTFILE writes the JAX package's bytes; INSERT ...
    FROM INFILE reads them back into both."""
    out = []
    # prices a Float32 keeps (the JAX text readers go through Float32),
    # no Date for JSONEachRow (its JAX reader fails on one)
    ddl = DDL.replace(", d Date", "") if fmt == "JSONEachRow" else DDL
    day = lambda d: "" if fmt == "JSONEachRow" else f", '{d}'"
    for tag, s in zip("jp", _sessions()):
        s.sql(ddl)
        s.sql(f"INSERT INTO t VALUES (1, 'a\tb', 0.5{day('2020-01-01')}), "
              f"(2, '', 2.25{day('1999-12-31')})")
        path = tmp_path / f"{tag}.out"
        rows = s.sql(f"SELECT * FROM t ORDER BY id INTO OUTFILE '{path}' "
                     f"FORMAT {fmt}").to_rows()
        s.sql(ddl.replace("TABLE t", "TABLE r"))
        s.sql(f"INSERT INTO r FROM INFILE '{path}' FORMAT {fmt}")
        out.append((rows, path.read_bytes(),
                    s.sql_tsv("SELECT * FROM r ORDER BY id")))
    assert out[0] == out[1]


def test_session_import_and_export_file(tmp_path):
    """Session.export_file / import_file (with the CSV keywords; both
    packages refuse ``delimiter=``, which read_csv gets twice)."""
    out = []
    for tag, s in zip("jp", _sessions()):
        s.sql(DDL)
        s.sql("INSERT INTO t VALUES (1, 'x', 0.5, '2020-01-01')")
        path = str(tmp_path / f"{tag}.csv")
        n = s.export_file("SELECT * FROM t", path, "CSV")
        s.import_file("t", path, "CSV", has_header=True)
        tsv = tmp_path / f"{tag}.tsv"
        tsv.write_text("9\tnine\t9.5\t2020-09-09\n")
        s.import_file("t", str(tsv), "TSV", has_header=False)
        with pytest.raises(TypeError) as e:
            s.import_file("t", str(tsv), "CSV", delimiter=";")
        out.append((n, open(path, "rb").read(), str(e.value).split(".")[-1],
                    s.sql_tsv("SELECT * FROM t ORDER BY id, name")))
    assert out[0] == out[1]


PART_DDL = ("CREATE TABLE ev (day Date, id UInt32, s String, "
            "INDEX bs s TYPE bloom_filter GRANULARITY 1) ENGINE = MergeTree "
            "PARTITION BY day ORDER BY id TTL day + INTERVAL 100000 DAY")


def test_infile_takes_the_insert_values_path(tmp_path):
    """INSERT FROM INFILE, INSERT ... FORMAT and import_file into a table
    with PARTITION BY, a skip index, a TTL and a materialized view do
    what INSERT VALUES of the same rows does (in the port itself): rows in
    the same clustered order, one part each, the view fed once."""
    rows = [("2024-01-03", 3, "c"), ("2024-01-01", 1, "a"),
            ("2024-01-03", 4, "d"), ("2024-01-02", 2, "b")]
    csv_path = tmp_path / "rows.csv"
    csv_path.write_text("".join(f"{d},{i},{s}\n" for d, i, s in rows))
    values = ", ".join(f"('{d}', {i}, '{s}')" for d, i, s in rows)
    out = []
    for how in ("values", "infile", "inline", "import"):
        s = myscaledb_tpu_torch.connect(device="cpu")
        s.sql(PART_DDL)
        s.sql("CREATE TABLE per_day (day Date, n UInt64) ENGINE = Memory")
        s.sql("CREATE MATERIALIZED VIEW mv TO per_day AS SELECT day, "
              "count() AS n FROM ev GROUP BY day")
        if how == "values":
            s.sql(f"INSERT INTO ev VALUES {values}")
        elif how == "infile":
            s.sql(f"INSERT INTO ev FROM INFILE '{csv_path}' FORMAT CSV")
        elif how == "inline":
            s.sql("INSERT INTO ev FORMAT CSV " + csv_path.read_text())
        else:
            s.import_file("ev", str(csv_path), "CSV")
        out.append((s.sql("SELECT * FROM ev").to_rows(),
                    s.sql_tsv("SELECT * FROM per_day ORDER BY day"),
                    s.sql_tsv("SELECT table, rows FROM system.parts"),
                    s.sql_tsv("SELECT count() FROM ev WHERE s = 'd'")))
    assert all(o == out[0] for o in out)
    assert [r[1] for r in out[0][0]] == [1, 2, 3, 4]
