"""The extra formats on the CPU: myscaledb_tpu_torch/runtime/formats_extra.py
against myscaledb_tpu/runtime/formats_extra.py, after
tests/test_formats_extra.py: MsgPack, Avro, JSONCompactEachRow, TSKV,
JSONColumns and LineAsString round trips, the output-only renderers,
Template, CustomSeparated and Regexp through SQL in both packages.
Pinned: the CustomSeparatedWithNames names row the port writes and skips
(ROADMAP section 3)."""

import numpy as np
import pytest

import myscaledb_tpu
import myscaledb_tpu_torch
from myscaledb_tpu.core.types import DataType as JDT, Field as JField
from myscaledb_tpu.runtime import formats as jf
from myscaledb_tpu_torch.core.types import DataType as PDT, Field as PField
from myscaledb_tpu_torch.runtime import formats as pf

DATA = {"id": np.arange(5, dtype=np.int64),
        "name": np.array(["a", "b\tc", "d", "", "é=x"], dtype=object),
        "v": np.array([1.5, -2.25, 0.0, 3.0, 4.5], dtype=np.float64)}


def _sessions():
    out = []
    for s in (myscaledb_tpu.connect(),
              myscaledb_tpu_torch.connect(device="cpu")):
        s.create_table("t", DATA)
        out.append(s)
    return out


def _schema(F, DT):
    return [F("id", DT.INT64), F("name", DT.STRING), F("v", DT.FLOAT64)]


@pytest.mark.parametrize("fmt", ["MsgPack", "Avro", "JSONCompactEachRow",
                                 "TSKV", "JSONColumns"])
def test_roundtrip_across_packages(fmt, tmp_path):
    """Same bytes from both writers; each reads both files to the table's
    rows."""
    if fmt == "MsgPack":
        pytest.importorskip("msgpack")
    j, p = _sessions()
    jf.write_file(j.tables["t"], str(tmp_path / "j"), fmt)
    pf.write_file(p.tables["t"], str(tmp_path / "p"), fmt)
    assert (tmp_path / "p").read_bytes() == (tmp_path / "j").read_bytes()
    want = p.tables["t"].to_rows()
    for src in ("j", "p"):
        path = str(tmp_path / src)
        assert jf.read_file(path, fmt, _schema(JField, JDT)).to_rows() == \
            want
        assert pf.read_file(path, fmt, _schema(PField, PDT),
                            device="cpu").to_rows() == want


def test_lineasstring(tmp_path):
    path = tmp_path / "lines.txt"
    path.write_text("hello\nworld with spaces\n\nlast\n")
    want = jf.read_file(str(path), "LineAsString",
                        [JField("line", JDT.STRING)]).to_rows()
    got = pf.read_file(str(path), "LineAsString",
                       [PField("line", PDT.STRING)], device="cpu").to_rows()
    assert got == want == [("hello",), ("world with spaces",), ("",),
                           ("last",)]


@pytest.mark.parametrize("fmt", ["Vertical", "Markdown", "SQLInsert",
                                 "JSON", "JSONCompact", "Pretty",
                                 "PrettyCompact"])
def test_output_only_renderers(fmt, tmp_path):
    j, p = _sessions()
    for tag, s in (("j", j), ("p", p)):
        s.sql(f"SELECT * FROM t ORDER BY id INTO OUTFILE "
              f"'{tmp_path / tag}' FORMAT {fmt}")
    assert (tmp_path / "p").read_bytes() == (tmp_path / "j").read_bytes()


def test_avro_nullable(tmp_path):
    out = []
    for tag, s, F, DT, fm in (("j", myscaledb_tpu.connect(), JField, JDT,
                               jf),
                              ("p", myscaledb_tpu_torch.connect(
                                  device="cpu"), PField, PDT, pf)):
        s.sql("CREATE TABLE n (id Int64, x Nullable(Int64)) ENGINE = Memory")
        s.sql("INSERT INTO n VALUES (1, 5), (2, NULL), (3, 7)")
        path = str(tmp_path / f"{tag}.avro")
        fm.write_file(s.tables["n"].select(["id", "x"]), path, "Avro")
        kw = {"device": "cpu"} if tag == "p" else {}
        back = fm.read_file(path, "Avro", [F("id", DT.INT64),
                                           F("x", DT.INT64, nullable=True)],
                            **kw)
        out.append((open(path, "rb").read(), back.to_rows()))
    assert out[0] == out[1]
    assert out[1][1] == [(1, 5), (2, None), (3, 7)]


TEMPLATE = [
    "SET format_template_row_format = 'row: ${a:CSV} -> ${b:Escaped}'",
    "SET format_template_rows_between_delimiter = '\n'",
]


def _small(s):
    s.sql("CREATE TABLE tt (a Int32, b String) ENGINE = Memory")
    s.sql("INSERT INTO tt VALUES (1, 'x\ty'), (2, 'plain'), (3, 'q\"r')")


def test_template_output(tmp_path):
    out = []
    for tag, s in zip("jp", (myscaledb_tpu.connect(),
                             myscaledb_tpu_torch.connect(device="cpu"))):
        _small(s)
        for q in TEMPLATE:
            s.sql(q)
        path = tmp_path / f"{tag}.txt"
        s.sql(f"SELECT * FROM tt ORDER BY a INTO OUTFILE '{path}' "
              "FORMAT Template")
        out.append(path.read_bytes())
    assert out[0] == out[1]
    assert out[1].startswith(b"row: 1 -> x\\ty\nrow: 2 -> plain\n")


CUSTOM = ["SET format_custom_field_delimiter = '|'",
          "SET format_custom_row_before_delimiter = '<'",
          "SET format_custom_row_after_delimiter = '>\n'"]


@pytest.mark.parametrize("rule", ["Escaped", "CSV", "Quoted", "JSON"])
def test_customseparated_roundtrip(rule, tmp_path):
    out = []
    for tag, s in zip("jp", (myscaledb_tpu.connect(),
                             myscaledb_tpu_torch.connect(device="cpu"))):
        _small(s)
        for q in CUSTOM + [f"SET format_custom_escaping_rule = '{rule}'"]:
            s.sql(q)
        path = tmp_path / f"{tag}.txt"
        s.sql(f"SELECT * FROM tt ORDER BY a INTO OUTFILE '{path}' "
              "FORMAT CustomSeparated")
        s.sql("CREATE TABLE ct2 (a Int32, b String) ENGINE = Memory")
        s.sql(f"INSERT INTO ct2 FROM INFILE '{path}' FORMAT CustomSeparated")
        out.append((path.read_bytes(),
                    s.sql_tsv("SELECT * FROM ct2 ORDER BY a")))
    assert out[0] == out[1]


def test_customseparated_with_names_repaired(tmp_path):
    """Repair (ROADMAP section 3; the JAX package's
    myscaledb_tpu/runtime/formats_extra.py:596 drops it): the WithNames
    form writes the names row, escaped by the rule and joined by the
    field delimiter, and its reader skips that row.  The JAX package
    writes no names row and reads its first data row as data."""
    s = myscaledb_tpu_torch.connect(device="cpu")
    _small(s)
    for q in CUSTOM:
        s.sql(q)
    path = tmp_path / "n.txt"
    s.sql(f"SELECT * FROM tt ORDER BY a INTO OUTFILE '{path}' "
          "FORMAT CustomSeparatedWithNames")
    assert path.read_text() == \
        "<a|b>\n<1|x\\ty>\n<2|plain>\n<3|q\"r>\n"
    s.sql("CREATE TABLE ct2 (a Int32, b String) ENGINE = Memory")
    s.sql(f"INSERT INTO ct2 FROM INFILE '{path}' FORMAT "
          "CustomSeparatedWithNames")
    assert s.sql("SELECT * FROM ct2 ORDER BY a").to_rows() == \
        [(1, "x\ty"), (2, "plain"), (3, 'q"r')]
    j = myscaledb_tpu.connect()
    _small(j)
    for q in CUSTOM:
        j.sql(q)
    jpath = tmp_path / "j.txt"
    j.sql(f"SELECT * FROM tt ORDER BY a INTO OUTFILE '{jpath}' "
          "FORMAT CustomSeparatedWithNames")
    assert not jpath.read_text().startswith("<a|b>")


def test_regexp_input(tmp_path):
    log = tmp_path / "r.log"
    log.write_text("2024-01-01 [INFO] hello\n2024-01-02 [WARN] bye\n"
                   "noise line\n")
    out = []
    for s in (myscaledb_tpu.connect(),
              myscaledb_tpu_torch.connect(device="cpu")):
        s.sql(r"SET format_regexp = '(\\S+) \\[(\\w+)\\] (.*)'")
        s.sql("SET format_regexp_skip_unmatched = 1")
        s.sql("CREATE TABLE lg (d String, lvl String, msg String) "
              "ENGINE = Memory")
        s.sql(f"INSERT INTO lg FROM INFILE '{log}' FORMAT Regexp")
        got = [s.sql_tsv("SELECT * FROM lg ORDER BY d")]
        s.sql("SET format_regexp_skip_unmatched = 0")
        s.sql("CREATE TABLE lg2 (d String, lvl String, msg String) "
              "ENGINE = Memory")
        with pytest.raises(ValueError) as e:
            s.sql(f"INSERT INTO lg2 FROM INFILE '{log}' FORMAT Regexp")
        out.append(got + [str(e.value)])
    assert out[0] == out[1]
