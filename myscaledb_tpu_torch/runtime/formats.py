"""File and wire formats: the port of myscaledb_tpu/runtime/formats.py.

A format registry analogous to ClickHouse's FormatFactory
(src/Formats/FormatFactory.h), with the JAX package's formats:

  input+output: CSV, TSV (+WithNames/WithNamesAndTypes), JSONEachRow, Values,
                Parquet, Arrow, ArrowStream, ORC (pyarrow-backed),
                RowBinary (+WithNamesAndTypes), Native (the engine's columnar
                binary, codec-framed: the NativeWriter/NativeReader analog)
  output only:  JSON, JSONCompact, Pretty, PrettyCompact

and the rest in runtime/formats_extra.py.  A file either package writes
the other reads; for the same table the bytes are the JAX package's.

The row formats work a column at a time.  Each column moves to the host
once; a writer formats each distinct dictionary string once and numbers,
dates and times in the native host library (csrc/host/msdb_host.cpp),
which assembles the rows.  The CSV/TSV reader splits the whole file into
fields there (Python's csv.reader semantics) and parses each column's
fields at once with the native typed parsers; JSONEachRow and RowBinary
are scanned the same way.  A JSONEachRow line beyond the native scanner
(not a flat object, a lone surrogate, ...) sends the file through
Python's json module, and an Array or vector column of RowBinary is
decoded row by row, as the JAX package does throughout.

Where the port differs from the JAX package (ROADMAP section 3): a
Float64 column is read exactly (the JAX package parses it through its
Float32 parser, ``formats.py:69-73``), and JSONEachRow reads the Date and
DateTime strings its writer writes (the JAX reader fails on them).
"""

from __future__ import annotations

import ast
import csv
import io
import json
import os
import re
import struct

import numpy as np
import torch

from myscaledb_tpu_torch import native
from myscaledb_tpu_torch.core.dictionary import NULL_ID, StringDictionary
from myscaledb_tpu_torch.core.table import Column, Table, ZoneMap, to_tensor
from myscaledb_tpu_torch.core.types import DataType, Field, physical_dtype
from myscaledb_tpu_torch.sql.format import (format_f32, format_f64,
                                            tuple_cell_plan)
from myscaledb_tpu_torch.storage.part import parallel_map

# rows a writer assembles in one native call (a thread's share)
WRITE_CHUNK_ROWS = 1 << 18


def _fields(schema) -> list[Field]:
    """Normalize a schema spec: Field objects, (name, dtype) or
    (name, dtype, nullable) tuples."""
    out = []
    for s in schema:
        if isinstance(s, Field):
            out.append(s)
        elif len(s) == 2:
            out.append(Field(s[0], s[1]))
        else:
            out.append(Field(s[0], s[1], bool(s[2])))
    return out


def _pairs(schema) -> list[tuple]:
    return [(f.name, f.dtype) for f in _fields(schema)]


def _names(table: Table) -> list:
    return [n for n in table.column_names if not n.startswith("__")]


def _type_name(fld: Field) -> str:
    base = fld.dtype.value
    if fld.dtype is DataType.ARRAY:
        base = f"Array({fld.elem.value if fld.elem else 'Int64'})"
    return f"Nullable({base})" if fld.nullable else base


_TYPE_WORDS = {"Int8", "Int16", "Int32", "Int64", "UInt8", "UInt16", "UInt32",
               "UInt64", "Float32", "Float64", "Bool", "String", "Date",
               "DateTime"}


def _looks_like_types(row: list) -> bool:
    return all(c.strip().removeprefix("Nullable(").removesuffix(")")
               in _TYPE_WORDS or c.strip().startswith("Array")
               for c in row if c.strip())


def _cell(v):
    """One value as the JAX package's CSV writer hands it to csv.writer."""
    import datetime as _dtm
    if isinstance(v, (list, np.ndarray)):
        return json.dumps([x if isinstance(x, str) else float(x) for x in v])
    if isinstance(v, (_dtm.date, _dtm.datetime)):
        return v.isoformat(sep=" ") if isinstance(v, _dtm.datetime) else \
            v.isoformat()
    return "" if v is None else v


def _json_val(v):
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, np.generic):
        return v.item()
    return v


def _values_cell(v) -> str:
    import datetime as _dtm
    if v is None:
        return "NULL"
    if isinstance(v, str):
        return "'" + v.replace("\\", "\\\\").replace("'", "\\'") + "'"
    if isinstance(v, (list, np.ndarray)):
        return "[" + ",".join(_values_cell(x) for x in v) + "]"
    if isinstance(v, (_dtm.date, _dtm.datetime)):
        return "'" + str(v) + "'"
    if isinstance(v, (bool, np.bool_)):
        return "true" if v else "false"
    if isinstance(v, np.generic):
        v = v.item()
    return repr(v)


# ---------------------------------------------------------------------------
# columns on the host and back

def _host(c: Column):
    """(data in the JAX package's physical dtype, validity or None): the
    column's one copy to the host."""
    data = c.to_numpy()
    if c.offsets is not None and c.field.elem is not None and \
            c.dictionary is None and c.field.elem.is_numeric:
        data = data.astype(physical_dtype(c.field.elem), copy=False)
    elif c.dictionary is not None and c.offsets is None:
        data = data.astype(np.int32, copy=False)
    valid = None
    if c.valid is not None:
        v = c.valid if isinstance(c.valid, np.ndarray) else \
            c.valid.cpu().numpy()
        valid = np.broadcast_to(v, (len(c),)) if v.ndim == 0 else v
    return data, valid


def _string_column(name: str, ids: np.ndarray, values: list,
                   device) -> Column:
    """A String column from int32 ids into ``values``, as Column.from_numpy
    makes it from the strings (nullable where an id is NULL)."""
    ids = np.ascontiguousarray(ids, dtype=np.int32)
    nullable = bool((ids == NULL_ID).any())
    valid = to_tensor(ids != NULL_ID, device) if nullable else None
    return Column(Field(name, DataType.STRING, nullable=nullable),
                  to_tensor(ids, device), valid, StringDictionary(values),
                  ZoneMap.build(ids))


def _numeric_column(name: str, data: np.ndarray, dt: DataType,
                    valid, device) -> Column:
    """A column with a validity mask (``valid`` None: no NULLs), the
    data zero under NULL."""
    if valid is not None:
        valid = np.asarray(valid, dtype=bool)
        data = np.where(valid, data, data.dtype.type(0))
    fld = Field(name, dt, nullable=valid is not None)
    return Column(fld, to_tensor(data, device),
                  to_tensor(valid, device) if valid is not None else None)


def _blob(pieces: list) -> tuple[np.ndarray, np.ndarray]:
    """bytes pieces -> (concatenated uint8, offsets (n + 1,))."""
    offs = np.zeros(len(pieces) + 1, dtype=np.int64)
    np.cumsum([len(p) for p in pieces], out=offs[1:])
    return np.frombuffer(b"".join(pieces) or b"\0", dtype=np.uint8), offs


def _text_column(name: str, dtype: DataType, buf: np.ndarray,
                 starts: np.ndarray, ends: np.ndarray, device) -> Column:
    """One column of text fields buf[starts[i]:ends[i]], typed as the JAX
    package's ``_convert_column`` types them (plus Float64 read exactly)."""
    n = len(starts)

    def strings():
        return [buf[s:e].tobytes().decode() for s, e in zip(starts, ends)]

    if dtype is DataType.STRING:
        ids, values = native.dict_encode_spans(buf, starts, ends)
        return _string_column(name, ids, values, device)
    if dtype is DataType.FLOAT32_VECTOR:
        arr = np.asarray([json.loads(s) for s in strings()],
                         dtype=np.float32)
        return Column.from_numpy(name, arr, dtype, device=device)
    if dtype is DataType.ARRAY:
        return Column.from_numpy(name, [json.loads(s) for s in strings()],
                                 dtype, device=device)
    if dtype in (DataType.DATE, DataType.DATETIME):
        kind = "date" if dtype is DataType.DATE else "datetime"
        arr, k = native.parse_spans(kind, buf, starts, ends)
        if k < n:       # another spelling: numpy's datetime64 parser
            unit = "datetime64[D]" if dtype is DataType.DATE else \
                "datetime64[s]"
            arr = np.asarray(strings(), dtype=unit).astype(np.int64)
        return Column.from_numpy(name, arr.astype(physical_dtype(dtype)),
                                 dtype, device=device)
    if dtype.is_integer:
        arr, k = native.parse_spans("int64", buf, starts, ends)
        if k < n:
            raise ValueError(f"cannot parse "
                             f"{buf[starts[k]:ends[k]].tobytes().decode()!r}"
                             f" as Int64 (row {k})")
        return Column.from_numpy(name, arr.astype(physical_dtype(dtype)),
                                 dtype, device=device)
    if dtype.is_float:
        kind = "float32" if dtype is DataType.FLOAT32 else "float64"
        arr, k = native.parse_spans(kind, buf, starts, ends)
        if k < n:
            raise ValueError(f"cannot parse "
                             f"{buf[starts[k]:ends[k]].tobytes().decode()!r}"
                             f" as {dtype.value} (row {k})")
        return Column.from_numpy(name, arr.astype(physical_dtype(dtype)),
                                 dtype, device=device)
    if dtype is DataType.BOOL:
        arr = np.asarray([s.lower() in ("1", "true") for s in strings()],
                         dtype=bool)
        return Column.from_numpy(name, arr, dtype, device=device)
    raise ValueError(f"cannot parse column {name!r} as {dtype}")


def _convert_column(strings: list, dtype: DataType, name: str):
    """A list of strings typed as a column (the slow readers' path): the
    JAX package's ``_convert_column``, with Float64 read exactly."""
    if dtype is DataType.STRING:
        return np.asarray(strings, dtype=object)
    if dtype is DataType.FLOAT32_VECTOR:
        return np.asarray([json.loads(s) for s in strings], dtype=np.float32)
    if dtype is DataType.ARRAY:
        return [json.loads(s) for s in strings]
    if dtype is DataType.DATE:
        return np.asarray(strings, dtype="datetime64[D]")
    if dtype is DataType.DATETIME:
        return np.asarray(strings, dtype="datetime64[s]")
    if dtype.is_integer:
        return native.parse_int64(strings).astype(physical_dtype(dtype))
    if dtype is DataType.FLOAT32:
        return native.parse_float32(strings)
    if dtype is DataType.FLOAT64:
        return np.asarray([float(s) for s in strings], dtype=np.float64)
    if dtype is DataType.BOOL:
        return np.asarray([s.lower() in ("1", "true") for s in strings])
    raise ValueError(f"cannot parse column {name!r} as {dtype}")


# ---------------------------------------------------------------------------
# CSV / TSV

def read_csv(path: str, schema: list, delimiter: str = ",",
             has_header: bool | None = None, *, device) -> Table:
    """schema: list of (name, DataType)."""
    schema = _pairs(schema)
    buf = np.fromfile(path, dtype=np.uint8)
    out, fo, rf = native.csv_split(buf, delimiter)
    nrec = len(rf) - 1
    if nrec == 0:
        return Table([])

    def record(r):
        return [out[fo[f]:fo[f + 1]].tobytes().decode()
                for f in range(rf[r], rf[r + 1])]

    names = [n for n, _ in schema]
    first = 0
    if has_header is None:
        r0 = record(0)
        has_header = r0 == names or all(
            c.strip() and not c.strip().lstrip("+-").replace(".", "")
            .isdigit() for c in r0[:1]) and r0[0] == names[0]
    if has_header:
        first = 1
        # WithNamesAndTypes: a second header line carrying type names
        if nrec > 1:
            r1 = record(1)
            if r1 and r1[0].strip() and _looks_like_types(r1):
                first = 2
    rec = rf[first:nrec]
    width = rf[first + 1:nrec + 1] - rec
    if len(rec) and int(width.min()) < len(schema):
        raise IndexError("list index out of range")

    def column(i):
        f = rec + i
        return _text_column(schema[i][0], schema[i][1], out, fo[f],
                            fo[f + 1], device)

    return Table(parallel_map(column, list(range(len(schema)))))


def _csv_quote(s: str, delimiter: str) -> str:
    """A field as csv.writer's QUOTE_MINIMAL writes it."""
    if delimiter in s or '"' in s or "\r" in s or "\n" in s:
        return '"' + s.replace('"', '""') + '"'
    return s


def _text_piece(c: Column, quote, null_text: str,
                date_quote: str = "") -> dict:
    """One column of a text row format: the native kinds for the plain
    types, each distinct string rendered once by ``quote``, the rest by
    ``quote(cell)`` per row."""
    data, valid = _host(c)
    dt = c.dtype
    piece = {"valid": valid, "null": null_text.encode()}
    if c.offsets is None and dt is DataType.STRING:
        blob, offs = _blob([quote(v).encode() for v in c.dictionary.values])
        piece.update(kind=native.FK_DICT, data=data, blob=blob, offs=offs)
    elif c.offsets is None and dt is DataType.BOOL:
        blob, offs = _blob([quote(False).encode(), quote(True).encode()])
        piece.update(kind=native.FK_DICT, blob=blob, offs=offs,
                     data=data.astype(np.int32))
    elif c.offsets is None and dt is DataType.DATE:
        piece.update(kind=native.FK_DATE, data=data.astype(np.int32),
                     pre=date_quote.encode(), post=date_quote.encode())
    elif c.offsets is None and dt is DataType.DATETIME:
        piece.update(kind=native.FK_DATETIME, data=data.astype(np.int64),
                     pre=date_quote.encode(), post=date_quote.encode())
    elif c.offsets is None and dt.is_integer:
        if data.dtype == np.uint64:
            piece.update(kind=native.FK_U64, data=data)
        else:
            piece.update(kind=native.FK_I64, data=data.astype(np.int64))
    elif c.offsets is None and dt.is_float:
        # Python's float repr, which numpy's float64 str equals
        text = np.asarray(data, dtype=np.float64).astype(str)
        blob, offs = _blob([quote(float(x)).encode() if not
                            np.isfinite(x) else s.encode()
                            for s, x in zip(text.tolist(), data.tolist())])
        piece.update(kind=native.FK_BLOB, blob=blob, offs=offs)
    else:
        blob, offs = _blob([b"" if v is None else quote(v).encode()
                            for v in c.to_python()])
        piece.update(kind=native.FK_BLOB, blob=blob, offs=offs)
    return piece


def _write_rows(path: str, head: bytes, pieces: list, row_end: bytes,
                n: int) -> None:
    """Rows [0, n) assembled WRITE_CHUNK_ROWS at a time on a thread pool
    (the native call releases the interpreter lock), written in order."""
    starts = list(range(0, n, WRITE_CHUNK_ROWS))
    with open(path, "wb") as f:
        f.write(head)
        for chunk in parallel_map(lambda r0: native.format_rows(
                pieces, row_end, r0, min(n, r0 + WRITE_CHUNK_ROWS)),
                starts):
            f.write(chunk)


def write_csv(table: Table, path: str, delimiter: str = ",",
              header: bool = True, types_header: bool = False) -> int:
    """Byte for byte what the JAX package's csv.writer loop writes
    (QUOTE_MINIMAL, \\r\\n line ends, repr floats, True/False)."""
    names = _names(table)
    sio = io.StringIO(newline="")
    w = csv.writer(sio, delimiter=delimiter)
    if header:
        w.writerow(names)
    if types_header:
        w.writerow([_type_name(table[n].field) for n in names])
    single = len(names) == 1

    def quote(v):
        s = _cell(v)
        s = s if isinstance(s, str) else str(s)
        # a lone empty field is written "" (csv.writer's one-field rule)
        return '""' if single and s == "" else _csv_quote(s, delimiter)

    pieces = []
    for i, n in enumerate(names):
        p = _text_piece(table[n], quote, '""' if single else "")
        p["lead"] = delimiter.encode() if i else b""
        pieces.append(p)
    _write_rows(path, sio.getvalue().encode(), pieces, b"\r\n",
                table.n_rows)
    return table.n_rows


# ---------------------------------------------------------------------------
# JSONEachRow

def _json_text(v) -> str:
    return json.dumps(_json_val(v), default=str)


def write_jsoneachrow(table: Table, path: str) -> int:
    names = _names(table)
    pieces = []
    for i, n in enumerate(names):
        p = _text_piece(table[n], _json_text, "null", date_quote='"')
        p["lead"] = (("{" if i == 0 else ", ") + json.dumps(n) + ": ") \
            .encode()
        pieces.append(p)
    row_end = b"}\n" if names else b"{}\n"
    _write_rows(path, b"", pieces, row_end, table.n_rows)
    return table.n_rows


def _jsoneachrow_column(name: str, dtype: DataType, vals: list, device):
    """The JAX package's per-column typing of json.loads values, reading
    Date/DateTime strings as dates."""
    if dtype is DataType.STRING:
        return Column.from_numpy(name, np.asarray(vals, dtype=object),
                                 dtype, device=device)
    if dtype is DataType.FLOAT32_VECTOR:
        return Column.from_numpy(name, np.asarray(vals, dtype=np.float32),
                                 dtype, device=device)
    if dtype is DataType.ARRAY:
        return Column.from_numpy(name, vals, dtype, device=device)
    arr = np.asarray(vals)
    if dtype in (DataType.DATE, DataType.DATETIME) and arr.dtype.kind == "U":
        unit = "datetime64[D]" if dtype is DataType.DATE else "datetime64[s]"
        arr = arr.astype(unit).astype(np.int64)
    return Column.from_numpy(name, arr.astype(physical_dtype(dtype)), dtype,
                             device=device)


def read_jsoneachrow(path: str, schema: list, *, device) -> Table:
    schema = _pairs(schema)
    buf = np.fromfile(path, dtype=np.uint8)
    scan = native.json_scan(buf, [n for n, _ in schema])
    if scan is None:
        with open(path) as f:
            docs = [json.loads(line) for line in f if line.strip()]
        return Table([_jsoneachrow_column(name, dtype,
                                          [d.get(name) for d in docs],
                                          device)
                      for name, dtype in schema])
    n, out, st, en, kinds = scan

    def column(i):
        name, dtype = schema[i]
        k, s, e = kinds[:, i], st[:, i], en[:, i]
        if dtype is DataType.STRING and np.isin(k, (0, 1, 3)).all():
            s = np.where(k == 3, s, -1)
            ids, values = native.dict_encode_spans(out, s, e)
            return _string_column(name, ids, values, device)
        if dtype.is_numeric and n and np.isin(k, (2, 7)).all():
            # numbers: ints, or floats where any has a fraction or an
            # exponent (np.asarray of the json values is float64 then)
            floaty = bool((k == 7).any())
            arr, j = native.parse_spans("float64" if floaty else "int64",
                                        out, s, e)
            if j == n:
                return Column.from_numpy(name, arr.astype(
                    physical_dtype(dtype)), dtype, device=device)
        if dtype in (DataType.DATE, DataType.DATETIME) and n and \
                (k == 3).all():
            return _text_column(name, dtype, out, s, e, device)
        return _jsoneachrow_column(name, dtype, _json_values(out, k, s, e),
                                   device)

    return Table(parallel_map(column, list(range(len(schema)))))


def _json_values(out: np.ndarray, kinds, starts, ends) -> list:
    """The python values of scanned JSON cells (missing keys as None)."""
    vals = []
    for k, s, e in zip(kinds.tolist(), starts.tolist(), ends.tolist()):
        if k in (0, 1):
            vals.append(None)
        elif k == 3:
            vals.append(out[s:e].tobytes().decode())
        elif k in (4, 5):
            vals.append(k == 4)
        else:
            vals.append(json.loads(out[s:e].tobytes()))
    return vals


# ---------------------------------------------------------------------------
# Arrow bridge (Parquet / Arrow IPC / ORC ride on this)

def table_to_arrow(table: Table):
    """Engine Table -> pyarrow.Table (decodes dictionaries, rebuilds nulls)."""
    import pyarrow as pa
    arrays, fields = [], []
    for c in table.columns.values():
        if c.name.startswith("__"):
            continue
        dt = c.dtype
        data, valid = _host(c)
        mask = None if valid is None else ~np.asarray(valid, dtype=bool)
        if dt is DataType.ARRAY:
            arr = pa.array(c.to_python())
        elif dt is DataType.STRING:
            arr = pa.array(c.to_python(), type=pa.string())
        elif dt is DataType.FLOAT32_VECTOR:
            flat = pa.array(np.asarray(data, dtype=np.float32).reshape(-1))
            arr = pa.FixedSizeListArray.from_arrays(
                flat, int(c.field.vector_dim or data.shape[1]))
        elif dt is DataType.DATE:
            arr = pa.array(np.asarray(data, dtype=np.int32),
                           type=pa.date32(), mask=mask)
        elif dt is DataType.DATETIME:
            arr = pa.array(np.asarray(data, dtype=np.int64),
                           type=pa.timestamp("s"), mask=mask)
        else:
            arr = pa.array(data, mask=mask)
        arrays.append(arr)
        fields.append(pa.field(c.name, arr.type, nullable=mask is not None))
    return pa.Table.from_arrays(arrays, schema=pa.schema(fields))


def _infer_dt(vals: np.ndarray) -> DataType:
    from myscaledb_tpu_torch.core.types import infer_type
    a = np.asarray(vals)
    if a.dtype == object:          # nullable ints surface as object
        a = np.asarray([0 if v is None else v for v in vals])
        if a.dtype.kind == "f" and np.all(a == a.astype(np.int64)):
            return DataType.INT64
    return infer_type(a)


def _arrow_numeric(name: str, data: np.ndarray, dt: DataType, arrow_col,
                   device) -> Column:
    valid = None
    if arrow_col.null_count:
        valid = ~np.asarray(arrow_col.is_null().to_numpy(
            zero_copy_only=False))
    return _numeric_column(name, data, dt, valid, device)


def table_from_arrow(at, schema: list | None = None, *, device) -> Table:
    """pyarrow.Table -> engine Table.  schema (name, DataType) pairs override
    inference; extra arrow columns not in the schema are dropped."""
    import pyarrow as pa
    want = {f.name: f.dtype for f in _fields(schema)} if schema else None
    cols = []
    for i, f in enumerate(at.schema):
        if want is not None and f.name not in want:
            continue
        col = at.column(i).combine_chunks()
        t = f.type
        if pa.types.is_string(t) or pa.types.is_large_string(t):
            cols.append(Column.from_numpy(
                f.name, np.asarray(col.to_pylist(), dtype=object),
                DataType.STRING, device=device))
        elif pa.types.is_fixed_size_list(t):
            vals = np.asarray(col.values.to_numpy(zero_copy_only=False),
                              dtype=np.float32)
            cols.append(Column.from_numpy(
                f.name, vals.reshape(len(col), t.list_size),
                DataType.FLOAT32_VECTOR, device=device))
        elif pa.types.is_list(t) or pa.types.is_large_list(t):
            cols.append(Column.from_pylist_of_lists(f.name, col.to_pylist(),
                                                    device=device))
        elif pa.types.is_date32(t) or pa.types.is_date64(t):
            days = np.asarray(col.cast(pa.date32()).view(pa.int32())
                              .to_numpy(zero_copy_only=False))
            cols.append(_arrow_numeric(f.name, days, DataType.DATE, col,
                                       device))
        elif pa.types.is_timestamp(t):
            secs = np.asarray(col.cast(pa.timestamp("s")).view(pa.int64())
                              .to_numpy(zero_copy_only=False))
            cols.append(_arrow_numeric(f.name, secs, DataType.DATETIME, col,
                                       device))
        elif pa.types.is_boolean(t):
            vals = np.asarray(col.to_numpy(zero_copy_only=False), dtype=bool)
            cols.append(_arrow_numeric(f.name, vals, DataType.BOOL, col,
                                       device))
        else:
            vals = col.to_numpy(zero_copy_only=False)
            dt = (want or {}).get(f.name) or _infer_dt(vals)
            vals = np.nan_to_num(vals, nan=0.0) if col.null_count and \
                vals.dtype.kind == "f" else vals
            cols.append(_arrow_numeric(
                f.name, np.asarray(vals).astype(physical_dtype(dt)), dt, col,
                device))
    return Table(cols)


def read_parquet(path: str, schema=None, *, device) -> Table:
    import pyarrow.parquet as pq
    return table_from_arrow(pq.read_table(path), schema, device=device)


def write_parquet(table: Table, path: str) -> int:
    import pyarrow.parquet as pq
    pq.write_table(table_to_arrow(table), path)
    return table.n_rows


def read_orc(path: str, schema=None, *, device) -> Table:
    import pyarrow.orc as orc
    return table_from_arrow(orc.read_table(path), schema, device=device)


def write_orc(table: Table, path: str) -> int:
    import pyarrow.orc as orc
    orc.write_table(table_to_arrow(table), path)
    return table.n_rows


def read_arrow(path: str, schema=None, stream: bool = False, *,
               device) -> Table:
    import pyarrow as pa
    with open(path, "rb") as f:
        rdr = (pa.ipc.open_stream if stream else pa.ipc.open_file)(f)
        return table_from_arrow(rdr.read_all(), schema, device=device)


def write_arrow(table: Table, path: str, stream: bool = False) -> int:
    import pyarrow as pa
    at = table_to_arrow(table)
    with open(path, "wb") as f:
        mk = pa.ipc.new_stream if stream else pa.ipc.new_file
        with mk(f, at.schema) as w:
            w.write_table(at)
    return table.n_rows


# ---------------------------------------------------------------------------
# RowBinary (reference: src/Processors/Formats/Impl/BinaryRowInputFormat.cpp)
# Little-endian fixed-width scalars; String = varint length + utf8 bytes;
# Array = varint count + elements; Nullable = 1 prefix byte (1 = NULL).

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _read_varint(buf, pos: int) -> tuple[int, int]:
    n = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        n |= (b & 0x7F) << shift
        if not (b & 0x80):
            return n, pos
        shift += 7


_RB_PACK = {
    DataType.INT8: "<b", DataType.INT16: "<h", DataType.INT32: "<i",
    DataType.INT64: "<q", DataType.UINT8: "<B", DataType.UINT16: "<H",
    DataType.UINT32: "<I", DataType.UINT64: "<Q",
    DataType.FLOAT32: "<f", DataType.FLOAT64: "<d",
    DataType.DATE: "<i", DataType.DATETIME: "<q",
}
# the same little-endian layouts as numpy dtypes
_RB_DTYPE = {k: np.dtype(v) for k, v in _RB_PACK.items()}


def _encode_rb_value(v, fld: Field) -> bytes:
    import datetime as _dtm
    if fld.nullable:
        if v is None:
            return b"\x01"
        prefix = b"\x00"
    else:
        prefix = b""
    dt = fld.dtype
    if dt is DataType.STRING:
        b = str(v).encode()
        return prefix + _varint(len(b)) + b
    if dt is DataType.BOOL:
        return prefix + (b"\x01" if v else b"\x00")
    if dt in (DataType.FLOAT32_VECTOR, DataType.ARRAY):
        items = list(v)
        elem = fld.elem or (DataType.FLOAT32 if dt is DataType.FLOAT32_VECTOR
                            else DataType.INT64)
        body = b"".join(_encode_rb_value(x, Field("", elem)) for x in items)
        return prefix + _varint(len(items)) + body
    if isinstance(v, _dtm.datetime):
        v = int((v - _dtm.datetime(1970, 1, 1)).total_seconds())
    elif isinstance(v, _dtm.date):
        v = (v - _dtm.date(1970, 1, 1)).days
    return prefix + struct.pack(_RB_PACK[dt], v)


def _rb_piece(c: Column) -> dict:
    fld = c.field
    dt = c.dtype
    piece = {"pre": b"\x00", "null": b"\x01"} if fld.nullable else {}
    if c.offsets is None and dt in _RB_DTYPE:
        data, valid = _host(c)
        raw = np.ascontiguousarray(data.astype(_RB_DTYPE[dt]))
        piece.update(kind=native.FK_RAW, data=raw.view(np.uint8),
                     width=raw.dtype.itemsize, valid=valid)
    elif c.offsets is None and dt is DataType.BOOL:
        data, valid = _host(c)
        piece.update(kind=native.FK_RAW, width=1, valid=valid,
                     data=(data != 0).astype(np.uint8))
    elif c.offsets is None and dt is DataType.STRING:
        data, valid = _host(c)
        enc = [v.encode() for v in c.dictionary.values]
        blob, offs = _blob([_varint(len(b)) + b for b in enc])
        piece.update(kind=native.FK_DICT, data=data, blob=blob, offs=offs,
                     valid=valid)
        if not fld.nullable:
            piece["null"] = _varint(4) + b"None"   # str(None), as written
    else:
        bare = Field(fld.name, dt, False, fld.vector_dim, fld.elem)
        blob, offs = _blob([b"" if v is None else _encode_rb_value(v, bare)
                            for v in c.to_python()])
        piece.update(kind=native.FK_BLOB, blob=blob, offs=offs,
                     valid=_host(c)[1] if fld.nullable else None)
    return piece


def write_rowbinary(table: Table, path: str, with_names: bool = False) -> int:
    names = _names(table)
    head = bytearray()
    if with_names:
        head += _varint(len(names))
        for n in names:
            b = n.encode()
            head += _varint(len(b)) + b
        for n in names:
            b = _type_name(table[n].field).encode()
            head += _varint(len(b)) + b
    _write_rows(path, bytes(head), [_rb_piece(table[n]) for n in names],
                b"", table.n_rows)
    return table.n_rows


def _decode_rb_value(buf, pos: int, fld: Field):
    if fld.nullable:
        isnull = buf[pos]
        pos += 1
        if isnull:
            return None, pos
    dt = fld.dtype
    if dt is DataType.STRING:
        ln, pos = _read_varint(buf, pos)
        return bytes(buf[pos:pos + ln]).decode(), pos + ln
    if dt is DataType.BOOL:
        return bool(buf[pos]), pos + 1
    if dt in (DataType.FLOAT32_VECTOR, DataType.ARRAY):
        cnt, pos = _read_varint(buf, pos)
        elem = fld.elem or (DataType.FLOAT32 if dt is DataType.FLOAT32_VECTOR
                            else DataType.INT64)
        out = []
        ef = Field("", elem)
        for _ in range(cnt):
            v, pos = _decode_rb_value(buf, pos, ef)
            out.append(v)
        return out, pos
    fmt = _RB_PACK[dt]
    size = struct.calcsize(fmt)
    v = struct.unpack_from(fmt, buf, pos)[0]
    return v, pos + size


def _rb_rows_python(buf, pos: int, flds: list, device) -> Table:
    """The JAX package's row-by-row RowBinary decode (Array and vector
    columns take it)."""
    names = [f.name for f in flds]
    rows = {n: [] for n in names}
    buf = memoryview(buf)
    while pos < len(buf):
        for n, fld in zip(names, flds):
            v, pos = _decode_rb_value(buf, pos, fld)
            rows[n].append(v)
    out = []
    for f in flds:
        n, d = f.name, f.dtype
        if d is DataType.STRING:
            v = np.asarray(rows[n], dtype=object)
        elif d is DataType.ARRAY:
            v = rows[n]
        elif d is DataType.FLOAT32_VECTOR:
            v = np.asarray(rows[n], dtype=np.float32)
        elif f.nullable:
            vals = rows[n]
            valid = np.asarray([x is not None for x in vals], dtype=bool)
            data = np.asarray([0 if x is None else x for x in vals]).astype(
                physical_dtype(d))
            out.append(Column(Field(n, d, nullable=True),
                              to_tensor(data, device),
                              to_tensor(valid, device)))
            continue
        else:
            v = np.asarray(rows[n]).astype(physical_dtype(d))
        out.append(Column.from_numpy(n, v, d, device=device))
    return Table(out)


def read_rowbinary(path: str, schema: list, with_names: bool = False, *,
                   device) -> Table:
    flds = _fields(schema)
    buf = np.fromfile(path, dtype=np.uint8)
    view = memoryview(buf)          # python ints, not numpy uint8 scalars
    pos = 0
    if with_names:
        ncols, pos = _read_varint(view, pos)
        # names then types: the embedded type header carries nullability,
        # overriding the caller's schema (reference reads it the same way)
        hdr = []
        for _ in range(2 * ncols):
            ln, pos = _read_varint(view, pos)
            hdr.append(bytes(view[pos:pos + ln]).decode())
            pos += ln
        flds = [Field(f.name, f.dtype,
                      nullable=t.startswith("Nullable("),
                      vector_dim=f.vector_dim, elem=f.elem)
                for f, t in zip(flds, hdr[ncols:])]
    if any(f.dtype in (DataType.ARRAY, DataType.FLOAT32_VECTOR)
           for f in flds):
        return _rb_rows_python(buf, pos, flds, device)
    widths = [0 if f.dtype is DataType.STRING else
              1 if f.dtype is DataType.BOOL else _RB_DTYPE[f.dtype].itemsize
              for f in flds]
    n, fixed, spans, nulls = native.rowbinary_scan(
        buf, pos, widths, [f.nullable for f in flds])
    def column(item):
        f, raw, sp, nl = item
        d = f.dtype
        if d is DataType.STRING:
            ids, values = native.dict_encode_spans(buf, *sp)
            return _string_column(f.name, ids, values, device)
        vals = raw.view(np.uint8) != 0 if d is DataType.BOOL else \
            raw.view(_RB_DTYPE[d])
        data = vals.astype(physical_dtype(d))
        if f.nullable:
            return Column(Field(f.name, d, nullable=True),
                          to_tensor(data, device), to_tensor(nl == 0, device))
        return Column.from_numpy(f.name, data, d, device=device)

    return Table(parallel_map(column, list(zip(flds, fixed, spans, nulls))))


# ---------------------------------------------------------------------------
# Native: the engine's columnar binary format (NativeWriter/NativeReader
# analog, src/Formats/NativeWriter.h:20).  JSON header + codec-framed column
# buffers (the storage codecs: delta for ints, byte-shuffle for floats).

_NATIVE_MAGIC = b"MSDNAT1\x00"


def write_native(table: Table, path: str) -> int:
    from myscaledb_tpu_torch.storage import codecs

    def frame(arr: np.ndarray) -> bytes:
        buf = codecs.encode(np.ascontiguousarray(arr),
                            codecs.default_codec(arr.dtype))
        return struct.pack("<Q", len(buf)) + buf

    def column(c: Column):
        data, valid = _host(c)
        meta = {"name": c.name, "type": c.dtype.value,
                "nullable": c.valid is not None,
                "dim": int(c.field.vector_dim or 0),
                "elem": c.field.elem.value if c.field.elem else None,
                "n": len(c)}
        body = b""
        if c.dictionary is not None:
            strings = json.dumps(c.dictionary.values,
                                 ensure_ascii=False).encode()
            body += struct.pack("<Q", len(strings)) + strings
            meta["dict"] = True
        if c.offsets is not None:
            body += frame(np.asarray(c.offsets, dtype=np.int64))
            meta["offsets"] = True
        if valid is not None:
            body += frame(np.asarray(valid, dtype=np.uint8))
        meta["phys"] = data.dtype.str
        meta["flat"] = int(data.size)
        body += frame(data.reshape(-1))
        return meta, body

    done = parallel_map(column, [c for c in table.columns.values()
                                 if not c.name.startswith("__")])
    header = json.dumps({"columns": [m for m, _ in done]}).encode()
    with open(path, "wb") as f:
        f.write(_NATIVE_MAGIC)
        f.write(struct.pack("<Q", len(header)))
        f.write(header)
        for _, body in done:
            f.write(body)
    return table.n_rows


def read_native(path: str, schema=None, *, device) -> Table:
    from myscaledb_tpu_torch.storage import codecs
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:8] != _NATIVE_MAGIC:
        raise ValueError("not a Native file")
    hlen = struct.unpack_from("<Q", raw, 8)[0]
    header = json.loads(raw[16:16 + hlen])
    pos = 16 + hlen
    view = memoryview(raw)

    def frame():
        nonlocal pos
        ln = struct.unpack_from("<Q", raw, pos)[0]
        pos += 8
        out = view[pos:pos + ln]
        pos += ln
        return out

    # the frames' places, in one pass over their lengths
    plan = []
    for m in header["columns"]:
        strings = None
        if m.get("dict"):
            slen = struct.unpack_from("<Q", raw, pos)[0]
            pos += 8
            strings = view[pos:pos + slen]
            pos += slen
        offsets = frame() if m.get("offsets") else None
        valid = frame() if m["nullable"] else None
        plan.append((m, strings, offsets, valid, frame()))

    def column(item):
        m, strings, offsets, valid, data = item
        dt = DataType(m["type"])
        n = m["n"]
        dictionary = StringDictionary(json.loads(bytes(strings))) \
            if strings is not None else None
        if offsets is not None:
            offsets = np.array(codecs.decode(bytes(offsets), np.int64, n + 1))
        if valid is not None:
            valid = codecs.decode(bytes(valid), np.uint8, n).astype(bool)
        arr = codecs.decode(bytes(data), np.dtype(m["phys"]), m["flat"])
        if dt is DataType.FLOAT32_VECTOR and m["dim"]:
            arr = arr.reshape(n, m["dim"])
        elem = DataType(m["elem"]) if m.get("elem") else None
        fld = Field(m["name"], dt, nullable=m["nullable"],
                    vector_dim=m["dim"], elem=elem)
        return fld, arr, valid, dictionary, offsets

    cols = []
    for fld, arr, valid, dictionary, offsets in parallel_map(column, plan):
        cols.append(Column(fld, to_tensor(arr, device),
                           to_tensor(valid, device)
                           if valid is not None else None,
                           dictionary, None, offsets))
    return Table(cols)


# ---------------------------------------------------------------------------
# Values (reference: ValuesBlockInputFormat) — "(1,'a',[1,2]), (2,'b',[3])"

def read_values(path: str, schema: list, *, device) -> Table:
    with open(path) as f:
        text = f.read()
    return values_to_table(text, schema, device=device)


def values_to_table(text: str, schema: list, *, device) -> Table:
    schema = _pairs(schema)
    text = re.sub(r"\bNULL\b", "None", text, flags=re.IGNORECASE).strip()
    text = re.sub(r"\btrue\b", "True", text)
    text = re.sub(r"\bfalse\b", "False", text)
    if not text:
        return Table.from_dict({n: [] for n, _ in schema},
                               dtypes=dict(schema), device=device)
    rows = ast.literal_eval("[" + text.rstrip(";, \n") + "]")
    if rows and not isinstance(rows[0], tuple):
        rows = [rows]  # single row
    cols = {}
    for i, (name, dtype) in enumerate(schema):
        vals = [r[i] for r in rows]
        if dtype is DataType.STRING:
            cols[name] = np.asarray(vals, dtype=object)
        elif dtype is DataType.FLOAT32_VECTOR:
            cols[name] = np.asarray(vals, dtype=np.float32)
        elif dtype is DataType.ARRAY:
            cols[name] = vals
        elif dtype is DataType.DATE:
            cols[name] = np.asarray(vals, dtype="datetime64[D]")
        elif dtype is DataType.DATETIME:
            cols[name] = np.asarray(vals, dtype="datetime64[s]")
        else:
            cols[name] = np.asarray(
                [0 if v is None else v for v in vals]).astype(
                physical_dtype(dtype))
    return Table.from_dict(cols, dtypes=dict(schema), device=device)


def write_values(table: Table, path: str) -> int:
    names = _names(table)
    pycols = {n: table[n].to_python() for n in names}
    with open(path, "w") as f:
        parts = []
        for i in range(table.n_rows):
            parts.append("(" + ",".join(_values_cell(pycols[n][i])
                                        for n in names) + ")")
        f.write(",".join(parts))
    return table.n_rows


# ---------------------------------------------------------------------------
# Pretty / JSON output (reference: PrettyBlockOutputFormat, JSONRowOutput)

def format_pretty(table: Table, compact: bool = True) -> str:
    from myscaledb_tpu_torch.sql.format import format_value
    names = _names(table)
    if not names:
        return ""
    # the JAX package hands format_value the column's Field
    cells = [[format_value(v, table[n].field)
              for v in table[n].to_python()] for n in names]
    widths = [max(len(n), *(len(x) for x in col)) if col else len(n)
              for n, col in zip(names, cells)]

    def line(l, m, r):
        return l + m.join("─" * (w + 2) for w in widths) + r

    def row(vals, pad=str.ljust):
        return "│ " + " │ ".join(pad(v, w) for v, w in zip(vals, widths)) + \
            " │"

    out = [line("┌", "┬", "┐"), row(names), line("├", "┼", "┤")]
    for i in range(table.n_rows):
        out.append(row([cells[j][i] for j in range(len(names))],
                       pad=lambda s, w: s.rjust(w)))
    out.append(line("└", "┴", "┘"))
    return "\n".join(out)


def format_json(table: Table, compact: bool = False) -> str:
    names = _names(table)
    meta = [{"name": n, "type": _type_name(table[n].field)} for n in names]
    pycols = {n: table[n].to_python() for n in names}
    if compact:
        data = [[_json_val(pycols[n][i]) for n in names]
                for i in range(table.n_rows)]
    else:
        data = [{n: _json_val(pycols[n][i]) for n in names}
                for i in range(table.n_rows)]
    return json.dumps({"meta": meta, "data": data, "rows": table.n_rows},
                      default=str, indent=1)


# ---------------------------------------------------------------------------
# Format registry (FormatFactory analog)

def normalize_format(fmt: str) -> str:
    """A format name as the registry compares it: no underscores, upper
    case (``TabSeparated_WithNames`` -> ``TABSEPARATEDWITHNAMES``)."""
    return fmt.replace("_", "").upper()


def is_input_format(name: str) -> bool:
    return normalize_format(name) in _INPUT_NORMS


# formats whose files carry their own schema: file()/url()/s3() read them
# with no structure argument
SELF_DESCRIBING = frozenset({"PARQUET", "ORC", "ARROW", "ARROWSTREAM",
                             "NATIVE"})


def is_self_describing(fmt: str) -> bool:
    return normalize_format(fmt) in SELF_DESCRIBING


EXTENSION_FORMATS = {".csv": "CSV", ".tsv": "TSV", ".json": "JSONEachRow",
                     ".jsonl": "JSONEachRow", ".ndjson": "JSONEachRow",
                     ".parquet": "Parquet", ".orc": "ORC", ".arrow": "Arrow",
                     ".arrows": "ArrowStream", ".native": "Native",
                     ".bin": "RowBinary", ".values": "Values"}


def format_from_extension(path: str, default: str | None = None) -> str:
    """The format a file's extension names.  An unknown extension gives
    ``default`` (the file()/url()/s3() table functions read CSV) or, with
    none, raises: INFILE, OUTFILE and FILE dictionaries need a FORMAT."""
    ext = os.path.splitext(path)[1].lower()
    if ext in EXTENSION_FORMATS:
        return EXTENSION_FORMATS[ext]
    if default is not None:
        return default
    raise ValueError(f"cannot infer format from extension of {path!r}; "
                     f"add FORMAT <name>")


def read_file(path: str, fmt: str, schema: list, settings=None, *,
              device) -> Table:
    f = normalize_format(fmt)
    if f == "CSV":
        return read_csv(path, schema, device=device)
    if f == "TSV" or f == "TABSEPARATED":
        return read_csv(path, schema, delimiter="\t", device=device)
    if f in ("CSVWITHNAMES", "CSVWITHNAMESANDTYPES"):
        return read_csv(path, schema, has_header=True, device=device)
    if f in ("TSVWITHNAMES", "TSVWITHNAMESANDTYPES",
             "TABSEPARATEDWITHNAMES", "TABSEPARATEDWITHNAMESANDTYPES"):
        return read_csv(path, schema, delimiter="\t", has_header=True,
                        device=device)
    if f == "JSONEACHROW":
        return read_jsoneachrow(path, schema, device=device)
    if f == "PARQUET":
        return read_parquet(path, schema, device=device)
    if f == "ORC":
        return read_orc(path, schema, device=device)
    if f == "ARROW":
        return read_arrow(path, schema, device=device)
    if f == "ARROWSTREAM":
        return read_arrow(path, schema, stream=True, device=device)
    if f == "NATIVE":
        return read_native(path, schema, device=device)
    if f == "ROWBINARY":
        return read_rowbinary(path, schema, device=device)
    if f == "ROWBINARYWITHNAMESANDTYPES":
        return read_rowbinary(path, schema, with_names=True, device=device)
    if f == "VALUES":
        return read_values(path, schema, device=device)
    from myscaledb_tpu_torch.runtime import formats_extra as fx
    if f == "MSGPACK":
        return fx.read_msgpack(path, schema, device=device)
    if f == "AVRO":
        return fx.read_avro(path, schema, device=device)
    if f == "JSONCOMPACTEACHROW":
        return fx.read_jsoncompacteachrow(path, schema, device=device)
    if f == "TSKV":
        return fx.read_tskv(path, schema, device=device)
    if f == "JSONCOLUMNS":
        return fx.read_jsoncolumns(path, schema, device=device)
    if f == "LINEASSTRING":
        return fx.read_lineasstring(path, schema, device=device)
    if f == "REGEXP":
        return fx.read_regexp(path, schema, settings, device=device)
    if f in ("CUSTOMSEPARATED", "CUSTOMSEPARATEDWITHNAMES"):
        return fx.read_customseparated(
            path, schema, settings, with_names=f.endswith("WITHNAMES"),
            device=device)
    raise ValueError(f"unsupported input format {fmt!r}")


def write_file(table: Table, path: str, fmt: str,
               settings=None) -> int:
    f = normalize_format(fmt)
    if f == "CSV":
        return write_csv(table, path)
    if f in ("TSV", "TABSEPARATED"):
        return write_csv(table, path, delimiter="\t", header=False)
    if f in ("TSVWITHNAMES", "TABSEPARATEDWITHNAMES"):
        return write_csv(table, path, delimiter="\t")
    if f in ("TSVWITHNAMESANDTYPES", "TABSEPARATEDWITHNAMESANDTYPES"):
        return write_csv(table, path, delimiter="\t", types_header=True)
    if f == "CSVWITHNAMESANDTYPES":
        return write_csv(table, path, types_header=True)
    if f == "JSONEACHROW":
        return write_jsoneachrow(table, path)
    if f == "PARQUET":
        return write_parquet(table, path)
    if f == "ORC":
        return write_orc(table, path)
    if f == "ARROW":
        return write_arrow(table, path)
    if f == "ARROWSTREAM":
        return write_arrow(table, path, stream=True)
    if f == "NATIVE":
        return write_native(table, path)
    if f == "ROWBINARY":
        return write_rowbinary(table, path)
    if f == "ROWBINARYWITHNAMESANDTYPES":
        return write_rowbinary(table, path, with_names=True)
    if f == "VALUES":
        return write_values(table, path)
    if f in ("JSON", "JSONCOMPACT", "PRETTY", "PRETTYCOMPACT"):
        with open(path, "w") as fh:
            if f.startswith("JSON"):
                fh.write(format_json(table, compact=f == "JSONCOMPACT"))
            else:
                fh.write(format_pretty(table))
        return table.n_rows
    from myscaledb_tpu_torch.runtime import formats_extra as fx
    if f == "MSGPACK":
        return fx.write_msgpack(table, path)
    if f == "AVRO":
        return fx.write_avro(table, path)
    if f == "JSONCOMPACTEACHROW":
        return fx.write_jsoncompacteachrow(table, path)
    if f == "TSKV":
        return fx.write_tskv(table, path)
    if f == "VERTICAL":
        return fx.write_vertical(table, path)
    if f == "MARKDOWN":
        return fx.write_markdown(table, path)
    if f == "SQLINSERT":
        return fx.write_sqlinsert(table, path, table.name)
    if f == "JSONCOLUMNS":
        return fx.write_jsoncolumns(table, path)
    if f == "TEMPLATE":
        return fx.write_template(table, path, settings)
    if f in ("CUSTOMSEPARATED", "CUSTOMSEPARATEDWITHNAMES"):
        return fx.write_customseparated(table, path, settings,
                                        with_names=f.endswith("WITHNAMES"))
    raise ValueError(f"unsupported output format {fmt!r}")


INPUT_FORMATS = ["CSV", "CSVWithNames", "TSV", "TabSeparated",
                 "TSVWithNames", "TSVWithNamesAndTypes", "JSONEachRow",
                 "Parquet", "ORC", "Arrow", "ArrowStream", "Native",
                 "RowBinary", "RowBinaryWithNamesAndTypes", "Values",
                 "MsgPack", "Avro", "JSONCompactEachRow", "TSKV",
                 "JSONColumns", "LineAsString", "Regexp",
                 "CustomSeparated"]
OUTPUT_FORMATS = [f for f in INPUT_FORMATS
                  if f not in ("LineAsString", "Regexp")] + [
    "JSON", "JSONCompact", "Pretty", "PrettyCompact",
    "CSVWithNamesAndTypes", "Vertical", "Markdown", "SQLInsert",
    "Template"]
_INPUT_NORMS = frozenset(normalize_format(f) for f in INPUT_FORMATS)


# ---------------------------------------------------------------------------
# ClickHouse's value style for result cells: the golden harness's TSV
# (testing.run_golden_text) and the MySQL / PostgreSQL wire servers

def ch_cells(table: Table, escape: bool = False) -> list:
    """Render result rows as per-cell strings in ClickHouse's value style:
    shortest-roundtrip floats with integral values printed as integers,
    arrays as [1,2,3] / ['a','b'], dates ISO.

    escape=False (wire protocols with length framing, the MySQL text
    resultset and PostgreSQL DataRow): top-level strings stay raw and NULL
    is ``None``.  escape=True (ClickHouse's TabSeparated output, the
    format of the golden ``.reference`` files): tabs, newlines,
    backslashes and quotes escaped in top-level strings, NULL as ``\\N``.
    Array elements are escaped in both modes: they are part of the array
    literal."""
    import datetime as _dtm

    def fmt(v, f32=False, top=False):
        if v is None:
            return None if (top and not escape) else "\\N"
        if isinstance(v, (list, tuple, np.ndarray)):
            return "[" + ",".join(
                ("'" + str(e) + "'") if isinstance(e, str) else fmt(e, f32)
                for e in v) + "]"
        if isinstance(v, bool) or isinstance(v, np.bool_):
            return "true" if v else "false"
        if isinstance(v, (_dtm.datetime,)):
            return v.isoformat(sep=" ")
        if isinstance(v, _dtm.date):
            return v.isoformat()
        if isinstance(v, (float, np.floating)):
            return format_f32(v) if (f32 or isinstance(v, np.float32)) \
                else format_f64(float(v))
        if isinstance(v, str):
            if top and not escape:
                return v
            return (v.replace("\\", "\\\\").replace("\t", "\\t")
                    .replace("\n", "\\n").replace("'", "\\'"))
        return str(v)

    names = _names(table)
    plan = tuple_cell_plan(table, names)
    cols = {}
    for n in names:
        c = table[n]
        f32 = c.data.dtype in (torch.float32, np.float32) or \
            getattr(c.field, "vector_dim", 0)
        cols[n] = (c.to_python(), bool(f32))
    out = []
    for i in range(table.n_rows):
        row = []
        for kind, ref in plan:
            if kind == "col":
                vals, f32 = cols[ref]
                row.append(fmt(vals[i], f32, top=True))
            else:
                row.append("(" + ",".join(
                    fmt(cols[m][0][i], cols[m][1]) for m in ref) + ")")
        out.append(row)
    return out


def ch_tsv_lines(table: Table) -> list:
    """Result rows as the golden ``.reference`` files hold them: the
    escaped cells of ``ch_cells`` joined by tabs (``sql/format.format_tsv``
    prints strings raw)."""
    return ["\t".join(row) for row in ch_cells(table, escape=True)]
