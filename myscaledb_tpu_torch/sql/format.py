"""Copy of myscaledb_tpu/sql/format.py (JAX-free; imports renamed to this package).

ClickHouse-compatible TSV result formatting (golden-file compatibility).

Float32 values print as their shortest round-tripping decimal (ClickHouse
uses the same convention: 0.030000001, 2.4299998, 104.43001); integers plain;
Array(Float32) as [v1,v2,...]; tuple columns (batch_distance) as (q,d);
NULL as \\N.
"""

from __future__ import annotations

import numpy as np

from myscaledb_tpu_torch.core.types import DataType
from myscaledb_tpu_torch.core.table import Table


def _ch_exp_style(s: str) -> str:
    """double-conversion/ClickHouse exponent style: no '+', no leading
    zeros — 1.1920929e-07 -> 1.1920929e-7, 4e+21 -> 4e21."""
    import re
    return re.sub(r"e\+?(-?)0*(\d)", r"e\1\2", s)


def format_f32(v) -> str:
    f = np.float32(v)
    if np.isnan(f):
        return "nan"
    if np.isinf(f):
        return "inf" if f > 0 else "-inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    s = np.format_float_positional(f, unique=True, trim="-")
    # scientific for very small/large like ClickHouse (1.1920929e-7 but
    # 0.00008100271 positional — threshold calibrated on the goldens)
    if abs(f) < 1e-5 or abs(f) >= 1e15:
        s = _ch_exp_style(np.format_float_scientific(f, unique=True,
                                                     trim="-"))
    return s


def format_f64(v) -> str:
    f = float(v)
    if f != f:
        return "nan"
    if f in (float("inf"), float("-inf")):
        return "inf" if f > 0 else "-inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    s = np.format_float_positional(f, unique=True, trim="-")
    if abs(f) < 1e-5 or abs(f) >= 1e15:
        s = _ch_exp_style(np.format_float_scientific(f, unique=True,
                                                     trim="-"))
    return s


def _quote_str(s: str) -> str:
    return "'" + s.replace("\\", "\\\\").replace("'", "\\'") + "'"


def format_array(v, elem: DataType) -> str:
    """ClickHouse array rendering: [1,2,3] / ['a','b'] (strings quoted)."""
    if v is None:
        return "\\N"
    inner = []
    for x in v:
        if isinstance(x, str):
            inner.append(_quote_str(x))
        elif elem in (DataType.DATE, DataType.DATETIME):
            inner.append("'" + format_value(x, elem) + "'")
        elif elem is DataType.FLOAT32:
            inner.append(format_f32(x))
        elif elem is DataType.FLOAT64 or (elem is None
                                          and isinstance(x, float)):
            inner.append(format_f64(x))
        elif isinstance(x, bool):
            inner.append("true" if x else "false")
        else:
            inner.append(str(x))
    return "[" + ",".join(inner) + "]"


def format_value(v, dtype: DataType) -> str:
    if v is None:
        return "\\N"
    if dtype is DataType.DATE:
        from myscaledb_tpu_torch.exec.datetime_fns import format_date
        return format_date(v)
    if dtype is DataType.DATETIME:
        from myscaledb_tpu_torch.exec.datetime_fns import format_datetime
        return format_datetime(v)
    if dtype is DataType.ARRAY or isinstance(v, list):
        return format_array(v, DataType.INT64 if not isinstance(v, list)
                            else None)
    if dtype is DataType.FLOAT32:
        return format_f32(v)
    if dtype is DataType.FLOAT64:
        return format_f64(v)
    if dtype is DataType.FLOAT32_VECTOR:
        return "[" + ",".join(format_f32(x) for x in v) + "]"
    if dtype is DataType.BOOL:
        return "true" if v else "false"
    if dtype is DataType.STRING:
        return str(v)
    return str(v)


def tuple_cell_plan(table: Table, names: list) -> list:
    """Column emission plan for a TSV row: ("col", name), or ("tuple",
    members) where the members of a tuple group (batch_distance's
    (q, dist) pair) collapse into one "(a,b)" cell at the position of
    their first member."""
    tuple_groups: dict = getattr(table, "tuple_groups", {}) or {}
    member_to_group = {m: g for g, ms in tuple_groups.items() for m in ms}
    plan = []
    emitted = set()
    for n in names:
        g = member_to_group.get(n)
        if g is None:
            plan.append(("col", n))
        elif g not in emitted:
            plan.append(("tuple", [m for m in tuple_groups[g]
                                   if m in table]))
            emitted.add(g)
    return plan


def format_tsv(table: Table) -> str:
    """Render a result Table as ClickHouse-style TSV (one line per row)."""
    cols = list(table.columns.values())
    pycols = {c.name: c.to_python() for c in cols}
    dtypes = {c.name: c.dtype for c in cols}
    fields = {c.name: c.field for c in cols}
    plan = tuple_cell_plan(table, [c.name for c in cols])

    lines = []
    for i in range(table.n_rows):
        cells = []
        for kind, ref in plan:
            if kind == "col":
                if dtypes[ref] is DataType.ARRAY:
                    cells.append(format_array(pycols[ref][i],
                                              fields[ref].elem))
                else:
                    cells.append(format_value(pycols[ref][i], dtypes[ref]))
            else:
                inner = ",".join(format_value(pycols[m][i], dtypes[m])
                                 for m in ref)
                cells.append("(" + inner + ")")
        lines.append("\t".join(cells))
    body = "\n".join(lines)
    totals = getattr(table, "totals", None)
    if totals is not None and totals.n_rows:
        # ClickHouse TSV prints the totals row after one empty line
        body += "\n\n" + format_tsv(totals)
    return body
