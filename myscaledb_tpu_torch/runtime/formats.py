"""ClickHouse TSV lines for result tables: the port of ``ch_tsv_lines``
and its cell escapes from myscaledb_tpu/runtime/formats.py, the writer the
golden harness (``testing.run_golden_text``) renders results with.  It is
not ``sql/format.format_tsv``: the golden ``.reference`` files escape
tabs, newlines, backslashes and quotes in strings and quote the strings
inside arrays, as ClickHouse's TabSeparated output does, and
``format_tsv`` prints strings raw.  The rest of that module (file
formats, readers and writers) is not ported yet.
"""

from __future__ import annotations

import datetime as _dtm

import numpy as np
import torch

from myscaledb_tpu_torch.core.table import Table
from myscaledb_tpu_torch.sql.format import (format_f32, format_f64,
                                            tuple_cell_plan)


def _cell(v, f32=False) -> str:
    """One value in ClickHouse's TSV value style: shortest-roundtrip
    floats, arrays as [1,2,3] / ['a','b'], NULL as \\N, dates ISO."""
    if v is None:
        return "\\N"
    if isinstance(v, (list, tuple, np.ndarray)):
        return "[" + ",".join(
            ("'" + str(e) + "'") if isinstance(e, str) else _cell(e, f32)
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
        return (v.replace("\\", "\\\\").replace("\t", "\\t")
                .replace("\n", "\\n").replace("'", "\\'"))
    return str(v)


def ch_tsv_lines(table: Table) -> list:
    """Render result rows in ClickHouse's default TSV value style (the
    format of the golden `.reference` files): shortest-roundtrip floats
    with integral values printed as integers, arrays as [1,2,3] /
    ['a','b'], NULL as \\N, dates ISO."""
    names = [n for n in table.column_names if not n.startswith("__")]
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
                row.append(_cell(vals[i], f32))
            else:
                row.append("(" + ",".join(
                    _cell(cols[m][0][i], cols[m][1]) for m in ref) + ")")
        out.append("\t".join(row))
    return out
