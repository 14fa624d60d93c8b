"""Virtual system.* tables: the port of ``system.one``,
``system.numbers``, ``system.parts``, ``system.vector_indices`` and
``system.data_skipping_indices`` from
myscaledb_tpu/runtime/system_tables.py (``build_system_table``), built on
demand from the session's state and queried through the normal SQL path.
Every other ``system.*`` name raises ``NotPortedError``.
"""

from __future__ import annotations

import numpy as np

from myscaledb_tpu_torch.core.table import Table
from myscaledb_tpu_torch.errors import NotPortedError

SYSTEM_TABLES = ("system.one", "system.parts", "system.vector_indices",
                 "system.numbers", "system.data_skipping_indices")


def build_system_table(session, name: str) -> Table:
    dev = session.device

    if name == "system.one":
        return Table.from_dict({"dummy": np.zeros(1, dtype=np.uint8)},
                               device=dev)

    if name == "system.numbers":
        # bounded materialization (the reference streams unbounded; use
        # numbers(N) for explicit ranges)
        return Table.from_dict({"number": np.arange(1 << 16,
                                                    dtype=np.uint64)},
                               device=dev)

    if name == "system.parts":
        # logical part set: one part per INSERT batch since the last
        # merge/OPTIMIZE (the reference's immutable-part model,
        # src/Storages/System/StorageSystemParts.cpp)
        parts = session._table_parts
        tabs, pnames, prow, act = [], [], [], []
        for tname, lst in sorted(parts.items()):
            if tname not in session.tables:
                continue
            for i, nrows in enumerate(lst):
                tabs.append(tname)
                pnames.append(f"all_{i + 1}_{i + 1}_0")
                prow.append(nrows)
                act.append(1)
        return Table.from_dict({
            "database": ["default"] * len(tabs),
            "table": tabs, "name": pnames,
            "rows": np.asarray(prow, dtype=np.int64),
            "active": np.asarray(act, dtype=np.uint8),
            "part_type": ["Wide"] * len(tabs),
            "path": [f"/var/lib/data/default/{t}/{p}/"
                     for t, p in zip(tabs, pnames)]}, device=dev)

    if name == "system.vector_indices":
        with session.vi_lock:
            idxs = [dict(i) for i in session.vector_indices]

        def _expr(i):
            base = f"{i['name']} {i['column']} TYPE {i['type']}"
            return base + (f"('{i['params']}')" if i.get("params") else "")

        parts = session._table_parts

        def _nparts(i):
            t = session.tables.get(i["table"])
            lst = parts.get(i["table"])
            if lst is not None:
                return len(lst)
            return 1 if (t is not None and t.n_rows) else 0

        return Table.from_dict({
            "database": ["default"] * len(idxs),
            "table": [i["table"] for i in idxs],
            "name": [i["name"] for i in idxs],
            "column": [i["column"] for i in idxs],
            "type": [i["type"] for i in idxs],
            "expr": [_expr(i) for i in idxs],
            "status": [i["status"] for i in idxs],
            # part accounting (StorageSystemVIs.cpp columns): every part of
            # a Built index is indexed; no decouple/small split here
            "total_parts": np.asarray([_nparts(i) for i in idxs],
                                      dtype=np.int64),
            "parts_with_vector_index":
                np.asarray([_nparts(i) if i["status"] == "Built" else 0
                            for i in idxs], dtype=np.int64),
            "small_parts": np.asarray([0] * len(idxs), dtype=np.int64),
            "latest_failed_part": ["" for _ in idxs],
            "latest_fail_reason": ["" for _ in idxs],
        }, device=dev)

    if name == "system.data_skipping_indices":
        # reference: src/Storages/System/StorageSystemDataSkippingIndices.cpp
        tabs, names, cols, types, exprs, grans = [], [], [], [], [], []
        for tname, defs in sorted(session._table_skip_indexes.items()):
            for d in defs:
                tabs.append(tname)
                names.append(d.name)
                cols.append(d.column)
                types.append(d.kind)
                exprs.append(f"{d.kind}({d.param:g})" if d.param else d.kind)
                grans.append(d.granularity)
        return Table.from_dict({
            "table": tabs, "name": names, "column": cols, "type": types,
            "type_full": exprs,
            "granularity": np.asarray(grans, dtype=np.int64)}, device=dev)

    raise NotPortedError(f"system table {name}",
                         "storage, formats and runtime state")
