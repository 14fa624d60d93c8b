"""Virtual system.* tables: the port of ``system.one``,
``system.numbers``, ``system.parts``, ``system.vector_indices``,
``system.data_skipping_indices``, ``system.tables``, ``system.views``,
``system.dictionaries``, ``system.vector_index_event_log`` and the access
tables (``system.users``, ``roles``, ``grants``, ``row_policies``,
``quotas``) from
myscaledb_tpu/runtime/system_tables.py (``build_system_table``), built on
demand from the session's state and queried through the normal SQL path.
Every other ``system.*`` name raises ``NotPortedError``.
"""

from __future__ import annotations

import json

import numpy as np

from myscaledb_tpu_torch.core.table import Table
from myscaledb_tpu_torch.errors import NotPortedError

SYSTEM_TABLES = ("system.one", "system.parts", "system.vector_indices",
                 "system.numbers", "system.data_skipping_indices",
                 "system.tables", "system.views", "system.dictionaries",
                 "system.vector_index_event_log", "system.users",
                 "system.roles", "system.grants", "system.row_policies",
                 "system.quotas")


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

    if name == "system.tables":
        names, rows, ncols = [], [], []
        for tname, t in session.tables.items():
            names.append(tname)
            rows.append(t.n_rows)
            ncols.append(len(t.column_names))
        return Table.from_dict({
            "database": ["default"] * len(names), "name": names,
            "total_rows": np.asarray(rows, dtype=np.int64),
            "total_columns": np.asarray(ncols, dtype=np.int64),
            "is_distributed": np.zeros(len(names), dtype=np.uint8)},
            device=dev)

    if name == "system.views":
        vs = [(n, sql, "View") for n, sql in session.views.items()] + \
             [(n, mv["sql"], "MaterializedView")
              for n, mv in session.materialized_views.items()]
        return Table.from_dict({"name": [v[0] for v in vs],
                                "as_select": [v[1] for v in vs],
                                "engine": [v[2] for v in vs]}, device=dev)

    if name == "system.dictionaries":
        ds = sorted(session.dictionaries.values(), key=lambda d: d.name)
        return Table.from_dict({
            "name": [d.name for d in ds], "key": [d.key_name for d in ds],
            "layout": [d.layout for d in ds],
            "source": [d.source_desc for d in ds],
            "element_count": np.asarray([d.n_rows for d in ds],
                                        dtype=np.int64)}, device=dev)

    if name == "system.vector_index_event_log":
        evs = list(session.vi_events)
        return Table.from_dict({
            "event_time": np.asarray([e["event_time"] for e in evs],
                                     dtype=np.float64),
            "table": [e["table"] for e in evs],
            "index_name": [e["index_name"] for e in evs],
            "event_type": [e["event_type"] for e in evs]}, device=dev)

    ac = session.access
    if name == "system.users":
        users = sorted(ac.users.values(), key=lambda u: u.name)
        return Table.from_dict({
            "name": [u.name for u in users],
            "auth_type": ["sha256_password" if u.password_hash else
                          "no_password" for u in users],
            "default_roles": [",".join(sorted(u.roles)) for u in users]},
            device=dev)

    if name == "system.roles":
        return Table.from_dict({"name": sorted(ac.roles.keys())}, device=dev)

    if name == "system.grants":
        rows = [(u.name, "user", p, t) for u in ac.users.values()
                for p, t in sorted(u.grants)] + \
               [(r.name, "role", p, t) for r in ac.roles.values()
                for p, t in sorted(r.grants)]
        return Table.from_dict({
            "grantee": [r[0] for r in rows],
            "grantee_type": [r[1] for r in rows],
            "access_type": [r[2] for r in rows],
            "table": [r[3] for r in rows]}, device=dev)

    if name == "system.row_policies":
        ps = ac.row_policies
        return Table.from_dict({
            "name": [p.name for p in ps], "table": [p.table for p in ps],
            "select_filter": [p.using_sql for p in ps],
            "apply_to": ["ALL" if p.to_users is None else
                         ",".join(sorted(p.to_users)) for p in ps]},
            device=dev)

    if name == "system.quotas":
        qs = sorted(ac.quotas.values(), key=lambda q: q.name)
        return Table.from_dict({
            "name": [q.name for q in qs],
            "interval_seconds": np.asarray([q.interval_s for q in qs],
                                           dtype=np.float64),
            "limits": [json.dumps(q.limits) for q in qs],
            "apply_to": ["ALL" if q.to_users is None else
                         ",".join(sorted(q.to_users)) for q in qs]},
            device=dev)

    raise NotPortedError(f"system table {name}",
                         "storage, formats and runtime state")
