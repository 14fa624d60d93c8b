"""Virtual system.* tables: the port of
myscaledb_tpu/runtime/system_tables.py (``build_system_table``), every
table it serves, built on demand from the session's state and the
runtime's counters, spans and query log, and queried through the normal
SQL path.
"""

from __future__ import annotations

import json

import numpy as np

from myscaledb_tpu_torch.core.table import Table
from myscaledb_tpu_torch.runtime import metrics as M
from myscaledb_tpu_torch.runtime import tracing

SYSTEM_TABLES = ("system.one", "system.tables", "system.columns",
                 "system.parts",
                 "system.settings", "system.events", "system.metrics",
                 "system.timings", "system.query_log", "system.span_log",
                 "system.vector_indices", "system.numbers",
                 "system.functions", "system.users", "system.roles",
                 "system.grants", "system.row_policies", "system.quotas",
                 "system.formats", "system.dictionaries",
                 "system.vector_index_event_log",
                 "system.vector_index_segments", "system.views")


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
        names, rows, ncols, dist = [], [], [], []
        for tname, t in session.tables.items():
            names.append(tname)
            rows.append(getattr(t, "real_rows", t.n_rows))
            ncols.append(len(t.column_names))
            dist.append(1 if getattr(t, "mesh", None) is not None else 0)
        return Table.from_dict({
            "database": ["default"] * len(names), "name": names,
            "total_rows": np.asarray(rows, dtype=np.int64),
            "total_columns": np.asarray(ncols, dtype=np.int64),
            "is_distributed": np.asarray(dist, dtype=np.uint8)},
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

    if name == "system.columns":
        tabs, cols, types = [], [], []
        for tname, t in session.tables.items():
            for f in t.schema():
                if f.name.startswith("__"):
                    continue
                tabs.append(tname)
                cols.append(f.name)
                types.append(str(f))
        return Table.from_dict({"table": tabs, "name": cols, "type": types},
                               device=dev)

    if name == "system.settings":
        items = sorted(vars(session.settings).items())
        return Table.from_dict({
            "name": [k for k, _ in items],
            "value": [json.dumps(v) if not isinstance(v, str) else v
                      for _, v in items]}, device=dev)

    if name in ("system.events", "system.metrics"):
        ev = sorted((M.events_snapshot() if name == "system.events"
                     else M.metrics_snapshot()).items())
        return Table.from_dict({
            name.split(".")[1][:-1]: [k for k, _ in ev],
            "value": np.asarray([v for _, v in ev], dtype=np.int64)},
            device=dev)

    if name == "system.timings":
        ev = sorted(tracing.timings_snapshot().items())
        return Table.from_dict({
            "name": [k for k, _ in ev],
            "seconds": np.asarray([v for _, v in ev], dtype=np.float64)},
            device=dev)

    if name == "system.vector_index_segments":
        # one row per (index, part segment), column set of
        # src/VectorIndex/Storages/StorageSystemVIsWithPart.cpp:43-57
        with session.vi_lock:
            idxs = [dict(i) for i in session.vector_indices]
        rows = []
        for i in idxs:
            t = session.tables.get(i["table"])
            nrows_tab = t.n_rows if t is not None else 0
            plist = session._table_parts.get(i["table"]) or (
                [nrows_tab] if nrows_tab else [])
            dim = 0
            if t is not None and i["column"] in t:
                dim = t[i["column"]].field.vector_dim or 0
            for pi, prows in enumerate(plist):
                pname = f"all_{pi + 1}_{pi + 1}_0"
                rows.append((i["table"], pname, pname, i["name"],
                             i["type"], dim, i["status"], prows))
        return Table.from_dict({
            "database": ["default"] * len(rows),
            "table": [r[0] for r in rows],
            "part": [r[1] for r in rows],
            "owner_part": [r[2] for r in rows],
            "owner_part_id": np.asarray([0] * len(rows), dtype=np.int32),
            "name": [r[3] for r in rows],
            "index_name": [r[3] for r in rows],   # back-compat alias
            "type": [r[4] for r in rows],
            "dimension": np.asarray([r[5] for r in rows], dtype=np.int32),
            "status": [r[6] for r in rows],
            "total_vectors": np.asarray([r[7] for r in rows],
                                        dtype=np.int64),
            "error": ["" for _ in rows]}, device=dev)

    if name == "system.functions":
        from myscaledb_tpu_torch.exec.expr import _FUNCS
        aggs = ["count", "sum", "min", "max", "avg", "any", "uniqExact",
                "argMin", "argMax", "countIf", "sumIf", "minIf", "maxIf",
                "avgIf", "quantile", "median"]
        wins = ["row_number", "rank", "dense_rank", "lag", "lead"]
        search = ["distance", "batch_distance", "L2Distance",
                  "cosineDistance", "dotProduct", "TextSearch",
                  "HybridSearch"]
        names = ([(f, "scalar") for f in sorted(_FUNCS.keys())] +
                 [(f, "aggregate") for f in aggs] +
                 [(f, "window") for f in wins] +
                 [(f, "search") for f in search])
        return Table.from_dict({"name": [n_ for n_, _ in names],
                                "kind": [k_ for _, k_ in names]},
                               device=dev)

    if name == "system.formats":
        from myscaledb_tpu_torch.runtime.formats import (INPUT_FORMATS,
                                                         OUTPUT_FORMATS)
        names_ = sorted(set(INPUT_FORMATS) | set(OUTPUT_FORMATS))
        return Table.from_dict({
            "name": names_,
            "is_input": np.asarray([n in INPUT_FORMATS for n in names_],
                                   dtype=np.uint8),
            "is_output": np.asarray([n in OUTPUT_FORMATS for n in names_],
                                    dtype=np.uint8)}, device=dev)

    if name == "system.query_log":
        entries = list(session.query_log)
        return Table.from_dict({
            "query": [e["query"] for e in entries],
            "event_time": np.asarray([e["event_time"] for e in entries],
                                     dtype=np.float64),
            "duration_ms": np.asarray([e["duration_ms"] for e in entries],
                                      dtype=np.float64),
            "result_rows": np.asarray([e["result_rows"] for e in entries],
                                      dtype=np.int64),
            "status": [e["status"] for e in entries],
            "error": [e["error"] for e in entries]}, device=dev)

    if name == "system.span_log":
        spans = tracing.span_log_snapshot()
        return Table.from_dict({
            "name": [s.name for s in spans],
            "trace_id": [tracing.hex_id(s.trace_id) for s in spans],
            "span_id": [tracing.hex_id(s.span_id) for s in spans],
            "parent_span_id": [tracing.hex_id(s.parent_span_id)
                               for s in spans],
            "start": np.asarray([s.start for s in spans], dtype=np.float64),
            "duration_us": np.asarray([s.duration_us for s in spans],
                                      dtype=np.int64),
            "attributes": [json.dumps(s.attributes) for s in spans]},
            device=dev)

    raise KeyError(f"unknown system table {name!r}")
