"""User-facing session: the port of myscaledb_tpu/session.py (``Session``,
``connect``, ``drop_table``).

A Session owns its registered tables, per-session Settings, access control
and the per-(table, column, epoch) vector-scan sidecars, and it owns the
device every tensor of the session lives on: ``connect()`` means the CUDA
card, and a caller that wants the CPU says so with ``device="cpu"``.  The
DDL statements (sql/ddl.py) keep their state here too: the logical part
list of each table, detached tables, vector index definitions and their
lifecycle events, constraints, order and partition keys, row TTLs,
skip-index definitions, Join/Set engine keys and aggregate projections;
views, materialized views and dictionaries.  ``get_table`` runs a view's
SELECT where the view is read and refreshes a File/URL/S3/FileLog table
from its source; ``system.*`` names resolve through
runtime/system_tables.py.  ``distribute`` splits a table's rows over a
mesh of shards (parallel/).  ``import_file`` / ``export_file`` move rows
through the file formats (runtime/formats.py), ``backup`` / ``restore``
through on-disk parts (runtime/backup.py).

Index builds may run on the background executor's thread: the index list
is guarded by ``vi_lock``, the derived-state dict by ``sidecar_lock``.
The wire servers (runtime/server.py and its siblings) share one session
and run every statement through ``sql_as``, under ``exec_lock``: one
statement at a time, as the user its connection authenticated.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Optional

import torch

from myscaledb_tpu_torch.config import Settings, TableSettings
from myscaledb_tpu_torch.core.table import Table
from myscaledb_tpu_torch.runtime import tracing
from myscaledb_tpu_torch.runtime.access import AccessControl


class Session:
    def __init__(self, settings: Optional[Settings] = None, *, device):
        self.device = torch.device(device)
        self.settings = settings or Settings()
        self.tables: dict[str, Table] = {}
        self.table_settings: dict[str, TableSettings] = {}
        self.query_log = deque(maxlen=10_000)
        self._mutation_epoch = 0
        self._query_cache = {}
        # state derived from a column, per (kind, table, column, epoch):
        # squared norms, the SQ8 sidecar, packed binary words, the BM25
        # index (core/derived.py::derived_state)
        self._derived = {}
        self.sidecar_lock = threading.Lock()
        self.access = AccessControl()
        self.current_user = "default"
        self.exec_lock = threading.RLock()
        # DDL state (sql/ddl.py)
        self.vector_indices: list[dict] = []
        self.vi_events = deque(maxlen=10_000)
        self.vi_lock = threading.Lock()
        self._table_parts: dict[str, list] = {}
        self._table_order_keys: dict[str, list] = {}
        self._table_constraints: dict[str, dict] = {}
        self._table_partition_keys: dict[str, list] = {}
        self._table_ttls: dict[str, object] = {}
        self._table_skip_indexes: dict[str, list] = {}
        self._detached: dict[str, tuple] = {}
        self._merges_stopped: set = set()
        self._bg_merge_pending: set = set()
        # views, materialized views ({source, sql, target}), dictionaries,
        # Join/Set engine metadata and aggregate projections
        self.views: dict[str, str] = {}
        self.materialized_views: dict[str, dict] = {}
        self.dictionaries: dict = {}
        self._table_engines: dict[str, dict] = {}
        self._projections: dict[str, dict] = {}

    def read_table_checked(self, name: str) -> Table:
        """get_table + SELECT-privilege check + row-policy filtering for the
        current user."""
        t = self.get_table(name)
        if name.startswith("system."):
            return t
        return self.checked_read(name, t)

    def checked_read(self, name: str, t: Table) -> Table:
        """``t`` as the current user may read table ``name``: the SELECT
        privilege checked, the row policies on ``name`` applied."""
        self.access.check(self.current_user, "SELECT", name)
        has_pol, exprs = self.access.row_policy_exprs(self.current_user, name)
        if not has_pol:
            return t
        if not exprs:
            return t.head(0)
        from myscaledb_tpu_torch.exec.expr import Env, eval_expr, \
            as_bool_mask
        from myscaledb_tpu_torch.ops.filter import compact_table_host
        env = Env(t, device=self.device)
        mask = None
        for e in exprs:   # permissive policies: union of matching rows
            m = as_bool_mask(eval_expr(e, env), t.n_rows)
            mask = m if mask is None else mask | m
        out, _ = compact_table_host(t, mask)
        out.name = name
        return out

    def bump_epoch(self) -> None:
        """Any mutation invalidates cached query results."""
        self._mutation_epoch += 1
        self._query_cache.clear()

    def get_table(self, name: str) -> Table:
        """Resolve a table name: registered tables first, then the virtual
        system.* tables built from live state."""
        if name in self.tables:
            if name in self._table_engines:
                from myscaledb_tpu_torch.sql.ddl import \
                    refresh_external_table
                refresh_external_table(self, name)
            return self.tables[name]
        if name.startswith("system."):
            from myscaledb_tpu_torch.runtime.system_tables import \
                build_system_table
            t = build_system_table(self, name)
            t.name = name
            return t
        if name in self.views:
            # a plain view runs its SELECT where it is read (StorageView)
            t = self.sql(self.views[name])
            t.name = name
            return t
        raise KeyError(f"unknown table {name!r}")

    def distribute(self, name: str, mesh=None) -> Table:
        """Convert a registered table to a row-split distributed table over
        a mesh (the StorageDistributed analog): ``mesh`` from
        ``parallel.mesh.make_mesh``; None means one shard per visible
        device of the session's kind (one on the session's own device when
        it is not a CUDA card)."""
        from myscaledb_tpu_torch.parallel.mesh import make_mesh
        from myscaledb_tpu_torch.parallel.dist_table import distribute_table
        if mesh is None:
            mesh = make_mesh(device=None if self.device.type == "cuda"
                             else self.device)
        t = distribute_table(self.tables[name], mesh)
        self.tables[name] = t
        self.bump_epoch()
        return t

    def drop_table(self, name: str) -> None:
        """Forget a table with its settings, parts, constraints, order and
        partition keys, TTL, skip and vector index definitions, engine
        keys and projections."""
        self.tables.pop(name, None)
        self.table_settings.pop(name, None)
        for state in (self._table_parts, self._table_constraints,
                      self._table_order_keys, self._table_partition_keys,
                      self._table_ttls, self._table_skip_indexes,
                      self._table_engines, self._projections):
            state.pop(name, None)
        # index definitions die with the table
        with self.vi_lock:
            self.vector_indices[:] = [i for i in self.vector_indices
                                      if i["table"] != name]
        with self.sidecar_lock:
            self._derived = {k: v for k, v in self._derived.items()
                             if k[1] != name}

    def text_index(self, table: str, column: str):
        """The BM25 index that TextSearch and HybridSearch read for
        ``table.column``, built on first use and kept until the table
        changes."""
        from myscaledb_tpu_torch.sql.executor import _get_text_index
        return _get_text_index(self, table, self.read_table_checked(table),
                               column)

    def register(self, name: str, table: Table, settings=None) -> None:
        table.name = name
        self.tables[name] = table
        if settings is not None:
            self.table_settings[name] = settings
        self.bump_epoch()

    def import_file(self, table_name: str, path: str, format: str = "CSV",
                    **kw) -> int:
        """Load a file into an existing table (schema from the table
        definition) through the INSERT path every INSERT takes
        (``ddl.insert_block``: partition clustering, zone maps, one part,
        the materialized views); returns rows inserted.  CSV/TSV take
        ``delimiter``/``has_header`` keywords."""
        from myscaledb_tpu_torch.runtime import formats
        from myscaledb_tpu_torch.sql.ddl import insert_block
        t = self.tables[table_name]
        schema = [f for f in t.schema() if not f.name.startswith("__")]
        if format.upper() in ("CSV", "TSV") and kw:
            new = formats.read_csv(path, schema,
                                   delimiter="\t" if format.upper() == "TSV"
                                   else ",", **kw, device=self.device)
        else:
            new = formats.read_file(path, format, schema,
                                    settings=self.settings,
                                    device=self.device)
        n = insert_block(self, table_name, new.select(
            [c for c in t.column_names if c in new.column_names]))
        self.bump_epoch()
        return n

    def export_file(self, query: str, path: str, format: str = "CSV") -> int:
        """Run ``query`` and write its rows to ``path``; returns rows."""
        from myscaledb_tpu_torch.runtime import formats
        return formats.write_file(self.sql(query), path, format)

    def backup(self, path: str, tables=None) -> dict:
        """Write tables (all, or the given names) with their settings and
        vector-index registrations to the directory ``path``."""
        from myscaledb_tpu_torch.runtime.backup import backup_session
        return backup_session(self, path, tables)

    def restore(self, path: str) -> list:
        """Register the tables of a backup; returns their names."""
        from myscaledb_tpu_torch.runtime.backup import restore_session
        return restore_session(self, path)

    def create_table(self, name: str, data: dict, dtypes=None,
                     settings=None) -> Table:
        t = Table.from_dict(data, name=name, dtypes=dtypes,
                            hbm_budget_bytes=self.settings
                            .max_hbm_bytes_per_column, device=self.device)
        self.register(name, t, settings)
        return t

    def sql(self, query: str, **params) -> Table:
        """Parse, plan and execute a SQL query; returns a result Table."""
        from myscaledb_tpu_torch.sql.driver import execute_query
        return execute_query(self, query, params)

    def sql_as(self, user: Optional[str], query: str) -> Table:
        """Run ``query`` as ``user`` (None: the session's own user) under
        ``exec_lock``, and restore the session's user after it.  The wait
        for the lock is the statement's ``lock_wait`` span."""
        with tracing.statement():
            with tracing.span("lock_wait"):
                self.exec_lock.acquire()
            try:
                if user is None:
                    return self.sql(query)
                prev = self.current_user
                self.current_user = user
                try:
                    return self.sql(query)
                finally:
                    self.current_user = prev
            finally:
                self.exec_lock.release()

    def sql_tsv(self, query: str) -> str:
        """Execute and format as ClickHouse-style TSV."""
        from myscaledb_tpu_torch.sql.format import format_tsv
        return format_tsv(self.sql(query))


def connect(settings: Optional[Settings] = None, device=None) -> Session:
    """Open a session on ``device`` — the CUDA card unless the caller asks
    for another device.  Without a CUDA device, ``connect()`` raises rather
    than run on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            from myscaledb_tpu_torch.errors import NoDeviceError
            raise NoDeviceError(
                "myscaledb_tpu_torch.connect(): no CUDA device is available; "
                "pass device=\"cpu\" to run on the CPU")
        device = "cuda"
    return Session(settings, device=device)
