"""Distributed (row-partitioned) tables over a mesh: the port of
myscaledb_tpu/parallel/dist_table.py.

A distributed table is a Table whose every column holds a ``RowSplit``:
shard p's rows [p * n_loc, (p + 1) * n_loc) of the padded table are a
tensor of their own on ``mesh.device(p)`` (its validity too), whether or
not two shards share a card.  The attributes ``mesh``, ``mesh_axis`` and
``real_rows`` mark it.  A hidden ``__row_valid__`` column masks the
padding out of every operator.  An ARRAY column keeps its host row
offsets whole, and each shard's elements as its part.

The executor evaluates a statement's WHERE mask and the operands of the
shard-routed operators (parallel/ops.py, parallel/shuffle.py,
text/distributed.py) per shard, over ``shard_table(t, p)``, on the
shard's card; anything else reads the rows the shards kept, gathered to
``mesh.device(0)`` by ``gather_table`` or ``take_rows``.
"""

from __future__ import annotations

import numpy as np
import torch

from myscaledb_tpu_torch.core.table import Column, Table, to_tensor
from myscaledb_tpu_torch.core.types import DataType, Field
from myscaledb_tpu_torch.errors import ExecError
from myscaledb_tpu_torch.parallel.mesh import SHARD_AXIS, Mesh, RowSplit

ROW_VALID = "__row_valid__"


def is_distributed(table) -> bool:
    return getattr(table, "mesh", None) is not None


def _set_mesh(table: Table, mesh: Mesh, axis: str, real_rows: int) -> Table:
    table.mesh = mesh
    table.mesh_axis = axis
    table.real_rows = int(real_rows)
    return table


def _on(data, dev) -> torch.Tensor:
    return data.to(dev) if isinstance(data, torch.Tensor) \
        else to_tensor(data, dev)


def _split(mesh: Mesh, t: torch.Tensor, n_loc: int, pad: int,
           fill=0) -> RowSplit:
    """Rows of ``t`` (any device) padded with ``pad`` rows of ``fill``, as
    one part of ``n_loc`` rows per shard on the shard's device."""
    parts = []
    n = t.shape[0]
    for p in range(mesh.size):
        dev = mesh.device(p)
        lo, hi = min(p * n_loc, n), min((p + 1) * n_loc, n)
        part = t[lo:hi].to(dev, copy=True)
        if hi - lo < n_loc:
            tail = torch.full((n_loc - (hi - lo),) + tuple(t.shape[1:]),
                              fill, dtype=t.dtype, device=dev)
            part = torch.cat([part, tail])
        parts.append(part)
    return RowSplit(parts)


def _split_elements(mesh: Mesh, flat: torch.Tensor, off: np.ndarray,
                    n_loc: int) -> RowSplit:
    """An ARRAY column's elements split by the rows that own them: shard
    p's part holds the elements of its rows (``off`` already padded)."""
    return RowSplit([flat[int(off[p * n_loc]):int(off[(p + 1) * n_loc])]
                     .to(mesh.device(p), copy=True)
                     for p in range(mesh.size)])


def distribute_table(table: Table, mesh: Mesh,
                     axis: str = SHARD_AXIS) -> Table:
    """Pad rows to a multiple of the mesh and place each shard's rows of
    every column on its shard's device (a host-resident column moves
    there, as the JAX package's ``device_put`` moves it); padding rows
    are invalid in ``__row_valid__``."""
    nsh = mesh.shape[axis]
    n = table.n_rows
    n_loc = -(-n // nsh)
    pad = n_loc * nsh - n
    cols = []
    for c in table.columns.values():
        if isinstance(c.data, RowSplit):
            raise ExecError(f"table {table.name!r} is distributed already")
        data = c.data if isinstance(c.data, torch.Tensor) \
            else to_tensor(c.data, "cpu")
        valid = None if c.valid is None else \
            _split(mesh, _on(c.valid, data.device).bool(), n_loc, pad, False)
        if c.offsets is not None:
            # padding rows hold empty arrays
            off = np.asarray(c.offsets, dtype=np.int64)
            off = np.concatenate([off, np.full(pad, off[-1], np.int64)])
            cols.append(Column(c.field, _split_elements(mesh, data, off,
                                                        n_loc),
                               valid, c.dictionary, None, off))
            continue
        cols.append(Column(c.field, _split(mesh, data, n_loc, pad), valid,
                           c.dictionary, None))
    rv = _split(mesh, torch.ones(n, dtype=torch.bool), n_loc, pad, False)
    cols.append(Column(Field(ROW_VALID, DataType.BOOL), rv))
    return _set_mesh(Table(cols, name=table.name), mesh, axis, n)


def _shard_column(c: Column, p: int, n_loc: int) -> Column:
    valid = None if c.valid is None else c.valid.parts[p]
    if c.offsets is None:
        return Column(c.field, c.data.parts[p], valid, c.dictionary, None)
    off = np.asarray(c.offsets, dtype=np.int64)[p * n_loc:(p + 1) * n_loc
                                                 + 1]
    return Column(c.field, c.data.parts[p], valid, c.dictionary, None,
                  off - off[0])


def shard_table(table: Table, p: int) -> Table:
    """Shard p's rows of a distributed table as a plain Table on its
    device (the parts themselves, no copy; ``__row_valid__`` included)."""
    n_loc = table.n_rows // table.mesh.size
    return Table([_shard_column(c, p, n_loc)
                  for c in table.columns.values()], name=table.name)


def shard_tables(table: Table) -> list:
    return [shard_table(table, p) for p in range(table.mesh.size)]


def _gather_column(c: Column, p_rows: list, n_loc: int, dev) -> Column:
    """Column ``c``'s rows ``p_rows[p]`` (local ids on shard p's device;
    None: none) of every shard, concatenated in shard order on ``dev``."""
    def cat(split):
        got = [split.parts[p].index_select(0, r).to(dev)
               for p, r in enumerate(p_rows) if r is not None]
        return torch.cat(got) if got else \
            split.parts[0][:0].to(dev)
    valid = None if c.valid is None else cat(c.valid)
    if c.offsets is None:
        return Column(c.field, cat(c.data), valid, c.dictionary, None)
    p_rows = [torch.zeros(0, dtype=torch.int64, device=c.data.parts[p]
                          .device) if r is None else r
              for p, r in enumerate(p_rows)]
    parts, offs, base = [], [np.zeros(1, dtype=np.int64)], 0
    for p, r in enumerate(p_rows):
        sc = _shard_column(c, p, n_loc).take_ragged(r.cpu().numpy())
        parts.append(sc.data.to(dev))
        o = np.asarray(sc.offsets, dtype=np.int64)
        offs.append(o[1:] + base)
        base += int(o[-1])
    return Column(c.field, torch.cat(parts), valid, c.dictionary, None,
                  np.concatenate(offs))


def _gather(table: Table, p_rows: list, names=None) -> Table:
    mesh = table.mesh
    n_loc = table.n_rows // mesh.size
    dev = mesh.device(0)
    keep = [c for c in table.columns.values() if c.name != ROW_VALID and
            (names is None or c.name in names)]
    if not keep:
        # nothing read but the row count: the validity column carries it
        keep = [table[ROW_VALID]]
    return Table([_gather_column(c, p_rows, n_loc, dev) for c in keep],
                 name=table.name)


def gather_table(table: Table, masks=None, names=None) -> Table:
    """The rows each shard keeps (``masks[p]`` and the shard's real rows),
    of the columns ``names`` (None: all), concatenated in shard order as
    a plain Table on ``mesh.device(0)``: the global row order without the
    padding.  ``__row_valid__`` stays only where no other column is
    read."""
    rv = table[ROW_VALID].data.parts
    p_rows = []
    for p, r in enumerate(rv):
        m = r if masks is None or masks[p] is None else masks[p] & r
        p_rows.append(torch.nonzero(m).flatten())
    return _gather(table, p_rows, names)


def take_rows(table: Table, gids, names=None) -> Table:
    """Rows of a distributed table by global (padded) row id, in the order
    given, as a plain Table on ``mesh.device(0)``: each shard gathers its
    own rows on its card and the pieces are put back in order there."""
    mesh = table.mesh
    n_loc = table.n_rows // mesh.size
    dev = mesh.device(0)
    gids = torch.as_tensor(gids, device=dev).long().reshape(-1)
    shard = torch.div(gids, max(n_loc, 1), rounding_mode="floor")
    order = torch.sort(shard, stable=True).indices
    counts = torch.bincount(shard, minlength=mesh.size).cpu().tolist()
    sg = gids[order]
    p_rows, start = [], 0
    for p, cnt in enumerate(counts):
        # a shard none of whose rows is asked for gathers nothing
        p_rows.append((sg[start:start + cnt] - p * n_loc)
                      .to(mesh.device(p)) if cnt else None)
        start += cnt
    got = _gather(table, p_rows, names)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], device=dev)
    return got.take(inv)


def route_rows(key, m: int, nsh: int, dev) -> torch.Tensor:
    """Destination shard (m,) int64 of each new row: ``hash32(key) % nsh``
    for a key Column stored as integers (a String column's dictionary ids
    among them, as in the JAX package), else round-robin."""
    from myscaledb_tpu_torch.ops.hash import hash32
    if key is not None and key.offsets is None and \
            key.dtype is not DataType.BOOL:
        data = _on(key.data, dev)
        if not data.is_floating_point():
            if key.dtype is DataType.UINT32:
                data = data.to(torch.int32)   # the 32-bit values hash32 reads
            return hash32(data) % nsh
    return torch.arange(m, dtype=torch.int64, device=dev) % nsh


def insert_distributed(existing: Table, new: Table,
                       shard_key: str | None = None) -> Table:
    """Append rows to a distributed table without resharding the resident
    rows (the reference's DistributedSink: a block is split by the
    sharding key and each part sent to its shard).  New rows route by the
    hash of ``shard_key`` (when given and integer-typed) or round-robin;
    each shard's part grows on its own card: shard p's rows become its old
    rows, then its new rows, then padding.  Global row order becomes
    shard-major, as in the reference, where per-shard local tables have
    no global order.  Zone maps are dropped."""
    mesh = existing.mesh
    axis = existing.mesh_axis
    nsh = mesh.shape[axis]
    m = new.n_rows
    if m == 0:
        return existing
    src = new.device if new.device is not None else mesh.device(0)
    key = new[shard_key] if shard_key and shard_key in new else None
    dest = route_rows(key, m, nsh, src)
    order = torch.sort(dest, stable=True).indices
    counts = torch.bincount(dest, minlength=nsh).cpu().tolist()
    cap_old = existing.n_rows // nsh
    cap = cap_old + max(counts)
    # shard p's new rows: order[starts[p] : starts[p] + counts[p]]
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).tolist()

    def grow(old: RowSplit, fresh: torch.Tensor) -> RowSplit:
        fresh = fresh[order]
        parts = []
        for p in range(nsh):
            dev = mesh.device(p)
            mine = fresh[starts[p]:starts[p] + counts[p]].to(dev)
            pad = torch.zeros((cap - cap_old - counts[p],) +
                              tuple(mine.shape[1:]), dtype=mine.dtype,
                              device=dev)
            parts.append(torch.cat([old.parts[p], mine.to(old.dtype), pad]))
        return RowSplit(parts)

    cols = []
    for c in existing.columns.values():
        if c.name == ROW_VALID:
            continue
        if c.offsets is not None:
            raise ExecError("INSERT into a distributed table with ARRAY "
                            f"column {c.name!r} is not supported")
        nc = new[c.name]
        nd = _on(nc.data, src)
        dictionary = c.dictionary
        if dictionary is not None and nc.dictionary is not dictionary:
            # re-encode through (a copy of) the existing dictionary
            dictionary = dictionary.copy()
            remap = dictionary.merge_from(nc.dictionary)
            lut = to_tensor(np.append(remap, -1).astype(np.int64), src)
            nd = torch.where(nd < 0, nd.to(torch.int64), lut[nd.long()])
        data = grow(c.data, nd)
        valid = None
        if c.valid is not None or nc.valid is not None:
            ov = c.valid if c.valid is not None else RowSplit(
                [torch.ones_like(t) for t in existing[ROW_VALID].data.parts])
            nv = _on(nc.valid, src).bool() if nc.valid is not None else \
                torch.ones(m, dtype=torch.bool, device=src)
            valid = grow(ov, nv)
        cols.append(Column(c.field, data, valid, dictionary, None))
    rv = grow(existing[ROW_VALID].data,
              torch.ones(m, dtype=torch.bool, device=src))
    cols.append(Column(Field(ROW_VALID, DataType.BOOL), rv))
    out = Table(cols, name=existing.name)
    return _set_mesh(out, mesh, axis,
                     getattr(existing, "real_rows", existing.n_rows) + m)
