"""Distributed (row-partitioned) tables over a mesh: the port of
myscaledb_tpu/parallel/dist_table.py.

A distributed table is the same Table object with its rows padded to a
multiple of the mesh and the attributes ``mesh``, ``mesh_axis`` and
``real_rows`` set; shard p owns rows [p * n_loc, (p + 1) * n_loc).  The
executor routes the hot operators to the shard bodies of parallel/ops.py
and parallel/shuffle.py, and runs every elementwise expression over the
global view.  A hidden ``__row_valid__`` column masks the padding out of
every operator (the executor folds it into the WHERE mask).
"""

from __future__ import annotations

import numpy as np
import torch

from myscaledb_tpu_torch.core.table import Column, Table, to_tensor
from myscaledb_tpu_torch.core.types import DataType, Field
from myscaledb_tpu_torch.errors import ExecError
from myscaledb_tpu_torch.parallel.mesh import SHARD_AXIS, Mesh

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


def _pad_rows(t: torch.Tensor, pad: int, fill=0) -> torch.Tensor:
    if not pad:
        return t
    tail = torch.full((pad,) + tuple(t.shape[1:]), fill, dtype=t.dtype,
                      device=t.device)
    return torch.cat([t, tail])


def distribute_table(table: Table, mesh: Mesh,
                     axis: str = SHARD_AXIS) -> Table:
    """Pad rows to a multiple of the mesh and place every column on the
    mesh's device (a host-resident column moves there, as the JAX package's
    ``device_put`` moves it); padding rows are invalid in
    ``__row_valid__``."""
    nsh = mesh.shape[axis]
    dev = mesh.device(0)
    n = table.n_rows
    pad = -(-n // nsh) * nsh - n
    cols = []
    for c in table.columns.values():
        valid = None if c.valid is None else \
            _pad_rows(_on(c.valid, dev).bool(), pad, False)
        if c.offsets is not None:
            # padding rows hold empty arrays
            off = np.asarray(c.offsets, dtype=np.int64)
            off = np.concatenate([off, np.full(pad, off[-1], np.int64)])
            cols.append(Column(c.field, _on(c.data, dev), valid,
                               c.dictionary, c.zonemap, off))
            continue
        cols.append(Column(c.field, _pad_rows(_on(c.data, dev), pad), valid,
                           c.dictionary, c.zonemap))
    rv = torch.ones(n + pad, dtype=torch.bool, device=dev)
    rv[n:] = False
    cols.append(Column(Field(ROW_VALID, DataType.BOOL), rv))
    return _set_mesh(Table(cols, name=table.name), mesh, axis, n)


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
    each shard's region grows in place: shard p's rows become its old rows,
    then its new rows, then padding.  Global row order becomes shard-major,
    as in the reference, where per-shard local tables have no global
    order.  Zone maps are dropped."""
    mesh = existing.mesh
    axis = existing.mesh_axis
    nsh = mesh.shape[axis]
    dev = mesh.device(0)
    cap_old = existing.n_rows // nsh
    m = new.n_rows
    if m == 0:
        return existing
    key = new[shard_key] if shard_key and shard_key in new else None
    dest = route_rows(key, m, nsh, dev)
    order = torch.sort(dest, stable=True).indices
    counts = torch.bincount(dest, minlength=nsh)
    counts_np = counts.cpu().numpy()
    cap = cap_old + int(counts_np.max())
    # new row order[i] lands at shard s = dest[order[i]], slot cap_old + i
    # - (rows routed to shards before s)
    starts = torch.cumsum(counts, 0) - counts
    sdest = dest[order]
    within = torch.arange(m, device=dev) - starts[sdest]
    dst = sdest * cap + cap_old + within

    def grow(old: torch.Tensor, fresh: torch.Tensor) -> torch.Tensor:
        tail = tuple(old.shape[1:])
        buf = torch.zeros((nsh, cap) + tail, dtype=old.dtype, device=dev)
        buf[:, :cap_old] = old.reshape((nsh, cap_old) + tail)
        buf = buf.reshape((nsh * cap,) + tail)
        buf[dst] = fresh[order].to(old.dtype)
        return buf

    cols = []
    for c in existing.columns.values():
        if c.name == ROW_VALID:
            continue
        if c.offsets is not None:
            raise ExecError("INSERT into a distributed table with ARRAY "
                            f"column {c.name!r} is not supported")
        nc = new[c.name]
        nd = _on(nc.data, dev)
        dictionary = c.dictionary
        if dictionary is not None and nc.dictionary is not dictionary:
            # re-encode through (a copy of) the existing dictionary
            dictionary = dictionary.copy()
            remap = dictionary.merge_from(nc.dictionary)
            lut = to_tensor(np.append(remap, -1).astype(np.int64), dev)
            nd = torch.where(nd < 0, nd.to(torch.int64), lut[nd.long()])
        data = grow(_on(c.data, dev), nd)
        valid = None
        if c.valid is not None or nc.valid is not None:
            ov = _on(c.valid, dev).bool() if c.valid is not None else \
                torch.ones(existing.n_rows, dtype=torch.bool, device=dev)
            nv = _on(nc.valid, dev).bool() if nc.valid is not None else \
                torch.ones(m, dtype=torch.bool, device=dev)
            valid = grow(ov, nv)
        cols.append(Column(c.field, data, valid, dictionary, None))
    rv = grow(existing[ROW_VALID].data,
              torch.ones(m, dtype=torch.bool, device=dev))
    cols.append(Column(Field(ROW_VALID, DataType.BOOL), rv))
    out = Table(cols, name=existing.name)
    return _set_mesh(out, mesh, axis,
                     getattr(existing, "real_rows", existing.n_rows) + m)
