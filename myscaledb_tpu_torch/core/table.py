"""Columnar in-memory tables: the port of myscaledb_tpu/core/table.py
(``ZoneMap``, ``Column``, ``Table``).

A Table is a dictionary of named Columns; each Column is one dense torch
tensor on the session's device (plus an optional validity mask).  Strings
are dictionary-encoded on the host, so only int32 ids reach the device.

Zone maps (per-block min/max) stay host numpy arrays, as in the JAX package,
and the planner consults them to skip whole blocks.  A column whose data is
a numpy array is host-resident (``is_host``): the memory governor keeps
columns bigger than ``Settings.max_hbm_bytes_per_column`` on the host and
the vector scan streams them through the device block by block.

Every constructor that makes tensors takes an explicit ``device``; the
session passes its own.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from myscaledb_tpu_torch.core.types import (DataType, Field, infer_type,
                                            physical_dtype,
                                            storage_numpy_dtype)
from myscaledb_tpu_torch.core.dictionary import StringDictionary, NULL_ID

# Rows per zone-map block (the JAX package's BLOCK_ROWS).
BLOCK_ROWS = 65536


def fits_device(arr) -> bool:
    """False for a uint64 array holding a value above 2^63-1, which the
    widened int64 storage cannot hold."""
    arr = np.asarray(arr)
    return not (arr.dtype == np.uint64 and arr.size and
                int(arr.max()) > np.iinfo(np.int64).max)


def to_tensor(arr, device) -> torch.Tensor:
    """Host array -> tensor on ``device``, in the storage dtype of
    core/types.py (uint16/32/64 widen to signed types)."""
    arr = np.asarray(arr)
    sd = storage_numpy_dtype(arr.dtype)
    if not fits_device(arr):
        raise ValueError("UInt64 values above 2^63-1 are not supported by "
                         "the torch column store")
    arr = np.ascontiguousarray(arr.astype(sd, copy=False))
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr).to(device)


# device copies of host row offsets, by the id of the host array; an entry
# dies with its array (weakref.finalize), so a Column's copy is made once
# and kept as long as the Column holds its offsets
_DEVICE_OFFSETS: dict = {}


def device_offsets(off, device) -> torch.Tensor:
    """The int64 row offsets (n + 1,) of an ARRAY layout on ``device``: a
    ``DeviceOffsets``' own tensor, else the device copy of the host array,
    made at first use and kept while the array lives."""
    if isinstance(off, DeviceOffsets):
        return off.dev
    key = id(off)
    hit = _DEVICE_OFFSETS.get(key)
    want = torch.device(device)
    if hit is not None and hit.device.type == want.type and (
            want.index is None or hit.device.index == want.index):
        return hit
    dev = torch.from_numpy(np.ascontiguousarray(off, dtype=np.int64)) \
        .to(device)
    if hit is None:
        weakref.finalize(off, _DEVICE_OFFSETS.pop, key, None)
    _DEVICE_OFFSETS[key] = dev
    return dev


class DeviceOffsets:
    """Row offsets (n + 1,) made on the device (by the array functions of
    exec/arrays.py), with their element count.  Host code that needs them
    (``np.asarray``) gets a host copy, made once; the device tensor stays
    the one ``device_offsets`` returns for it."""

    __slots__ = ("dev", "total", "_host", "__weakref__")

    def __init__(self, dev: torch.Tensor, total: int):
        self.dev = dev
        self.total = int(total)
        self._host = None

    def __len__(self) -> int:
        return int(self.dev.shape[0])

    def __array__(self, dtype=None, copy=None):
        if self._host is None:
            self._host = self.dev.cpu().numpy()
            _DEVICE_OFFSETS[id(self._host)] = self.dev
            weakref.finalize(self._host, _DEVICE_OFFSETS.pop,
                             id(self._host), None)
        return self._host if dtype is None else \
            self._host.astype(dtype, copy=False)


def offsets_total(off) -> int:
    """Element count of an ARRAY layout (its last offset)."""
    return off.total if isinstance(off, DeviceOffsets) else int(off[-1])


def take_runs(flat: torch.Tensor, starts: torch.Tensor,
              out_doff: torch.Tensor, total: int) -> torch.Tensor:
    """flat[starts[i] : starts[i] + len_i] for every row i, concatenated,
    where len_i = out_doff[i + 1] - out_doff[i]: per-element source
    positions from ``torch.repeat_interleave`` on the device."""
    lens = out_doff[1:] - out_doff[:-1]
    shift = torch.repeat_interleave(starts - out_doff[:-1], lens,
                                    output_size=total)
    src = torch.arange(total, device=flat.device) + shift
    return flat.index_select(0, src)


@dataclass
class ZoneMap:
    """Per-block min/max for one numeric column (host-side)."""
    mins: np.ndarray
    maxs: np.ndarray

    @staticmethod
    def build(data: np.ndarray, block_rows: int = BLOCK_ROWS) -> "ZoneMap":
        n = len(data)
        nblocks = max(1, -(-n // block_rows))
        mins = np.empty(nblocks, dtype=data.dtype)
        maxs = np.empty(nblocks, dtype=data.dtype)
        for b in range(nblocks):
            chunk = data[b * block_rows:(b + 1) * block_rows]
            if len(chunk) == 0:
                mins[b], maxs[b] = 0, 0
            else:
                mins[b] = chunk.min()
                maxs[b] = chunk.max()
        return ZoneMap(mins, maxs)

    @staticmethod
    def build_device(data: torch.Tensor, host_dtype,
                     block_rows: int = BLOCK_ROWS) -> "ZoneMap":
        """``build`` over a device column: the per-block minima and maxima
        are taken on the device and only those 2 x blocks values are
        copied to the host, in ``host_dtype`` (the column's logical numpy
        dtype).  The same values as ``build`` of the column's host copy."""
        n = int(data.shape[0])
        if n == 0:
            z = np.zeros(1, dtype=host_dtype)
            return ZoneMap(z, z.copy())
        full = n // block_rows
        mins, maxs = [], []
        if full:
            lo, hi = torch.aminmax(data[:full * block_rows]
                                   .view(full, block_rows), dim=1)
            mins.append(lo)
            maxs.append(hi)
        if n > full * block_rows:
            lo, hi = torch.aminmax(data[full * block_rows:])
            mins.append(lo.reshape(1))
            maxs.append(hi.reshape(1))
        both = torch.stack([torch.cat(mins), torch.cat(maxs)]).cpu().numpy()
        both = both.astype(host_dtype, copy=False)
        return ZoneMap(both[0].copy(), both[1].copy())


class Column:
    """One column: logical field + device tensor (+ optional validity).

    data shape: (n,) for scalars, (n, dim) for FLOAT32_VECTOR; for ARRAY
    columns the flat element tensor, with host int64 row ``offsets``.
    valid: bool (n,) tensor, True where the value is non-NULL; None = no
    nulls.
    """

    __slots__ = ("field", "data", "valid", "dictionary", "zonemap", "offsets")

    def __init__(self, field: Field, data, valid=None,
                 dictionary: Optional[StringDictionary] = None,
                 zonemap: Optional[ZoneMap] = None, offsets=None):
        self.field = field
        self.data = data
        self.valid = valid
        self.dictionary = dictionary
        self.zonemap = zonemap
        self.offsets = offsets

    @property
    def name(self) -> str:
        return self.field.name

    @property
    def dtype(self) -> DataType:
        return self.field.dtype

    @property
    def is_host(self) -> bool:
        """True when the data lives in host RAM (an out-of-device column
        that the operators stream block by block)."""
        return isinstance(self.data, np.ndarray)

    def __len__(self) -> int:
        if self.offsets is not None:
            return len(self.offsets) - 1
        return int(self.data.shape[0])

    @staticmethod
    def from_pylist_of_lists(name: str, rows, elem_dtype=None, *,
                             device) -> "Column":
        """Build an ARRAY column from a list of python lists."""
        lens = np.array([len(r) for r in rows], dtype=np.int64)
        offsets = np.concatenate([np.zeros(1, dtype=np.int64),
                                  np.cumsum(lens)])
        flat = [x for r in rows for x in r]
        dictionary = None
        if any(isinstance(x, str) for x in flat):
            dictionary = StringDictionary()
            data_np = dictionary.encode(flat)
            elem = DataType.STRING
        else:
            data_np = np.asarray(flat) if flat else np.zeros(0, dtype=np.int64)
            if elem_dtype is not None:
                data_np = data_np.astype(physical_dtype(elem_dtype))
                elem = elem_dtype
            else:
                elem = infer_type(data_np) if len(data_np) else DataType.INT64
        fld = Field(name, DataType.ARRAY, elem=elem)
        return Column(fld, to_tensor(data_np, device), None, dictionary, None,
                      offsets)

    def take_ragged(self, idx_np: np.ndarray) -> "Column":
        """Row gather for ARRAY columns: the new offsets from the host
        offsets (one value a row), the elements by one device gather whose
        positions are made on the device (``take_runs``)."""
        off = np.asarray(self.offsets, dtype=np.int64)
        idx_np = np.asarray(idx_np, dtype=np.int64)
        lens = off[1:] - off[:-1]
        out_off = np.concatenate([np.zeros(1, dtype=np.int64),
                                  np.cumsum(lens[idx_np])])
        dev = self.data.device
        idx = torch.as_tensor(idx_np, device=dev)
        data = take_runs(self.data, device_offsets(off, dev)[:-1][idx],
                         device_offsets(out_off, dev), int(out_off[-1]))
        valid = None
        if self.valid is not None:
            valid = self.valid.index_select(0, idx)
        return Column(self.field, data, valid, self.dictionary, None, out_off)

    @staticmethod
    def from_numpy(name: str, arr, dtype: Optional[DataType] = None,
                   dictionary: Optional[StringDictionary] = None,
                   build_zonemap: bool = True,
                   to_device: bool = True, *, device) -> "Column":
        """Ingest a host array (strings allowed) into a column on
        ``device``.  ``to_device=False`` keeps the data host-resident."""
        if isinstance(arr, (list, tuple)):
            if arr and isinstance(arr[0], (list, tuple, np.ndarray)) and not isinstance(arr[0], str):
                lens = {len(x) for x in arr}
                has_str = any(isinstance(e, str) for x in arr for e in x)
                if len(lens) > 1 or has_str or dtype is DataType.ARRAY:
                    return Column.from_pylist_of_lists(name, arr,
                                                       device=device)
                arr = np.asarray(arr, dtype=np.float32)
            elif any(isinstance(x, str) or x is None for x in arr):
                arr = np.asarray(arr, dtype=object)
            else:
                arr = np.asarray(arr)
        if isinstance(arr, np.ndarray) and arr.dtype.kind == "M":
            # numpy datetime64 ingest -> Date (day precision) / DateTime
            unit = np.datetime_data(arr.dtype)[0]
            if unit == "D":
                arr = arr.astype("datetime64[D]").astype(np.int64)
                dtype = dtype or DataType.DATE
            else:
                arr = arr.astype("datetime64[s]").astype(np.int64)
                dtype = dtype or DataType.DATETIME
        if dtype is None:
            dtype = infer_type(np.asarray(arr))
        fld_dim = 0
        if dtype is DataType.STRING:
            dictionary = dictionary or StringDictionary()
            ids = dictionary.encode(list(arr))
            nullable = bool((ids == NULL_ID).any())
            valid_np = (ids != NULL_ID) if nullable else None
            data_np = ids
        else:
            data_np = np.asarray(arr)
            if dtype is DataType.FLOAT32_VECTOR:
                data_np = data_np.astype(np.float32, copy=False)
                fld_dim = int(data_np.shape[1])
            else:
                data_np = data_np.astype(physical_dtype(dtype), copy=False)
            valid_np = None
            nullable = False
        fld = Field(name, dtype, nullable=nullable, vector_dim=fld_dim)
        zm = None
        if build_zonemap and data_np.ndim == 1 and (
                dtype.is_numeric or dtype is DataType.STRING):
            # string columns zone-map their dictionary ids: equality/IN
            # terms prune via id membership
            zm = ZoneMap.build(data_np)
        if to_device:
            data_out = to_tensor(data_np, device)
            valid_out = to_tensor(valid_np, device) \
                if valid_np is not None else None
        else:
            data_out = np.ascontiguousarray(data_np)
            valid_out = valid_np
        return Column(fld, data_out, valid_out,
                      dictionary=dictionary, zonemap=zm)

    def to_numpy(self) -> np.ndarray:
        """Host copy in the logical type's numpy dtype (widened unsigned
        storage is cast back)."""
        arr = self.data if self.is_host else self.data.cpu().numpy()
        if self.offsets is None and self.dtype.is_numeric:
            arr = arr.astype(physical_dtype(self.dtype), copy=False)
        return arr

    def to_python(self) -> list:
        """Decode to python values (strings via dictionary, None for nulls)."""
        arr = self.to_numpy()
        if self.offsets is not None:
            flat = self.dictionary.decode(arr) if self.dictionary is not None \
                else arr.tolist()
            off = self.offsets
            vals = [flat[off[i]:off[i + 1]] for i in range(len(off) - 1)]
        elif self.dtype is DataType.STRING:
            vals = self.dictionary.decode(arr)
        elif self.dtype is DataType.DATE:
            import datetime as _dtm
            epoch = _dtm.date(1970, 1, 1)
            vals = [epoch + _dtm.timedelta(days=int(x)) for x in arr]
        elif self.dtype is DataType.DATETIME:
            import datetime as _dtm
            base = _dtm.datetime(1970, 1, 1)
            vals = [base + _dtm.timedelta(seconds=int(x)) for x in arr]
        else:
            vals = arr.tolist()
        if self.valid is not None:
            v = np.asarray(self.valid.cpu() if isinstance(
                self.valid, torch.Tensor) else self.valid)
            if v.ndim == 0:                 # scalar validity (projected
                v = np.full(len(vals), bool(v))   # constant)
            vals = [x if ok else None for x, ok in zip(vals, v)]
        return vals


class Table:
    """Named columns of equal row count."""

    def __init__(self, columns: Sequence[Column], name: str = ""):
        if columns:
            n = len(columns[0])
            for c in columns:
                if len(c) != n:
                    raise ValueError(
                        f"column {c.name} has {len(c)} rows, expected {n}")
        self.name = name
        self.columns: dict[str, Column] = {c.name: c for c in columns}

    # -- construction -------------------------------------------------------

    @staticmethod
    def from_dict(data: dict, name: str = "",
                  dtypes: Optional[dict] = None,
                  hbm_budget_bytes: int = 0, *, device) -> "Table":
        """``hbm_budget_bytes`` > 0: columns whose raw bytes exceed it stay
        host-resident and are streamed by the operators."""
        dtypes = dtypes or {}
        cols = []
        for k, v in data.items():
            if isinstance(v, Column):
                cols.append(v)
                continue
            to_device = True
            if hbm_budget_bytes and isinstance(v, np.ndarray) \
                    and v.dtype.kind in "fiub" \
                    and v.nbytes > hbm_budget_bytes:
                to_device = False
            cols.append(Column.from_numpy(k, v, dtypes.get(k),
                                          to_device=to_device, device=device))
        return Table(cols, name=name)

    # -- basic accessors ----------------------------------------------------

    @property
    def n_rows(self) -> int:
        if not self.columns:
            return 0
        return len(next(iter(self.columns.values())))

    @property
    def device(self) -> Optional[torch.device]:
        """Device of the first device-resident column (None when every
        column is host-resident or the table has none)."""
        for c in self.columns.values():
            if not c.is_host:
                return c.data.device
        return None

    @property
    def column_names(self) -> list[str]:
        return list(self.columns.keys())

    def __getitem__(self, name: str) -> Column:
        if name not in self.columns:
            raise KeyError(f"no column {name!r} in table {self.name!r} "
                           f"(have {self.column_names})")
        return self.columns[name]

    def __contains__(self, name: str) -> bool:
        return name in self.columns

    def schema(self) -> list[Field]:
        return [c.field for c in self.columns.values()]

    # -- transforms (host orchestration; device data stays on device) -------

    def select(self, names: Sequence[str]) -> "Table":
        return Table([self[n] for n in names], name=self.name)

    def with_column(self, col: Column) -> "Table":
        cols = [c for c in self.columns.values() if c.name != col.name]
        cols.append(col)
        return Table(cols, name=self.name)

    def take(self, idx: torch.Tensor) -> "Table":
        """Gather rows by an index tensor.  Host-resident columns gather on
        the host and only the gathered rows move to idx's device."""
        cols = []
        idx = idx.long()
        idx_np = None
        for c in self.columns.values():
            if c.offsets is not None or c.is_host:
                if idx_np is None:
                    idx_np = idx.cpu().numpy()
            if c.offsets is not None:
                cols.append(c.take_ragged(idx_np))
                continue
            if c.is_host:
                data = c.data[idx_np]
                valid = c.valid[idx_np] if c.valid is not None else None
                if fits_device(data):     # else UInt64 past 2^63-1: host
                    data = to_tensor(data, idx.device)
                    valid = to_tensor(valid, idx.device) \
                        if valid is not None else None
            else:
                data = c.data.index_select(0, idx)
                valid = c.valid.index_select(0, idx) \
                    if c.valid is not None else None
            cols.append(Column(c.field, data, valid, c.dictionary, None))
        return Table(cols, name=self.name)

    def head(self, k: int) -> "Table":
        cols = []
        dev = self.device
        for c in self.columns.values():
            if c.offsets is not None:
                cols.append(c.take_ragged(np.arange(min(k, len(c)))))
                continue
            valid = c.valid[:k] if c.valid is not None else None
            data = c.data[:k]
            if c.is_host:
                data = to_tensor(data, dev)
                valid = to_tensor(valid, dev) if valid is not None else None
            cols.append(Column(c.field, data, valid, c.dictionary, None))
        return Table(cols, name=self.name)

    def to_pydict(self) -> dict[str, list]:
        return {n: c.to_python() for n, c in self.columns.items()}

    def to_rows(self) -> list[tuple]:
        cols = [c.to_python() for c in self.columns.values()]
        return list(zip(*cols)) if cols else []

    def __repr__(self) -> str:
        flds = ", ".join(str(f) for f in self.schema())
        return f"Table({self.name!r}, rows={self.n_rows}, [{flds}])"


def concat_tables(tables: Sequence[Table], name: str = "") -> Table:
    """Concatenate row-wise (INSERT appends a batch to its table; the
    union of GROUP BY ROLLUP/CUBE/GROUPING SETS levels); string
    dictionaries are merged with id remapping, ARRAY offsets rebased,
    FLOAT32_VECTOR rows and validity masks stacked.  The port of
    myscaledb_tpu/core/table.py::concat_tables; every tensor stays on the
    device of the parts."""
    if not tables:
        return Table([], name=name)
    first = tables[0]
    out_cols = []
    for cname in first.column_names:
        cols = [t[cname] for t in tables]
        fld = cols[0].field
        if fld.dtype is DataType.ARRAY:
            if any(c.dictionary is not None for c in cols):
                base = StringDictionary()
                datas = []
                for c in cols:
                    remap = base.merge_from(c.dictionary
                                            or StringDictionary())
                    lut = to_tensor(np.append(remap, NULL_ID)
                                    .astype(np.int64), c.data.device)
                    datas.append(torch.where(c.data == NULL_ID, NULL_ID,
                                             lut[c.data.long()]))
                data = torch.cat(datas)
                dictionary = base
            else:
                data = torch.cat([c.data for c in cols])
                dictionary = None
            offs = [np.asarray(c.offsets) for c in cols]
            out_off = [offs[0]]
            base_n = offs[0][-1]
            for o in offs[1:]:
                out_off.append(o[1:] + base_n)
                base_n += o[-1]
            out_cols.append(Column(fld, data, _cat_valid(cols), dictionary,
                                   None, np.concatenate(out_off)))
            continue
        if fld.dtype is DataType.STRING:
            # the first part's ids stay (a copy of its dictionary) where its
            # values are distinct; the other parts' are remapped into it
            d0 = cols[0].dictionary
            fast = len(d0.index) == len(d0.values)
            base = d0.copy() if fast else StringDictionary()
            datas = [cols[0].data.to(torch.int32)] if fast else []
            for c in cols[1 if fast else 0:]:
                remap = base.merge_from(c.dictionary)
                # index -1 (NULL_ID) picks the appended NULL_ID
                lut = to_tensor(np.append(remap, NULL_ID).astype(np.int32),
                                c.data.device)
                datas.append(torch.where(c.data == NULL_ID, NULL_ID,
                                         lut[c.data.long()]))
            data = torch.cat(datas)
            dictionary = base
        else:
            data = torch.cat([c.data for c in cols])
            dictionary = None
        out_cols.append(Column(fld, data, _cat_valid(cols), dictionary,
                               None))
    return Table(out_cols, name=name or first.name)


def _cat_valid(cols):
    """Validity of concatenated columns: None when no part has NULLs."""
    if all(c.valid is None for c in cols):
        return None
    return torch.cat([c.valid if c.valid is not None
                      else torch.ones(len(c), dtype=torch.bool,
                                      device=c.data.device) for c in cols])
