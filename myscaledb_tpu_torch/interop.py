"""Carry state across from host arrays: a database's "weights" are its
tables and their derived state.

``table_from_numpy`` builds this package's Table from the same column dict
that the JAX package's ``Table.from_dict`` takes; ``fixed_string_column``
builds a FixedString(N) column (the binary-vector carrier, which the JAX
package makes through its DDL) from host bytes.  The rest turn the JAX
package's derived state, after ``np.asarray``, into this package's:
``sq8_sidecar_from_numpy`` the SQ8 sidecar of ``build_sq8``,
``count_probe_build_from_numpy`` the count-probe build of
``merge_count.prepare_build``, and ``binary_sidecar_from_numpy`` the
segment-major words of ``pack_binary_segs``, and
``bm25_index_from_jax_state`` a ``BM25Index``'s vocabulary, postings and
statistics, and ``distributed_table_from_numpy`` a distributed table's
padded columns (with ``__row_valid__``) and shard count — so both packages
can run on one state.
"""

from __future__ import annotations

import numpy as np
import torch

from myscaledb_tpu_torch.core.table import Column, Table
from myscaledb_tpu_torch.core.types import DataType, Field
from myscaledb_tpu_torch.ops.kernels.binary_scan import SEG, SEGS_PER_STEP
from myscaledb_tpu_torch.ops.kernels.distance_q import SEG as SQ8_SEG


def table_from_numpy(columns: dict, device, dtypes=None) -> Table:
    """Table on ``device`` from {name: numpy array or list}; ``dtypes``
    optionally maps names to DataType."""
    return Table.from_dict(columns, dtypes=dtypes, device=device)


def fixed_string_column(name: str, values, nbytes: int, *,
                        device) -> Column:
    """FixedString(nbytes) column on ``device``: a dictionary-encoded
    String whose values are NUL-padded to nbytes bytes, with
    ``Field.fixed_len`` = nbytes (the JAX DDL's INSERT path).  ``values``
    is an (n, nbytes) uint8 array or a sequence of bytes / latin-1 str /
    None (None becomes the all-NUL value).  A value longer than nbytes
    raises, as the reference's "Too large value for FixedString"."""
    if isinstance(values, np.ndarray) and values.dtype == np.uint8:
        if values.ndim != 2 or values.shape[1] != nbytes:
            raise ValueError(f"FixedString({nbytes}) bytes must be (n, "
                             f"{nbytes}) uint8, got {values.shape}")
        flat = np.ascontiguousarray(values).tobytes().decode("latin-1")
        strs = [flat[i:i + nbytes] for i in range(0, len(flat), nbytes)]
    else:
        strs = []
        for v in values:
            v = "" if v is None else (v.decode("latin-1")
                                      if isinstance(v, (bytes, bytearray))
                                      else str(v))
            if len(v) > nbytes:
                raise ValueError(f"Too large value for FixedString({nbytes}) "
                                 f"column {name!r}")
            strs.append(v + "\x00" * (nbytes - len(v)))
    col = Column.from_numpy(name, np.asarray(strs, dtype=object),
                            DataType.STRING, device=device)
    col.field = Field(name, DataType.STRING, col.field.nullable,
                      fixed_len=nbytes)
    return col


def sq8_sidecar_from_numpy(x8: np.ndarray, sides: np.ndarray, device):
    """(x8 (n_pad, d) int8, sides (4, n_pad) f32) numpy arrays -> tensors
    on ``device``, after checking the sidecar layout."""
    x8 = np.asarray(x8)
    sides = np.asarray(sides)
    if x8.dtype != np.int8 or x8.ndim != 2:
        raise ValueError(f"x8 must be (n_pad, d) int8, got {x8.dtype} "
                         f"{x8.shape}")
    if x8.shape[0] % SQ8_SEG != 0:
        raise ValueError(f"x8 has {x8.shape[0]} rows, not a multiple of "
                         f"{SQ8_SEG}")
    if sides.dtype != np.float32 or sides.shape != (4, x8.shape[0]):
        raise ValueError(f"sides must be (4, {x8.shape[0]}) float32, got "
                         f"{sides.dtype} {sides.shape}")
    # copies: arrays from the JAX package are read-only
    return (torch.from_numpy(np.array(x8, order="C")).to(device),
            torch.from_numpy(np.array(sides, order="C")).to(device))


def count_probe_build_from_numpy(build2d: np.ndarray, has_max, n: int,
                                 device):
    """The JAX ``prepare_build`` output for n build keys — (rows, 128)
    int32 with the padding and margin rows at INT32_MAX, and has_max — as
    this package's (sorted (n,) int32, 0-d bool) on ``device``: the first
    n of the ascending keys, the padding and margin dropped."""
    flat = np.asarray(build2d).reshape(-1)
    if flat.dtype != np.int32 or flat.shape[0] < n:
        raise ValueError(f"build2d must hold at least {n} int32 keys, got "
                         f"{flat.dtype} x {flat.shape[0]}")
    keys = flat[:n]
    if np.any(keys[1:] < keys[:-1]) or np.any(flat[n:] != 2 ** 31 - 1):
        raise ValueError("build2d is not an ascending build of n keys with "
                         "INT32_MAX padding")
    return (torch.from_numpy(np.array(keys)).to(device),
            torch.tensor(bool(np.asarray(has_max)), device=device))


def binary_sidecar_from_numpy(x3: np.ndarray, device) -> torch.Tensor:
    """A JAX ``pack_binary_segs`` table, (nseg, words, SEG) uint32 with nseg
    a multiple of SEGS_PER_STEP, as the int32 tensor with the same bits
    that K5 reads."""
    x3 = np.asarray(x3)
    if x3.dtype != np.uint32 or x3.ndim != 3 or x3.shape[2] != SEG \
            or x3.shape[0] % SEGS_PER_STEP:
        raise ValueError(f"x3 must be (nseg, words, {SEG}) uint32 with nseg "
                         f"a multiple of {SEGS_PER_STEP}, got {x3.dtype} "
                         f"{x3.shape}")
    return torch.from_numpy(np.array(x3, order="C").view(np.int32)).to(device)


def bm25_index_from_jax_state(vocab: dict, post_docs, post_tfs, df, doc_len,
                              avg_len: float, stat_docs: int,
                              total_tokens: int, *, device):
    """A JAX ``BM25Index``'s state — ``vocab`` {term: id}, per-term posting
    doc ids and tf (its ``_post_docs``/``_post_tfs`` lists of numpy
    arrays), ``df``, ``doc_len`` and the statistics — as this package's
    ``text.bm25.BM25Index`` on ``device``, its postings laid out in CSR
    order of term id."""
    from myscaledb_tpu_torch.text.bm25 import BM25Index
    nv = len(vocab)
    if len(post_docs) != nv or len(post_tfs) != nv:
        raise ValueError(f"{nv} terms but {len(post_docs)} doc lists and "
                         f"{len(post_tfs)} tf lists")
    lens = np.array([len(p) for p in post_docs], dtype=np.int64)
    if not np.array_equal(lens, np.asarray(df, dtype=np.int64)):
        raise ValueError("df does not match the posting lengths")
    starts = np.zeros(nv + 1, dtype=np.int64)
    np.cumsum(lens, out=starts[1:])
    docs = np.concatenate([np.asarray(p, np.int32) for p in post_docs]) \
        if nv else np.zeros(0, np.int32)
    tfs = np.concatenate([np.asarray(p, np.float32) for p in post_tfs]) \
        if nv else np.zeros(0, np.float32)
    return BM25Index.from_state(vocab, starts, docs, tfs,
                                np.asarray(doc_len, np.float32), avg_len,
                                stat_docs, total_tokens, device=device)


def distributed_table_from_numpy(columns: dict, n_shards: int, device,
                                 dtypes=None, name: str = "") -> Table:
    """A JAX distributed table's state — its padded columns as {name: numpy
    array or list} with the ``__row_valid__`` mask among them, and its
    mesh's shard count (``mesh.shape[axis]``) — as this package's
    distributed Table over ``make_mesh(n_shards)`` on ``device``, with
    the same row layout (shard p's rows at [p * n_loc, (p + 1) * n_loc),
    its part on the shard's device)."""
    from myscaledb_tpu_torch.parallel.dist_table import (ROW_VALID,
                                                         distribute_table)
    from myscaledb_tpu_torch.parallel.mesh import make_mesh, shard_rows
    if ROW_VALID not in columns:
        raise ValueError(f"a distributed table's columns hold {ROW_VALID}")
    rv = np.asarray(columns[ROW_VALID], dtype=bool)
    if len(rv) % n_shards:
        raise ValueError(f"{len(rv)} rows do not split over {n_shards} "
                         "shards")
    t = Table.from_dict({k: v for k, v in columns.items()
                         if k != ROW_VALID}, name=name, dtypes=dtypes,
                        device=device)
    mesh = make_mesh(n_shards, device=device)
    # the rows are padded already: each shard's part is its rows as they
    # are, and the JAX table's row mask replaces the all-true one
    out = distribute_table(t, mesh)
    out[ROW_VALID].data = shard_rows(mesh, torch.as_tensor(rv.copy()))
    out.real_rows = int(rv.sum())
    return out


def row_split_from_numpy(shards, mesh):
    """A JAX row-sharded array's per-device shards as numpy arrays, in
    shard order (``[np.asarray(s.data) for s in arr.addressable_shards]``
    sorted by their row index), as this package's shard parts over
    ``mesh``: part p on ``mesh.device(p)``."""
    from myscaledb_tpu_torch.parallel.mesh import RowSplit
    shards = list(shards)
    if len(shards) != mesh.size:
        raise ValueError(f"{len(shards)} shards for a mesh of {mesh.size}")
    return RowSplit([torch.as_tensor(np.array(a, copy=True),
                                     device=mesh.device(p))
                     for p, a in enumerate(shards)])
