"""Scalar and array functions the DDL slice's statements use: the port of
``array``, ``range`` and the array form of ``length`` from
myscaledb_tpu/exec/arrays.py, the string form of ``length`` from
myscaledb_tpu/exec/expr.py, and ``currentDatabase``, ``sleep`` and
``sleepEachRow`` from myscaledb_tpu/exec/scalar_fns.py.

ARRAY values keep the JAX package's layout: a flat element tensor on the
device plus host int64 row offsets (n + 1,).  Every other function of those
modules raises ``NotPortedError`` from the evaluator.
"""

from __future__ import annotations

import numpy as np
import torch

from myscaledb_tpu_torch.core.dictionary import StringDictionary, NULL_ID
from myscaledb_tpu_torch.core.table import to_tensor
from myscaledb_tpu_torch.exec.expr import (Value, EvalError, func, _dict_map,
                                           _scalar)


def _lens(off: np.ndarray) -> np.ndarray:
    return off[1:] - off[:-1]


def _pos(off: np.ndarray) -> np.ndarray:
    """Per-element 0-based position within its row (host)."""
    total = int(off[-1])
    return np.arange(total, dtype=np.int64) - np.repeat(off[:-1], _lens(off))


def _array_value(flat, off, dictionary=None, valid=None) -> Value:
    return Value(flat, valid, dictionary,
                 offsets=np.asarray(off, dtype=np.int64))


def as_array(v: Value, env):
    """Normalize an array-like Value to (flat tensor, offsets (n+1,),
    dictionary): ARRAY values, fixed-width vector columns and constant
    vector literals (broadcast to every row)."""
    n = env.n_rows
    if v.is_array:
        return v.data, np.asarray(v.offsets, dtype=np.int64), v.dictionary
    d = v.data
    if v.is_scalar and isinstance(v.py, list):
        k = len(v.py)
        flat = to_tensor(np.tile(np.asarray(v.py), n), env.device) if k \
            else torch.zeros(0, dtype=torch.float32, device=env.device)
        return flat, np.arange(n + 1, dtype=np.int64) * k, None
    if isinstance(d, torch.Tensor) and d.dim() == 2:
        return d.reshape(-1), \
            np.arange(n + 1, dtype=np.int64) * int(d.shape[1]), None
    raise EvalError("expected an array argument")


def _unify_dicts(parts):
    """parts: list of (flat tensor, dictionary|None).  Remap every string
    part into one shared dictionary; numeric parts pass through."""
    if not any(d is not None for _, d in parts):
        return [f for f, _ in parts], None
    base = StringDictionary()
    out = []
    for flat, d in parts:
        if d is None:
            raise EvalError("cannot mix strings and numbers in one array")
        remap = base.merge_from(d)
        lut = to_tensor(np.append(remap, NULL_ID), flat.device)
        out.append(torch.where(flat == NULL_ID, NULL_ID,
                               lut[torch.clamp(flat, 0, len(remap) - 1)
                                   .long()]))
    return out, base


@func("array")
def _f_array(args, env):
    """array(e1, e2, ...): per-row fixed-length array from scalar
    expressions (``[a, b + 1]`` parses to it)."""
    n = env.n_rows
    k = len(args)
    dev = env.device
    if k == 0:
        return _array_value(torch.zeros(0, dtype=torch.int64, device=dev),
                            np.zeros(n + 1, dtype=np.int64))
    cols, dicts = [], []
    for a in args:
        if isinstance(a.py, str):
            d = StringDictionary()
            cols.append(torch.full((n,), d.encode_one(a.py, grow=True),
                                   dtype=torch.int64, device=dev))
            dicts.append(d)
        elif a.is_scalar:
            cols.append(a.data.expand(n))
            dicts.append(None)
        else:
            cols.append(a.data)
            dicts.append(a.dictionary)
    flats, base = _unify_dicts(list(zip(cols, dicts)))
    common = flats[0].dtype
    for f in flats[1:]:
        common = torch.promote_types(common, f.dtype)
    flat = torch.stack([f.to(common) for f in flats], dim=1).reshape(-1)
    return _array_value(flat, np.arange(n + 1, dtype=np.int64) * k, base)


@func("range")
def _f_range(args, env):
    """range(end) / range(start, end[, step]) per row."""
    n = env.n_rows

    def dense(v):
        if v.is_scalar:
            return np.full(n, int(v.py), dtype=np.int64)
        return v.data.cpu().numpy().astype(np.int64)
    if len(args) == 1:
        start, end, step = np.zeros(n, dtype=np.int64), dense(args[0]), \
            np.ones(n, dtype=np.int64)
    else:
        start, end = dense(args[0]), dense(args[1])
        step = dense(args[2]) if len(args) > 2 else np.ones(n, dtype=np.int64)
    if (step == 0).any():
        raise EvalError("range() step must be non-zero")
    lens = np.maximum(0, -(-(end - start) // step))
    off = np.concatenate([np.zeros(1, dtype=np.int64), np.cumsum(lens)])
    flat = np.repeat(start, lens) + _pos(off) * np.repeat(step, lens)
    return _array_value(to_tensor(flat, env.device), off)


def _arrayish(v: Value) -> bool:
    return (v.is_array or isinstance(v.py, list)
            or (isinstance(v.data, torch.Tensor) and not v.is_scalar
                and v.data.dim() == 2))


@func("length")
def _f_length(args, env):
    v = args[0]
    if _arrayish(v):
        _, off, _ = as_array(v, env)
        return Value(to_tensor(_lens(off), env.device), v.valid)
    if v.dictionary is None:
        raise EvalError("length() expects a string column")
    lut = np.array([len(s) for s in v.dictionary.values] or [0],
                   dtype=np.int64)
    return Value(_dict_map(v, lut), v.valid)


@func("currentDatabase")
def _f_currentdatabase(args, env):
    # one flat namespace; the reference's default database name keeps
    # system.* queries filtered on currentDatabase() portable
    return Value(None, is_scalar=True, py="default")


@func("sleep", "sleepEachRow")
def _f_sleep(args, env):
    # the reference suite sleeps to wait out asynchronous index builds and
    # merges; here a build finishes (or runs lazily on first use) before a
    # query can read it, so the wait is a no-op returning 0
    return Value(_scalar(0, env.device), is_scalar=True, py=0)
