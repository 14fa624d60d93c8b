"""Scalar and array functions the DDL slice's statements use: the port of
``array``, ``range`` and the array form of ``length`` from
myscaledb_tpu/exec/arrays.py, the string form of ``length`` from
myscaledb_tpu/exec/expr.py, and ``currentDatabase``, ``sleep``,
``sleepEachRow`` and the string-aware ``if()`` (``_if_impl``, which CASE
lowers to) from myscaledb_tpu/exec/scalar_fns.py.

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
                                           _numeric, _scalar, as_bool_mask)


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


# ---------------------------------------------------------------------------
# conditionals: the string-aware if() that CASE WHEN lowers to

def _is_null_literal(v: Value) -> bool:
    return v.is_scalar and v.py is None and v.dictionary is None


def _string_branch_ids(v: Value, env, d: StringDictionary):
    """Encode one if() branch into dictionary d; returns (ids, valid)."""
    n = env.n_rows
    if _is_null_literal(v):
        return torch.full((n,), NULL_ID, dtype=torch.int32,
                          device=env.device), \
            torch.zeros(n, dtype=torch.bool, device=env.device)
    if isinstance(v.py, str):
        i = d.encode_one(v.py, grow=True)
        return torch.full((n,), i, dtype=torch.int32, device=env.device), None
    if v.dictionary is None:
        raise EvalError("if(): mixed string and numeric branches")
    remap = np.array([d.encode_one(s, grow=True)
                      for s in v.dictionary.values] or [0], dtype=np.int32)
    ids = _dict_map(v, remap).to(torch.int32)
    ids = torch.where(v.data == NULL_ID, NULL_ID, ids)
    return ids, v.valid


def _chosen_valid(c, tv, fv):
    """Validity of if(c, t, f): the chosen branch's, row by row.  The JAX
    package takes t.valid & f.valid for two non-literal numeric branches, a
    fault of the reference (ROADMAP section 3)."""
    if tv is None and fv is None:
        return None
    ones = torch.ones_like(c)
    return torch.where(c, ones if tv is None else tv,
                       ones if fv is None else fv)


@func("if")
def _if_impl(args, env):
    c = as_bool_mask(args[0], env.n_rows)
    t, f = args[1], args[2]
    t_str = t.is_string or (_is_null_literal(t) and f.is_string)
    f_str = f.is_string or (_is_null_literal(f) and t.is_string)
    if t_str and f_str:
        d = StringDictionary()
        ti, tv = _string_branch_ids(t, env, d)
        fi, fv = _string_branch_ids(f, env, d)
        return Value(torch.where(c, ti, fi), _chosen_valid(c, tv, fv), d)
    if _is_null_literal(t) or _is_null_literal(f):
        # a NULL branch over numerics: the validity mask carries the null
        other = f if _is_null_literal(t) else t
        od = _numeric(other, env.n_rows)
        if other.is_scalar:
            od = od.expand(env.n_rows)
        valid = ~c if other is f else c
        if other.valid is not None:
            valid = valid & other.valid
        return Value(od, valid, dt=other.dt)
    out = torch.where(c, _numeric(t, env.n_rows), _numeric(f, env.n_rows))
    return Value(out, _chosen_valid(c, t.valid, f.valid),
                 dt=t.dt if t.dt is f.dt else None)
