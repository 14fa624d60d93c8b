"""Array functions over the flat-values + offsets layout: the port of
myscaledb_tpu/exec/arrays.py.

An ARRAY value is a flat element tensor on the device plus row offsets
(n + 1,): a Column's are host int64 (core/table.py), and its device copy
is made once (``core.table.device_offsets``) and kept with it; the arrays
these functions make carry their offsets on the device
(``core.table.DeviceOffsets``) and reach the host only when a result
column is built.  Per-row segment operations run over the flat elements
keyed by per-element row ids, and those ids and the positions within a
row come from the card: ``torch.repeat_interleave`` over the device row
lengths.  (The JAX package builds them with ``np.repeat`` on the host and
uploads them.)  Strings keep their dictionary; arrays of two dictionaries
are merged into one (``_unify_dicts``).

Higher-order functions (arrayMap/Filter/Exists/...) evaluate the lambda
body once over the flat element axis (``_ElemEnv``); outer columns
broadcast with one device gather by the element row ids.
"""

from __future__ import annotations

import numpy as np
import torch

from myscaledb_tpu_torch.core.dictionary import StringDictionary, NULL_ID
from myscaledb_tpu_torch.core.table import (DeviceOffsets, device_offsets,
                                            offsets_total, take_runs,
                                            to_tensor)
from myscaledb_tpu_torch.exec.expr import (Env, Value, EvalError, func,
                                           _FUNCS, _dict_map, eval_expr,
                                           as_bool_mask, _both_valid)
from myscaledb_tpu_torch.sql.ast import FuncCall, Lambda

INT32_MAX = np.iinfo(np.int32).max


# ---------------------------------------------------------------------------
# layout helpers

def as_array(v: Value, env: Env):
    """Normalize an array-like Value to (flat tensor, offsets, dictionary):
    ARRAY values, fixed-width vector columns and constant vector literals
    (broadcast to every row).  Offsets are a Column's host array or a
    ``DeviceOffsets``."""
    n = env.n_rows
    dev = env.device
    if v.is_array:
        off = v.offsets
        if not isinstance(off, DeviceOffsets):
            off = np.asarray(off, dtype=np.int64)
        return v.data, off, v.dictionary
    d = v.data
    if v.is_scalar and isinstance(v.py, list):
        k = len(v.py)
        flat = to_tensor(np.asarray(v.py), dev).repeat(n) if k \
            else torch.zeros(0, dtype=torch.float32, device=dev)
        return flat, _fixed_offsets(n, k, dev), None
    if isinstance(d, torch.Tensor) and d.dim() == 2:
        return d.reshape(-1), _fixed_offsets(n, int(d.shape[1]), dev), None
    raise EvalError("expected an array argument")


def _fixed_offsets(n: int, k: int, device) -> DeviceOffsets:
    return DeviceOffsets(torch.arange(n + 1, device=device) * k, n * k)


def _new_offsets(lens: torch.Tensor) -> DeviceOffsets:
    """Offsets of rows with the given device lengths (one host read: the
    element count)."""
    doff = torch.zeros(lens.shape[0] + 1, dtype=torch.int64,
                       device=lens.device)
    torch.cumsum(lens, 0, out=doff[1:])
    return DeviceOffsets(doff, int(doff[-1]) if lens.shape[0] else 0)


def _lens(off, device) -> torch.Tensor:
    """Row lengths (n,) on the device."""
    d = device_offsets(off, device)
    return d[1:] - d[:-1]


def _rid(off, device) -> torch.Tensor:
    """Per-element row id, made on the device."""
    lens = _lens(off, device)
    return torch.repeat_interleave(
        torch.arange(lens.shape[0], device=device), lens,
        output_size=offsets_total(off))


def _pos(off, device, rid=None) -> torch.Tensor:
    """Per-element 0-based position within its row, made on the device."""
    rid = _rid(off, device) if rid is None else rid
    starts = device_offsets(off, device)[:-1]
    return torch.arange(offsets_total(off), device=device) \
        - starts.index_select(0, rid)


def array_row_keys(v: Value, device) -> torch.Tensor:
    """(n,) int64 keys of an ARRAY value's rows that order the arrays as
    ClickHouse compares them (element by element, a prefix first) and are
    equal exactly where the arrays are: GROUP BY, count(DISTINCT) and
    ORDER BY over an array read them.  Each row becomes (present, element)
    pairs padded to the longest array, and one ``torch.unique`` over rows
    ranks them; floats compare through an order-keeping integer image
    (-0.0 as +0.0), strings through the dictionary's sort ranks."""
    off = v.offsets
    lens = _lens(off, device)
    n = int(lens.shape[0])
    flat = v.data
    if v.dictionary is not None:
        ranks = to_tensor(np.append(v.dictionary.ranks(), -1)
                          .astype(np.int64), device)
        flat = ranks[torch.where(flat < 0, ranks.numel() - 1,
                                 flat.to(torch.int64))]
    elif flat.is_floating_point():
        b = (flat.to(torch.float64) + 0.0).view(torch.int64)
        flat = b ^ ((b >> 63) & 0x7FFFFFFFFFFFFFFF)
    width = int(lens.max()) if n else 0
    rows = torch.zeros((n, 2 * width), dtype=torch.int64, device=device)
    if width:
        rid = _rid(off, device)
        pos = 2 * _pos(off, device, rid)
        rows[rid, pos] = 1
        rows[rid, pos + 1] = flat.to(torch.int64)
    return torch.unique(rows, dim=0, return_inverse=True)[1]


def _seg_sum(off, x: torch.Tensor, acc, device) -> torch.Tensor:
    """Per-row sum of flat elements in ``acc``: integers from one cumsum
    (exact, wrapping as the JAX package's int64 scatter-add does), floats
    by an index_add_ over the row ids (the JAX package's scatter-add)."""
    n = len(off) - 1
    x = x.to(acc)
    if not acc.is_floating_point:
        cs = torch.zeros(x.shape[0] + 1, dtype=acc, device=device)
        torch.cumsum(x, 0, out=cs[1:])
        d = device_offsets(off, device)
        return cs.index_select(0, d[1:]) - cs.index_select(0, d[:-1])
    out = torch.zeros(n, dtype=acc, device=device)
    return out.index_add_(0, _rid(off, device), x)


def _seg_reduce(off, x: torch.Tensor, op: str, init, device) -> torch.Tensor:
    """Per-row min/max/product of flat elements, ``init`` for empty rows."""
    n = len(off) - 1
    out = torch.full((n,), init, dtype=x.dtype, device=device)
    return out.scatter_reduce_(0, _rid(off, device), x, op,
                               include_self=True)


def _array_value(flat, off, dictionary=None, valid=None, umax=None) -> Value:
    return Value(flat, valid, dictionary, offsets=off, umax=umax)


def _needle(needle: Value, off, dictionary, env: Env):
    """A scalar-or-column needle as per-element values comparable with the
    flat array."""
    if isinstance(needle.py, str):
        if dictionary is None:
            raise EvalError("cannot search a string in a numeric array")
        return torch.tensor(dictionary.encode_one(needle.py, grow=False),
                            device=env.device)
    if needle.is_scalar or needle.data.dim() == 0:
        return needle.data
    rid = _rid(off, env.device)
    if needle.dictionary is not None:
        if dictionary is None:
            raise EvalError("cannot search a string in a numeric array")
        # remapped once per dictionary value, gathered by row
        remap = np.array([dictionary.encode_one(s, grow=False)
                          for s in needle.dictionary.values] or [-2],
                         dtype=np.int64)
        return _dict_map(needle, remap).index_select(0, rid)
    return needle.data.index_select(0, rid)


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


def _common(flats):
    dt = flats[0].dtype
    for f in flats[1:]:
        dt = torch.promote_types(dt, f.dtype)
    return [f.to(dt) for f in flats]


# ---------------------------------------------------------------------------
# construction

@func("array")
def _f_array(args, env):
    """array(e1, e2, ...): per-row fixed-length array from scalar
    expressions (``[a, b + 1]`` parses to it)."""
    n = env.n_rows
    k = len(args)
    dev = env.device
    if k == 0:
        return _array_value(torch.zeros(0, dtype=torch.int64, device=dev),
                            _fixed_offsets(n, 0, dev))
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
    flat = torch.stack(_common(flats), dim=1).reshape(-1)
    return _array_value(flat, _fixed_offsets(n, k, dev), base)


def _dense(v: Value, n: int, device) -> torch.Tensor:
    """An integer argument as (n,) int64 rows on the device."""
    if v.is_scalar:
        return torch.full((n,), int(v.py), dtype=torch.int64, device=device)
    return v.data.to(torch.int64)


@func("range")
def _f_range(args, env):
    """range(end) / range(start, end[, step]) per row."""
    n, dev = env.n_rows, env.device
    ones = torch.ones(n, dtype=torch.int64, device=dev)
    if len(args) == 1:
        start, end, step = torch.zeros_like(ones), _dense(args[0], n, dev), \
            ones
    else:
        start, end = _dense(args[0], n, dev), _dense(args[1], n, dev)
        step = _dense(args[2], n, dev) if len(args) > 2 else ones
    if len(args) > 2 and (int(args[2].py) == 0 if args[2].is_scalar
                          else bool((step == 0).any())):
        raise EvalError("range() step must be non-zero")
    lens = torch.clamp(-torch.div(start - end, step, rounding_mode="floor"),
                       min=0)
    off = _new_offsets(lens)
    rid = _rid(off, dev)
    flat = start.index_select(0, rid) \
        + _pos(off, dev, rid) * step.index_select(0, rid)
    return _array_value(flat, off)


# ---------------------------------------------------------------------------
# shape / membership

def _arrayish(v: Value) -> bool:
    return (v.is_array or isinstance(v.py, list)
            or (isinstance(v.data, torch.Tensor) and not v.is_scalar
                and v.data.dim() == 2))


_string_empty = _FUNCS["empty"]


@func("length")
def _f_length(args, env):
    v = args[0]
    if _arrayish(v):
        _, off, _ = as_array(v, env)
        return Value(_lens(off, env.device), v.valid)
    if v.dictionary is None:
        raise EvalError("length() expects a string column")
    lut = np.array([len(s) for s in v.dictionary.values] or [0],
                   dtype=np.int64)
    return Value(_dict_map(v, lut), v.valid)


@func("empty")
def _f_empty(args, env):
    v = args[0]
    if _arrayish(v):
        _, off, _ = as_array(v, env)
        return Value(_lens(off, env.device) == 0, v.valid)
    return _string_empty(args, env)


@func("notEmpty")
def _f_notempty(args, env):
    v = args[0]
    if _arrayish(v):
        _, off, _ = as_array(v, env)
        return Value(_lens(off, env.device) != 0, v.valid)
    inner = _f_empty(args, env)
    return Value(~inner.data, inner.valid)


def _matches(args, env):
    flat, off, d = as_array(args[0], env)
    return flat == _needle(args[1], off, d, env), off


@func("has")
def _f_has(args, env):
    eq, off = _matches(args, env)
    return Value(_seg_sum(off, eq, torch.int64, env.device) > 0,
                 args[0].valid)


@func("indexOf")
def _f_indexof(args, env):
    eq, off = _matches(args, env)
    dev = env.device
    hit_pos = torch.where(eq, _pos(off, dev) + 1, INT32_MAX)
    first = _seg_reduce(off, hit_pos, "amin", INT32_MAX, dev)
    return Value(torch.where(first == INT32_MAX, 0, first), args[0].valid)


@func("countEqual")
def _f_countequal(args, env):
    eq, off = _matches(args, env)
    return Value(_seg_sum(off, eq, torch.int64, env.device), args[0].valid)


@func("hasAll")
def _f_hasall(args, env):
    return _has_set(args, env, all_of=True)


@func("hasAny")
def _f_hasany(args, env):
    return _has_set(args, env, all_of=False)


def _has_set(args, env, all_of: bool):
    """Per row, whether all (any) of b's elements are among a's, as the
    JAX package's Python sets decide it (1 equals 1.0, -0.0 equals 0.0, a
    NaN equals nothing): both sides' elements ranked together, each b
    element looked up by (row, rank) in a's pairs on the device."""
    dev = env.device
    fa, oa, da = as_array(args[0], env)
    fb, ob, db = as_array(args[1], env)
    if da is not None or db is not None:
        (fa, fb), _ = _unify_dicts([(fa, da), (fb, db)])
    fa, fb = _common([fa, fb])
    na = fa.shape[0]
    both = torch.cat([fa, fb])
    if both.is_floating_point():
        both = both + 0.0                       # -0.0 -> 0.0
    _, rank = torch.unique(both, return_inverse=True)
    width = int(rank.max()) + 2 if rank.numel() else 1
    ka = _rid(oa, dev) * width + rank[:na]
    rb = rank[na:]
    if both.is_floating_point():
        rb = torch.where(torch.isnan(fb), width - 1, rb)   # matches nothing
    member = torch.isin(_rid(ob, dev) * width + rb, ka)
    missing = _seg_sum(ob, ~member if all_of else member, torch.int64, dev)
    out = missing == 0 if all_of else missing > 0
    return Value(out, _both_valid(args[0], args[1]))


# ---------------------------------------------------------------------------
# element access / slicing / reordering

@func("arrayElement")
def _f_arrayelement(args, env):
    v = args[0]
    flat, off, d = as_array(v, env)
    n, dev = env.n_rows, env.device
    lens = _lens(off, dev)
    i = _dense(args[1], n, dev)
    # 1-based; negative = from the end; out of range -> default value
    pos = torch.where(i >= 0, i - 1, lens + i)
    in_range = (pos >= 0) & (pos < lens)
    starts = device_offsets(off, dev)[:-1]
    safe = torch.where(in_range, starts + torch.clamp(pos, min=0), 0)
    data = flat.index_select(0, safe) if offsets_total(off) else \
        torch.zeros(n, dtype=flat.dtype, device=dev)
    data = torch.where(in_range, data,
                       torch.tensor(NULL_ID if d is not None else 0,
                                    dtype=data.dtype, device=dev))
    if d is not None:
        # out-of-range string -> '' (ClickHouse default), not NULL
        data = torch.where(in_range, data, d.encode_one("", grow=True))
    return Value(data, v.valid, d, umax=v.umax)


def _gather(flat, src_lens, starts, d, valid, umax=None) -> Value:
    """A new array: row i is flat[starts[i] : starts[i] + src_lens[i]]."""
    out = _new_offsets(src_lens)
    data = take_runs(flat, starts, out.dev, out.total)
    return _array_value(data, out, d, valid, umax)


@func("arraySlice")
def _f_arrayslice(args, env):
    flat, off, d = as_array(args[0], env)
    n, dev = env.n_rows, env.device
    lens = _lens(off, dev)
    offset = _dense(args[1], n, dev)
    start = torch.where(offset > 0, offset - 1, lens + offset)
    start = torch.minimum(torch.clamp(start, min=0), lens)
    if len(args) > 2:
        length = torch.clamp(_dense(args[2], n, dev), min=0)
        stop = torch.minimum(torch.clamp(start + length, min=0), lens)
    else:
        stop = lens
    starts = device_offsets(off, dev)[:-1] + start
    return _gather(flat, torch.clamp(stop - start, min=0), starts, d,
                   args[0].valid, args[0].umax)


_string_reverse = _FUNCS.get("reverse")


@func("arrayReverse", "reverse")
def _f_arrayreverse(args, env):
    v = args[0]
    if not _arrayish(v):
        if v.is_string and _string_reverse is not None:
            return _string_reverse(args, env)   # reverse('abc') -> 'cba'
        raise EvalError("reverse() supports arrays and strings")
    flat, off, d = as_array(v, env)
    dev = env.device
    rid = _rid(off, dev)
    doff = device_offsets(off, dev)
    src = doff[1:].index_select(0, rid) + doff[:-1].index_select(0, rid) \
        - 1 - torch.arange(offsets_total(off), device=dev)
    return _array_value(flat.index_select(0, src), off, d, v.valid, v.umax)


def _scatter_parts(parts, out, dev):
    """Place each part's flat elements at their destinations in the new
    layout ``out``; parts: (flat, dest positions)."""
    flats = _common([f for f, _ in parts])
    data = torch.empty(out.total, dtype=flats[0].dtype, device=dev)
    for f, (_, dest) in zip(flats, parts):
        data[dest] = f
    return data


@func("arrayConcat")
def _f_arrayconcat(args, env):
    dev = env.device
    parts = [as_array(a, env) for a in args]
    flats, base = _unify_dicts([(f, d) for f, _, d in parts])
    offs = [o for _, o, _ in parts]
    n = env.n_rows
    lens = [_lens(o, dev) for o in offs]
    out = _new_offsets(sum(lens) if lens else
                       torch.zeros(n, dtype=torch.int64, device=dev))
    placed = []
    before = out.dev[:-1]
    for f, o, ln in zip(flats, offs, lens):
        rid = _rid(o, dev)
        placed.append((f, before.index_select(0, rid) + _pos(o, dev, rid)))
        before = before + ln
    return _array_value(_scatter_parts(placed, out, dev), out, base)


@func("arrayPushBack")
def _f_arraypushback(args, env):
    return _push(args, env, front=False)


@func("arrayPushFront")
def _f_arraypushfront(args, env):
    return _push(args, env, front=True)


def _push(args, env, front: bool):
    flat, off, d = as_array(args[0], env)
    n, dev = env.n_rows, env.device
    el = args[1]
    if isinstance(el.py, str):
        if d is None:
            if offsets_total(off) != 0:
                raise EvalError("cannot push a string onto a numeric array")
            d = StringDictionary()
        el_dev = torch.full((n,), d.encode_one(el.py, grow=True),
                            dtype=flat.dtype, device=dev)
    elif el.is_scalar:
        el_dev = el.data.expand(n)
    else:
        el_dev = el.data
    lens = _lens(off, dev)
    out = _new_offsets(lens + 1)
    rid = _rid(off, dev)
    shift = 1 if front else 0
    dest_old = out.dev[:-1].index_select(0, rid) + shift + _pos(off, dev, rid)
    dest_new = out.dev[:-1] if front else out.dev[1:] - 1
    if flat.dtype != el_dev.dtype:
        # the JAX package casts each side to the other's dtype (a numeric
        # pushed value to the array's), then concatenates
        flat, el_dev = flat.to(el_dev.dtype), \
            el_dev.to(flat.dtype) if d is None else el_dev
    data = _scatter_parts([(flat, dest_old), (el_dev, dest_new)], out, dev)
    return _array_value(data, out, d, args[0].valid)


def _pop(args, env, front: bool):
    flat, off, d = as_array(args[0], env)
    dev = env.device
    starts = device_offsets(off, dev)[:-1] + (1 if front else 0)
    return _gather(flat, torch.clamp(_lens(off, dev) - 1, min=0),
                   starts, d, args[0].valid, args[0].umax)


@func("arrayPopBack")
def _f_arraypopback(args, env):
    return _pop(args, env, front=False)


@func("arrayPopFront")
def _f_arraypopfront(args, env):
    return _pop(args, env, front=True)


def _sort_perm_within_rows(off, keys: torch.Tensor, device,
                           descending=False) -> torch.Tensor:
    """Stable permutation ordering elements within each row by key: a
    stable sort by key, then a stable sort by row id (np.lexsort((keys,
    rid)) in the JAX package)."""
    if descending:
        keys = -keys.to(torch.float64) if keys.is_floating_point() \
            else -keys.to(torch.int64)
    elif keys.dtype == torch.bool:
        keys = keys.to(torch.int64)
    p1 = torch.sort(keys, stable=True).indices
    p2 = torch.sort(_rid(off, device).index_select(0, p1),
                    stable=True).indices
    return p1.index_select(0, p2)


def _decode_keys(flat, d, device):
    """Sort keys of the flat elements: numbers themselves; strings the
    rank of their first 64 characters (the JAX package's "U64" decode),
    NULL as ''."""
    if d is None:
        return flat
    vals = [s[:64] for s in d.values] + [""]
    _, ranks = np.unique(np.array(vals, dtype=object).astype(str),
                         return_inverse=True)
    lut = to_tensor(ranks.astype(np.int64), device)
    return lut[torch.where(flat == NULL_ID, len(vals) - 1, flat).long()]


def _sorted(args, env, descending: bool):
    flat, off, d = as_array(args[0], env)
    perm = _sort_perm_within_rows(off, _decode_keys(flat, d, env.device),
                                  env.device, descending)
    return _array_value(flat.index_select(0, perm), off, d, args[0].valid,
                        args[0].umax)


@func("arraySort")
def _f_arraysort(args, env):
    return _sorted(args, env, descending=False)


@func("arrayReverseSort")
def _f_arrayreversesort(args, env):
    return _sorted(args, env, descending=True)


def _first_in_row(flat, off, device):
    """Per element: True where no earlier element of its row holds an
    equal value, as the JAX package's Python sets decide it (-0.0 equals
    0.0, every NaN is new)."""
    total = offsets_total(off)
    e = torch.arange(total, device=device)
    rid = _rid(off, device)
    cols = [rid]
    if flat.is_floating_point():
        x = flat.to(torch.float64) + 0.0          # -0.0 -> 0.0
        cols.append(torch.where(torch.isnan(x), e, -1))
        cols.append(torch.where(torch.isnan(x), 0.0, x).view(torch.int64))
    else:
        cols.append(flat.to(torch.int64))
    if total == 0:
        return torch.zeros(0, dtype=torch.bool, device=device)
    _, gid = torch.unique(torch.stack(cols, dim=1), dim=0,
                          return_inverse=True)
    first = torch.full((total,), total, dtype=torch.int64, device=device)
    first.scatter_reduce_(0, gid, e, "amin", include_self=True)
    return first.index_select(0, gid) == e


@func("arrayDistinct")
def _f_arraydistinct(args, env):
    flat, off, d = as_array(args[0], env)
    dev = env.device
    keep = _first_in_row(flat, off, dev)
    out = _new_offsets(_seg_sum(off, keep, torch.int64, dev))
    data = flat.index_select(0, torch.nonzero(keep).flatten())
    return _array_value(data, out, d, args[0].valid, args[0].umax)


@func("arrayUniq")
def _f_arrayuniq(args, env):
    flat, off, _ = as_array(args[0], env)
    keep = _first_in_row(flat, off, env.device)
    return Value(_seg_sum(off, keep, torch.int64, env.device), args[0].valid)


@func("arrayEnumerate")
def _f_arrayenumerate(args, env):
    _, off, _ = as_array(args[0], env)
    return _array_value(_pos(off, env.device) + 1, off, None, args[0].valid)


@func("arrayStringConcat")
def _f_arraystringconcat(args, env):
    flat, off, d = as_array(args[0], env)
    sep = args[1].py if len(args) > 1 else ""
    if d is None and offsets_total(off) > 0:
        raise EvalError("arrayStringConcat expects Array(String)")
    a = flat.cpu().numpy()
    off = np.asarray(off, dtype=np.int64)
    vals = [("" if i == NULL_ID else d.values[int(i)]) for i in a] \
        if d is not None else []
    out = [sep.join(vals[off[i]:off[i + 1]]) for i in range(len(off) - 1)]
    out_d = StringDictionary()
    ids = out_d.encode(out)
    return Value(to_tensor(ids, env.device), args[0].valid, out_d)


# ---------------------------------------------------------------------------
# aggregation over one row's elements

def _flat_numeric(flat, d):
    if d is not None:
        raise EvalError("expected a numeric array")
    return flat


@func("arraySum")
def _f_arraysum(args, env):
    flat, off, d = as_array(args[0], env)
    x = _flat_numeric(flat, d)
    acc = torch.float64 if x.is_floating_point() else torch.int64
    return Value(_seg_sum(off, x, acc, env.device), args[0].valid)


@func("arrayProduct")
def _f_arrayproduct(args, env):
    flat, off, d = as_array(args[0], env)
    x = _flat_numeric(flat, d).to(torch.float64)
    return Value(_seg_reduce(off, x, "prod", 1.0, env.device), args[0].valid)


def _extreme(args, env, op: str):
    flat, off, d = as_array(args[0], env)
    x = _flat_numeric(flat, d)
    if x.is_floating_point():
        init = np.inf if op == "amin" else -np.inf
    else:
        info = torch.iinfo(x.dtype)
        init = info.max if op == "amin" else info.min
    out = _seg_reduce(off, x, op, init, env.device)
    empty = _lens(off, env.device) == 0
    return Value(torch.where(empty, torch.zeros_like(out), out),
                 args[0].valid, umax=args[0].umax)


@func("arrayMin")
def _f_arraymin(args, env):
    return _extreme(args, env, "amin")


@func("arrayMax")
def _f_arraymax(args, env):
    return _extreme(args, env, "amax")


@func("arrayAvg")
def _f_arrayavg(args, env):
    flat, off, d = as_array(args[0], env)
    x = _flat_numeric(flat, d)
    s = _seg_sum(off, x, torch.float64, env.device)
    lens = _lens(off, env.device).to(torch.float64)
    return Value(torch.where(lens > 0, s / torch.clamp(lens, min=1.0),
                             torch.nan), args[0].valid)


@func("arrayCumSum")
def _f_arraycumsum(args, env):
    flat, off, d = as_array(args[0], env)
    dev = env.device
    x = _flat_numeric(flat, d)
    acc = torch.float64 if x.is_floating_point() else torch.int64
    cs = torch.cumsum(x.to(acc), 0)
    # subtract the running total at each row start
    starts = device_offsets(off, dev)[:-1]
    base = torch.where(starts > 0,
                       cs.index_select(0, torch.clamp(starts - 1, min=0))
                       if cs.numel() else torch.zeros_like(starts, dtype=acc),
                       0)
    out = cs - base.index_select(0, _rid(off, dev))
    return _array_value(out, off, None, args[0].valid)


# ---------------------------------------------------------------------------
# higher-order functions (lambda family)

class _ElemEnv(Env):
    """Environment over the flat element axis: lambda params bind to flat
    tensors, outer columns broadcast through one gather by the device row
    ids."""

    def __init__(self, parent: Env, off, binds: dict):
        self.parent = parent
        self.table = parent.table
        self.aliases = parent.aliases
        self.device = parent.device
        self.extra = dict(binds)
        self.subquery_runner = getattr(parent, "subquery_runner", None)
        self._off = off
        self._row_ids = None

    @property
    def n_rows(self) -> int:
        return offsets_total(self._off)

    @property
    def _rid(self) -> torch.Tensor:
        """The element row ids, made at the first outer column."""
        if self._row_ids is None:
            self._row_ids = _rid(self._off, self.device)
        return self._row_ids

    def resolve(self, ident):
        if ident.table is None and ident.name in self.extra:
            return self.extra[ident.name]
        v = self.parent.resolve(ident)
        if v.is_scalar:
            return v
        if v.is_array:
            raise EvalError("nested array columns inside lambdas "
                            "not supported")
        data = v.data.index_select(0, self._rid)
        valid = v.valid.index_select(0, self._rid) \
            if v.valid is not None else None
        return Value(data, valid, v.dictionary, umax=v.umax, u64=v.u64)


HOF_NAMES = {"arraymap", "arrayfilter", "arrayexists", "arrayall",
             "arraycount", "arrayfirst", "arrayfirstindex", "arraysum",
             "arraymin", "arraymax", "arrayavg", "arraysort",
             "arrayreversesort"}


def eval_hof(e: FuncCall, env: Env) -> Value:
    """Evaluate a higher-order array function: first arg is the lambda,
    remaining args are arrays zipped element-wise (FunctionArrayMapped.h)."""
    name = e.name.lower()
    if name not in HOF_NAMES:
        raise EvalError(f"{e.name} does not take a lambda argument")
    lam = e.args[0]
    if not isinstance(lam, Lambda):
        raise EvalError(f"{e.name}: first argument must be a lambda")
    arrs = [eval_expr(a, env) for a in e.args[1:]]
    if not arrs:
        raise EvalError(f"{e.name} expects at least one array")
    if len(lam.params) != len(arrs):
        raise EvalError(f"{e.name}: lambda takes {len(lam.params)} params "
                        f"but {len(arrs)} arrays given")
    dev = env.device
    parts = [as_array(a, env) for a in arrs]
    off = parts[0][1]
    doff = device_offsets(off, dev)
    for _, o, _ in parts[1:]:
        if o is not off and not torch.equal(device_offsets(o, dev), doff):
            raise EvalError(f"{e.name}: arrays must have equal sizes per row")
    binds = {p: Value(f, None, d, umax=a.umax)
             for p, (f, _, d), a in zip(lam.params, parts, arrs)}
    body = eval_expr(lam.body, _ElemEnv(env, off, binds))
    flat0, _, d0 = parts[0]
    total = offsets_total(off)

    def mapped():
        return body.data.expand(total) if body.is_scalar else body.data

    if name == "arraymap":
        return _array_value(mapped(), off, body.dictionary, umax=body.umax)
    if name in ("arraysort", "arrayreversesort"):
        perm = _sort_perm_within_rows(off, mapped(), dev,
                                      descending=(name == "arrayreversesort"))
        return _array_value(flat0.index_select(0, perm), off, d0)
    if name in ("arraysum", "arraymin", "arraymax", "arrayavg"):
        # reduce the mapped values
        impl = {"arraysum": _f_arraysum, "arraymin": _f_arraymin,
                "arraymax": _f_arraymax, "arrayavg": _f_arrayavg}[name]
        return impl([_array_value(mapped(), off, umax=body.umax)], env)
    mask = as_bool_mask(body, total)
    if name == "arrayfilter":
        out = _new_offsets(_seg_sum(off, mask, torch.int64, dev))
        data = flat0.index_select(0, torch.nonzero(mask).flatten())
        return _array_value(data, out, d0, umax=arrs[0].umax)
    if name == "arrayexists":
        return Value(_seg_sum(off, mask, torch.int64, dev) > 0)
    if name == "arrayall":
        return Value(_seg_sum(off, ~mask, torch.int64, dev) == 0)
    if name == "arraycount":
        return Value(_seg_sum(off, mask, torch.int64, dev))
    if name == "arrayfirstindex":
        pos1 = _pos(off, dev) + 1
        first = _seg_reduce(off, torch.where(mask, pos1, INT32_MAX), "amin",
                            INT32_MAX, dev)
        return Value(torch.where(first == INT32_MAX, 0, first))
    # arrayFirst
    gidx = torch.arange(total, device=dev)
    first = _seg_reduce(off, torch.where(mask, gidx, INT32_MAX), "amin",
                        INT32_MAX, dev)
    hasv = first != INT32_MAX
    safe = torch.where(hasv, first, 0)
    n = len(off) - 1
    data = flat0.index_select(0, safe) if total else \
        torch.zeros(n, dtype=flat0.dtype, device=dev)
    data = torch.where(hasv, data,
                       torch.tensor(NULL_ID if d0 is not None else 0,
                                    dtype=data.dtype, device=dev))
    if d0 is not None:
        data = torch.where(hasv, data, d0.encode_one("", grow=True))
    return Value(data, None, d0, umax=arrs[0].umax)
