"""Expression evaluation: AST -> torch tensors over a table environment.

The port of myscaledb_tpu/exec/expr.py: ``Value``, ``Env``, ``eval_expr``
over literals, identifiers, vector literals, comparisons, arithmetic
(Date/DateTime arithmetic and literals included), AND/OR/NOT, IN (list) and
BETWEEN, and the scalar function registry: math, LIKE, the string functions
evaluated on the dictionary, ``coalesce``/``nullIf``, and ``IN
(subquery)`` through the executor's ``Env.subquery_runner`` (membership
by ``torch.isin`` on the device).  exec/arrays.py (array functions and,
for a call with a lambda argument, the higher-order functions),
exec/datetime_fns.py and exec/scalar_fns.py register the rest at the
bottom of this module.  ``dictGet*`` probe runtime/dictionaries.py's
sorted keys or direct table on the device; ``joinGet*`` probe a Join-engine
table's keys, sorted once per mutation epoch.

String semantics ride the dictionary: predicates on strings are evaluated
once over the (small) dictionary on the host, then mapped to rows with one
device gather.  Validity masks propagate through arithmetic and
comparisons; WHERE treats NULL as false.

Type promotion: the JAX package runs with x64 on, and its literals are
weakly typed 0-d arrays (int64/float64) that take a column's type within
the same category.  Literals here are 0-d int64/float64 tensors, and
torch's rule for zero-dimensional operands gives the same result types.

UInt64: torch has next to no uint64 arithmetic, so a UInt64 value is an
int64 tensor holding the same 64 bits (``Value.u64``).  Wrapping ``+``,
``-`` and ``*`` give the unsigned results bit for bit; comparisons, ``%``
and ORDER BY read the bits as unsigned, and printing casts them back to
uint64.  Hash functions return such values, mostly above 2^63-1.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from myscaledb_tpu_torch.core.types import DataType, physical_dtype
from myscaledb_tpu_torch.core.table import Table, to_tensor
from myscaledb_tpu_torch.core.dictionary import StringDictionary, NULL_ID
from myscaledb_tpu_torch.sql.ast import (Expr, Literal, VectorLiteral, Ident,
                                         BinOp, UnOp, FuncCall, InList,
                                         Between, WindowCall, InSubquery,
                                         Lambda)

INT64_MAX = 2 ** 63 - 1
# the largest value of each unsigned type stored widened to a signed tensor
# (UInt64 up to 2^63-1, what the int64 store holds)
_WIDENED_UNSIGNED = {DataType.UINT16: 2 ** 16 - 1,
                     DataType.UINT32: 2 ** 32 - 1,
                     DataType.UINT64: INT64_MAX}
# the logical type of a widened UInt16/32 value, from its largest value
UNSIGNED_OF_MAX = {m: t for t, m in _WIDENED_UNSIGNED.items()
                   if t is not DataType.UINT64}


class EvalError(ValueError):
    pass


@dataclass
class Value:
    """An evaluated expression: tensor (n,) / 0-d tensor scalar / string
    literal / vector literal (numpy), with optional validity and string
    dictionary."""
    data: object
    valid: Optional[object] = None          # bool (n,) tensor or None
    dictionary: Optional[StringDictionary] = None
    is_scalar: bool = False
    py: object = None                       # python literal (str/None/bool/num)
    offsets: object = None                  # np int64 (n+1,) for ARRAY values
    dt: object = None                       # logical DataType override
                                            # (DATE/DATETIME tagging)
    umax: Optional[int] = None              # for a UInt16/32/64 value,
                                            # stored widened to a signed
                                            # tensor: its largest value
    u64: bool = False                       # int64 data holding UInt64
                                            # bits (umax None: values may
                                            # pass 2^63-1)

    @property
    def is_string(self) -> bool:
        return self.dictionary is not None and self.offsets is None \
            or isinstance(self.py, str)

    @property
    def is_array(self) -> bool:
        return self.offsets is not None


class Env:
    """Name -> Column resolution over one table, on ``device``.  The
    executor sets ``subquery_runner`` (SelectQuery -> Table) where ``IN
    (subquery)`` may be evaluated."""

    subquery_runner = None
    dictionaries = None        # name -> runtime.dictionaries.Dictionary
    session = None             # the Session, for joinGet's Join tables

    def __init__(self, table: Table, aliases: Optional[dict] = None,
                 device=None):
        self.table = table
        self.aliases = aliases or {}          # alias -> prefix used in column names
        self.extra: dict[str, Value] = {}     # computed columns (e.g. distance)
        self.device = device if device is not None else table.device
        if self.device is None:
            raise ValueError("Env needs a device (the table has no "
                             "device-resident column)")

    @property
    def n_rows(self) -> int:
        return self.table.n_rows

    def resolve(self, ident: Ident) -> Value:
        for name in self._candidates(ident):
            if name in self.extra:
                return self.extra[name]
            if name in self.table:
                c = self.table[name]
                tag = c.dtype if c.dtype in (DataType.DATE,
                                             DataType.DATETIME) else None
                data, valid = c.data, c.valid
                if c.is_host:            # host-resident column: the
                    data = to_tensor(data, self.device)   # expression
                    valid = to_tensor(valid, self.device) \
                        if valid is not None else None    # needs it here
                # an ARRAY value's umax is its elements'
                umax = _WIDENED_UNSIGNED.get(
                    c.field.elem if c.offsets is not None else c.dtype)
                if c.dtype is DataType.UINT64 and bool((data < 0).any()):
                    # UInt64 bits past 2^63-1 (a hash a subquery or INSERT
                    # ... SELECT carried into a column): not bounded
                    umax = None
                return Value(data, valid, c.dictionary,
                             offsets=c.offsets, dt=tag, umax=umax,
                             u64=c.dtype is DataType.UINT64)
        raise EvalError(f"unknown column {ident.qualified!r} "
                        f"(have {self.table.column_names})")

    def _candidates(self, ident: Ident):
        if ident.table:
            yield f"{ident.table}.{ident.name}"
            if self.aliases.get(ident.table) is not None:
                yield self.aliases[ident.table] + ident.name
            yield ident.name
        else:
            yield ident.name


# ---------------------------------------------------------------------------
# helpers

def _both_valid(a: Value, b: Value):
    if a.valid is None:
        return b.valid
    if b.valid is None:
        return a.valid
    return a.valid & b.valid


def as_bool_mask(v: Value, n: int) -> torch.Tensor:
    """WHERE semantics: NULL -> False; numeric nonzero -> True."""
    d = v.data
    if v.is_scalar:
        d = d.expand(n)
    if d.dtype != torch.bool:
        d = d != 0
    if v.valid is not None:
        d = d & v.valid
    return d


def _dict_map(v: Value, table_np: np.ndarray) -> torch.Tensor:
    """Map dictionary ids through a host-computed per-id table (strings are
    evaluated on the dictionary, rows get one gather)."""
    lut = to_tensor(table_np, v.data.device)
    ids = torch.clamp(v.data, 0, len(table_np) - 1).long()
    return lut[ids]


def _encode_str_literal(lit: str, dictionary: StringDictionary) -> int:
    return dictionary.encode_one(lit, grow=False)   # -2 = matches nothing


def _scalar(x, device) -> torch.Tensor:
    """Python literal -> 0-d tensor in the dtype jnp.asarray gives it with
    x64 on (bool, int64, float64)."""
    if isinstance(x, bool):
        return torch.tensor(x, dtype=torch.bool, device=device)
    if isinstance(x, int):
        return torch.tensor(x, dtype=torch.int64, device=device)
    return torch.tensor(float(x), dtype=torch.float64, device=device)


# ---------------------------------------------------------------------------
# scalar function registry (ClickHouse-compatible names)

_FUNCS: dict[str, Callable] = {}
# the vector search functions resolve in the executor and nowhere here,
# in the JAX package too: a reference the executor did not resolve fails
# with the JAX package's error text
DIST_FNS = frozenset({"distance", "batch_distance", "l2distance",
                      "cosinedistance", "dotproduct"})


def func(*names):
    def deco(f):
        for n in names:
            _FUNCS[n.lower()] = f
        return f
    return deco


def _numeric(v: Value, n: int) -> torch.Tensor:
    if v.is_string:
        raise EvalError("expected numeric argument, got string")
    return v.data


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


@func("abs")
def _f_abs(args, env):
    if args[0].u64:
        return args[0]          # unsigned: its own absolute value
    return Value(torch.abs(_numeric(args[0], env.n_rows)), args[0].valid)

@func("negate")
def _f_negate(args, env):
    return _negate(args[0], env)


def _negate(v: Value, env) -> Value:
    # -x of a UInt64 wraps modulo 2^64 in the JAX package, as int64 bits do
    return Value(-_numeric(v, env.n_rows), v.valid, u64=_is_bits(v))

@func("sqrt")
def _f_sqrt(args, env):
    return Value(torch.sqrt(_f32(_numeric(args[0], env.n_rows))),
                 args[0].valid)

@func("exp")
def _f_exp(args, env):
    return Value(torch.exp(_f32(_numeric(args[0], env.n_rows))),
                 args[0].valid)

@func("log", "ln")
def _f_log(args, env):
    return Value(torch.log(_f32(_numeric(args[0], env.n_rows))),
                 args[0].valid)

@func("floor")
def _f_floor(args, env):
    return Value(torch.floor(_numeric(args[0], env.n_rows)), args[0].valid)

@func("ceil", "ceiling")
def _f_ceil(args, env):
    return Value(torch.ceil(_numeric(args[0], env.n_rows)), args[0].valid)

@func("round")
def _f_round(args, env):
    x = _numeric(args[0], env.n_rows)
    if len(args) > 1:
        scale = 10.0 ** int(args[1].py)
        return Value(torch.round(x * scale) / scale, args[0].valid)
    return Value(torch.round(x), args[0].valid)

@func("pow", "power")
def _f_pow(args, env):
    a = _f32(_numeric(args[0], env.n_rows))
    b = _f32(_numeric(args[1], env.n_rows))
    return Value(torch.pow(a, b), _both_valid(args[0], args[1]))

def _extreme(args, env, fn):
    out = _numeric(args[0], env.n_rows)
    valid = args[0].valid
    for a in args[1:]:
        out = fn(out, _numeric(a, env.n_rows))
        valid = _both_valid(Value(out, valid), a)
    return Value(out, valid)

@func("greatest")
def _f_greatest(args, env):
    return _extreme(args, env, torch.maximum)

@func("least")
def _f_least(args, env):
    return _extreme(args, env, torch.minimum)

@func("toInt32")
def _f_toint32(args, env):
    return Value(_numeric(args[0], env.n_rows).to(torch.int32),
                 args[0].valid)

@func("toInt64")
def _f_toint64(args, env):
    return Value(_numeric(args[0], env.n_rows).to(torch.int64),
                 args[0].valid)

@func("toFloat32")
def _f_tofloat32(args, env):
    return Value(_f32(_numeric(args[0], env.n_rows)), args[0].valid)

@func("toFloat64")
def _f_tofloat64(args, env):
    return Value(_numeric(args[0], env.n_rows).to(torch.float64),
                 args[0].valid)

@func("intDiv")
def _f_intdiv(args, env):
    a = _numeric(args[0], env.n_rows)
    b = _numeric(args[1], env.n_rows)
    valid = _both_valid(args[0], args[1])
    if _is_bits(args[0]) and not b.is_floating_point():
        m = _positive_literal(args[1], "intDiv")
        return Value(_u64_div(a.to(torch.int64), m), valid, u64=True)
    return Value(_trunc_div(a, b), valid)

def _trunc_div(a, b):
    """intDiv: the quotient rounded toward zero, as ClickHouse gives it
    (intDiv(-5, 3) = -1); the JAX package floors (ROADMAP section 3)."""
    return torch.div(a, b, rounding_mode="trunc")


@func("modulo")
def _f_modulo(args, env):
    if _is_bits(args[0]) or _is_bits(args[1]):
        return _arith("%", args[0], args[1], env)
    a = _numeric(args[0], env.n_rows)
    b = _numeric(args[1], env.n_rows)
    return Value(torch.fmod(a, b), _both_valid(args[0], args[1]))

@func("plus")
def _f_plus(args, env):
    return _arith("+", args[0], args[1], env)

@func("minus")
def _f_minus(args, env):
    return _arith("-", args[0], args[1], env)

@func("multiply")
def _f_multiply(args, env):
    return _arith("*", args[0], args[1], env)

@func("divide")
def _f_divide(args, env):
    return _arith("/", args[0], args[1], env)

@func("isNull")
def _f_isnull(args, env):
    v = args[0]
    if v.valid is None:
        if v.is_scalar:
            return Value(_scalar(v.py is None, env.device))
        return Value(torch.zeros(env.n_rows, dtype=torch.bool,
                                 device=env.device))
    return Value(~v.valid)

@func("isNotNull")
def _f_isnotnull(args, env):
    v = args[0]
    if v.valid is None:
        if v.is_scalar:
            return Value(_scalar(v.py is not None, env.device))
        return Value(torch.ones(env.n_rows, dtype=torch.bool,
                                device=env.device))
    return Value(v.valid)


@func("unhex")
def _f_unhex(args, env):
    return _dict_transform(args[0],
                           lambda s: bytes.fromhex(s).decode("latin-1"))


@func("unbin")
def _f_unbin(args, env):
    def conv(s: str) -> str:
        if not s:
            return ""
        pad = (-len(s)) % 8
        i = int(s, 2)
        return i.to_bytes((len(s) + pad) // 8, "big").decode("latin-1")
    return _dict_transform(args[0], conv)


@func("char")
def _f_char(args, env):
    # char(n1, n2, ...) builds a string per row from the bytes n_i mod 256
    cols = [_numeric(a, env.n_rows) for a in args]
    if all(a.is_scalar for a in args):
        s = "".join(chr(int(c) & 0xFF) for c in cols)
        return Value(None, is_scalar=True, py=s)
    n = env.n_rows
    mat = np.stack([np.broadcast_to(c.cpu().numpy(), (n,)) for c in cols],
                   axis=1)
    uniq, inv = np.unique(mat, axis=0, return_inverse=True)
    sd = StringDictionary()
    remap = sd.encode(["".join(chr(int(c) & 0xFF) for c in row)
                       for row in uniq])
    return Value(to_tensor(remap[inv.reshape(-1)], env.device), None, sd)


def _like_to_re(pat: str, icase: bool = False) -> re.Pattern:
    # backslash escapes the next char (\% -> literal %, \_ -> literal _,
    # \\ -> backslash), matching the reference's likePatternToRegexp
    # (src/Common/likePatternToRegexp.cpp)
    out = []
    i = 0
    while i < len(pat):
        ch = pat[i]
        if ch == "\\" and i + 1 < len(pat):
            out.append(re.escape(pat[i + 1]))
            i += 2
            continue
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
        i += 1
    return re.compile("^" + "".join(out) + "$",
                      re.DOTALL | (re.IGNORECASE if icase else 0))


def _like_impl(args, negate: bool, icase: bool) -> Value:
    v, pat = args[0], args[1]
    if v.dictionary is None or not isinstance(pat.py, str):
        raise EvalError("LIKE needs a string column and literal pattern")
    rx = _like_to_re(pat.py, icase)
    lut = np.array([bool(rx.match(s)) for s in v.dictionary.values],
                   dtype=bool)
    if negate:
        lut = ~lut
    if len(lut) == 0:
        lut = np.zeros(1, dtype=bool)
    return Value(_dict_map(v, lut), v.valid)


@func("like")
def _f_like(args, env):
    return _like_impl(args, False, False)


@func("notLike")
def _f_not_like(args, env):
    return _like_impl(args, True, False)


@func("ilike")
def _f_ilike(args, env):
    return _like_impl(args, False, True)


@func("notILike")
def _f_not_ilike(args, env):
    return _like_impl(args, True, True)


def _full(v: Value, n: int) -> torch.Tensor:
    """A value's data as (n,) rows (scalars broadcast)."""
    return v.data.expand(n) if v.is_scalar else v.data


def _is_null_literal(v: Value) -> bool:
    return v.is_scalar and v.py is None and v.dictionary is None


def _string_branch_ids(v: Value, env, d: StringDictionary):
    """Encode one string branch (if/multiIf/transform/coalesce) into
    dictionary d; returns (ids, valid)."""
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


@func("coalesce", "ifNull")
def _f_coalesce(args, env):
    out = args[0]
    for nxt in args[1:]:
        if out.valid is None:
            break
        if out.is_string and nxt.is_string:
            # strings of two dictionaries: both re-encoded into one (the
            # JAX package mixes the ids of the two: ROADMAP section 3)
            d = StringDictionary()
            a, _ = _string_branch_ids(out, env, d)
            b, _ = _string_branch_ids(nxt, env, d)
            valid = None if nxt.valid is None else out.valid | nxt.valid
            out = Value(torch.where(out.valid, a, b), valid, d)
            continue
        a = _full(out, env.n_rows)
        b = _full(nxt, env.n_rows)
        if nxt.is_scalar:
            b = b.to(a.dtype)
        data = torch.where(out.valid, a, b)
        valid = None if nxt.valid is None else out.valid | nxt.valid
        out = Value(data, valid, out.dictionary)
    return out


@func("nullIf")
def _f_nullif(args, env):
    a, b = args[0], args[1]
    eq = as_bool_mask(_compare("=", a, b, env), env.n_rows)
    valid = ~eq
    if a.valid is not None:
        valid = valid & a.valid
    return Value(_full(a, env.n_rows), valid, a.dictionary)


@func("tuple")
def _f_tuple(args, env):
    raise EvalError("tuple values are only supported in comparisons")


# -- math ---------------------------------------------------------------

def _cbrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.pow(torch.abs(x), 1.0 / 3.0)


for _name, _fn in [("sin", torch.sin), ("cos", torch.cos),
                   ("tan", torch.tan), ("asin", torch.asin),
                   ("acos", torch.acos), ("atan", torch.atan),
                   ("sinh", torch.sinh), ("cosh", torch.cosh),
                   ("tanh", torch.tanh), ("exp2", torch.exp2),
                   ("log2", torch.log2), ("log10", torch.log10),
                   ("cbrt", _cbrt)]:
    def _make(fn):
        def impl(args, env):
            return Value(fn(_f32(_numeric(args[0], env.n_rows))),
                         args[0].valid)
        return impl
    _FUNCS[_name] = _make(_fn)


@func("sign")
def _f_sign(args, env):
    return Value(torch.sign(_numeric(args[0], env.n_rows)), args[0].valid)


@func("pi")
def _f_pi(args, env):
    return Value(_scalar(math.pi, env.device), is_scalar=True, py=math.pi)


@func("sqr")
def _f_sqr(args, env):
    x = _numeric(args[0], env.n_rows)
    return Value(x * x, args[0].valid)


# -- string functions (evaluated on the dictionary, one gather per row) --

def _dict_transform(v: Value, fn) -> Value:
    """Apply a python string->string fn over dictionary values; returns a
    STRING Value with a fresh dictionary."""
    if v.dictionary is None:
        if isinstance(v.py, str):
            return Value(None, is_scalar=True, py=fn(v.py))
        raise EvalError("expected a string column")
    return Value(v.data, v.valid,
                 StringDictionary([fn(s) for s in v.dictionary.values]))


@func("lowerUTF8", "lower")
def _f_lower_utf8(args, env):
    return _dict_transform(args[0], str.lower)


@func("upper", "upperUTF8")
def _f_upper(args, env):
    return _dict_transform(args[0], str.upper)


@func("trim")
def _f_trim(args, env):
    return _dict_transform(args[0], str.strip)


@func("reverse")
def _f_reverse(args, env):
    return _dict_transform(args[0], lambda s: s[::-1])


@func("substring", "substr")
def _f_substring(args, env):
    v = args[0]
    start = int(args[1].py)          # 1-based like ClickHouse
    length = int(args[2].py) if len(args) > 2 else None

    def cut(s):
        i = start - 1 if start > 0 else len(s) + start
        return s[i:i + length] if length is not None else s[i:]
    return _dict_transform(v, cut)


def host_rows(v: Value) -> np.ndarray:
    """A numeric value's rows on the host in the JAX package's numpy dtype:
    UInt64 bits read unsigned, widened UInt16/32 narrowed back."""
    x = v.data.cpu().numpy()
    if v.u64:
        return x.view(np.uint64) if x.dtype == np.int64 else x
    if v.umax in UNSIGNED_OF_MAX:
        return x.astype(physical_dtype(UNSIGNED_OF_MAX[v.umax]))
    return x


def _as_string_parts(a: Value, env) -> tuple:
    """(ids or None, dictionary or literal-str) for one concat operand."""
    if a.dictionary is not None and a.offsets is None:
        return a.data.cpu().numpy(), a.dictionary
    if isinstance(a.py, str):
        return None, a.py
    if a.py is not None and a.is_scalar:
        return None, str(a.py)
    # numeric column: stringified via its unique values (toString semantics)
    uniq, inv = np.unique(host_rows(a), return_inverse=True)
    sd = StringDictionary([_ch_num_str(x) for x in uniq])
    return inv.astype(np.int32), sd


def _ch_num_str(x) -> str:
    if isinstance(x, (np.floating, float)):
        f = float(x)
        return str(int(f)) if f.is_integer() else repr(f)
    if isinstance(x, (np.bool_, bool)):
        return "true" if x else "false"
    return str(int(x))


def _and_valid(args):
    valid = None
    for a in args:
        if a.valid is not None:
            valid = a.valid if valid is None else valid & a.valid
    return valid


@func("concat")
def _f_concat(args, env):
    # column-column concat via unique id-combination dictionaries: only the
    # distinct (id1, id2, ...) combinations are materialized as strings,
    # rows stay device ids (reference concat is per-row byte appends,
    # src/Functions/concat.cpp)
    parts = [_as_string_parts(a, env) for a in args]
    col_parts = [p for p in parts if p[0] is not None]
    if not col_parts:
        return Value(None, is_scalar=True,
                     py="".join(p[1] for p in parts))
    ids = [np.where(p[0] == NULL_ID, len(p[1].values), p[0])
           for p in col_parts]   # NULL -> sentinel decodes to ""
    combo = np.stack(ids, axis=1)
    uniq, inv = np.unique(combo, axis=0, return_inverse=True)
    out_strings = []
    for row in uniq:
        buf = []
        ci = 0
        for pid, pdict in parts:
            if pid is None:
                buf.append(pdict)
            else:
                vid = int(row[ci])
                ci += 1
                buf.append("" if vid >= len(pdict.values)
                           else pdict.values[vid])
        out_strings.append("".join(buf))
    newdict = StringDictionary()
    remap = newdict.encode(out_strings)   # dedups equal results
    return Value(to_tensor(remap[inv.reshape(-1)], env.device),
                 _and_valid(args), newdict)


@func("toString")
def _f_tostring(args, env):
    v = args[0]
    if v.dictionary is not None:
        return v
    if v.is_scalar:
        return Value(None, is_scalar=True, py=_ch_num_str(
            v.py if v.py is not None else host_rows(v)[()]))
    if v.dt is not None:
        # Date/DateTime: format via the civil calendar (host, per unique)
        import datetime as _dtm
        uniq, inv = np.unique(v.data.cpu().numpy(), return_inverse=True)
        if v.dt is DataType.DATE:
            strs = [str(_dtm.date(1970, 1, 1) + _dtm.timedelta(days=int(x)))
                    for x in uniq]
        else:
            strs = [str(_dtm.datetime(1970, 1, 1) +
                        _dtm.timedelta(seconds=int(x))) for x in uniq]
        sd = StringDictionary()
        remap = sd.encode(strs)
        return Value(to_tensor(remap[inv], env.device), v.valid, sd)
    ids, sd = _as_string_parts(v, env)
    return Value(to_tensor(ids, env.device), v.valid, sd)


def _ragged_ids(per_id: list, v: Value, env):
    """Array(String) rows from one list of strings per dictionary id:
    (flat ids tensor, host offsets, dictionary); NULL rows are empty."""
    newdict = StringDictionary()
    enc = [newdict.encode(p) for p in per_id]
    lens = np.array([len(p) for p in per_id] or [0], dtype=np.int64)
    ids = v.data.cpu().numpy()
    safe = np.clip(ids, 0, max(len(enc) - 1, 0))
    row_lens = np.where(ids == NULL_ID, 0, lens[safe])
    offsets = np.concatenate([np.zeros(1, dtype=np.int64),
                              np.cumsum(row_lens)])
    empty = np.zeros(0, dtype=np.int32)
    flat = np.concatenate([enc[i] if ids[j] != NULL_ID else empty
                           for j, i in enumerate(safe)]) \
        if len(ids) and enc else empty
    return to_tensor(flat.astype(np.int32), env.device), offsets, newdict


@func("splitByChar", "splitByString")
def _f_splitbychar(args, env):
    sep, v = args[0].py, args[1]
    if v.dictionary is None:
        raise EvalError("splitByChar expects a string column")
    flat, offsets, nd = _ragged_ids([s.split(sep)
                                     for s in v.dictionary.values], v, env)
    return Value(flat, v.valid, nd, offsets=offsets)


@func("replaceAll", "replace")
def _f_replaceall(args, env):
    v, pat, rep = args[0], args[1].py, args[2].py
    return _dict_transform(v, lambda s: s.replace(pat, rep))


@func("replaceOne")
def _f_replaceone(args, env):
    v, pat, rep = args[0], args[1].py, args[2].py
    return _dict_transform(v, lambda s: s.replace(pat, rep, 1))


@func("replaceRegexpAll")
def _f_replaceregexpall(args, env):
    v, pat, rep = args[0], args[1].py, args[2].py
    rx = re.compile(pat)
    rep2 = re.sub(r"\\(\d)", r"\\\1", rep)
    return _dict_transform(v, lambda s: rx.sub(rep2, s))


@func("extract")
def _f_extract(args, env):
    v, pat = args[0], args[1].py
    rx = re.compile(pat)

    def ex(s):
        m = rx.search(s)
        if m is None:
            return ""
        return m.group(1) if m.groups() else m.group(0)
    return _dict_transform(v, ex)


def _pad(args, left: bool) -> Value:
    v, width = args[0], int(args[1].py)
    fill = args[2].py if len(args) > 2 else " "

    def pad(s):
        need = width - len(s)
        if need <= 0:
            return s[:width]
        reps = (fill * (need // len(fill) + 1))[:need]
        return reps + s if left else s + reps
    return _dict_transform(v, pad)


@func("leftPad", "lpad")
def _f_leftpad(args, env):
    return _pad(args, True)


@func("rightPad", "rpad")
def _f_rightpad(args, env):
    return _pad(args, False)


@func("repeat")
def _f_repeat(args, env):
    v, n_ = args[0], int(args[1].py)
    return _dict_transform(v, lambda s: s * n_)


def _dict_lut(v: Value, fn, dtype, empty) -> Value:
    """A per-row value computed once per dictionary entry (one gather)."""
    lut = np.array([fn(s) for s in v.dictionary.values] or [empty],
                   dtype=dtype)
    return Value(_dict_map(v, lut), v.valid)


@func("startsWith")
def _f_startswith(args, env):
    pat = args[1].py
    return _dict_lut(args[0], lambda s: s.startswith(pat), bool, False)


@func("endsWith")
def _f_endswith(args, env):
    pat = args[1].py
    return _dict_lut(args[0], lambda s: s.endswith(pat), bool, False)


@func("position")
def _f_position(args, env):
    pat = args[1].py
    return _dict_lut(args[0], lambda s: s.find(pat) + 1, np.int64, 0)


@func("empty")
def _f_empty(args, env):
    return _dict_lut(args[0], lambda s: len(s) == 0, bool, True)


@func("match")
def _f_match(args, env):
    rx = re.compile(args[1].py)
    return _dict_lut(args[0], lambda s: bool(rx.search(s)), bool, False)


# date/time functions live in exec/datetime_fns.py (registered from the
# bottom of this module)


# ---------------------------------------------------------------------------
# core evaluation

def _coerce_date_literal(a: Value, b: Value, env: Env):
    """If one side is a DATE/DATETIME value and the other a string literal,
    parse the literal ('2024-05-01' [..time]) to days/seconds since epoch."""
    from myscaledb_tpu_torch.exec.datetime_fns import parse_date_literal
    for col, lit in ((a, b), (b, a)):
        if col.dt in (DataType.DATE, DataType.DATETIME) and \
                isinstance(lit.py, str):
            n = parse_date_literal(lit.py, col.dt)
            repl = Value(_scalar(n, env.device), is_scalar=True, py=n,
                         dt=col.dt)
            return (a, repl) if lit is b else (repl, b)
    return a, b


def _is_bits(v: Value) -> bool:
    """A UInt64 value whose int64 bits may stand for values past 2^63-1
    (a hash, toUInt64): stored UInt64 columns hold at most 2^63-1."""
    return v.u64 and v.umax is None


def _arith(op: str, a: Value, b: Value, env: Env) -> Value:
    a, b = _coerce_date_literal(a, b, env)
    if a.is_string or b.is_string:
        raise EvalError(f"arithmetic {op!r} on strings")
    # Date ± N stays a Date; Date - Date is a plain day count
    tag = None
    if op in ("+", "-"):
        tag = a.dt or b.dt
        if op == "-" and a.dt is not None and b.dt is not None:
            tag = None
    x = _numeric(a, env.n_rows)
    y = _numeric(b, env.n_rows)
    floats = x.is_floating_point() or y.is_floating_point()
    if (_is_bits(a) or _is_bits(b)) and not floats:
        return _u64_arith(op, a, x, b, y)
    if op in ("+", "*") and (a.umax is not None or b.umax is not None) \
            and not floats:
        return _unsigned_arith(op, a, x, b, y)
    if op == "+":
        d = x + y
    elif op == "-":
        d = x - y
    elif op == "*":
        d = x * y
    elif op == "/":
        # ClickHouse: division always yields float (Float64 there; f32 in
        # the JAX package, whose TPU has no f64 compute)
        d = _f32(x) / _f32(y)
    elif op == "%":
        d = torch.fmod(x, y)          # truncated, as ClickHouse: -5 % 3 = -2
    else:
        raise EvalError(f"unknown arithmetic op {op}")
    if tag is not None and not d.is_floating_point():
        return Value(d, _both_valid(a, b), dt=tag)
    return Value(d, _both_valid(a, b))


def _positive_literal(v: Value, what: str) -> int:
    if not (v.is_scalar and isinstance(v.py, int) and not
            isinstance(v.py, bool) and v.py > 0):
        raise EvalError(f"{what} of a UInt64 value past 2^63-1 takes a "
                        "positive integer literal in the torch port")
    return v.py


def _u64_arith(op: str, a: Value, x, b: Value, y) -> Value:
    """Arithmetic with a UInt64 operand held as int64 bits.  The JAX
    package computes in uint64, which wraps modulo 2^64: int64 ``+ - *``
    give those bits exactly.  ``%`` and integer division read the bits
    unsigned and take a positive literal divisor; ``/`` raises."""
    valid = _both_valid(a, b)
    x, y = x.to(torch.int64), y.to(torch.int64)
    if op == "+":
        return Value(x + y, valid, u64=True)
    if op == "-":
        return Value(x - y, valid, u64=True)
    if op == "*":
        return Value(x * y, valid, u64=True)
    if op == "%" and _is_bits(a) and not _is_bits(b):
        return Value(_u64_mod(x, _positive_literal(b, "%")), valid, u64=True)
    raise EvalError(f"{op!r} over a UInt64 value past 2^63-1 is not "
                    "supported by the torch port")


def _u64_mod(x: torch.Tensor, m: int) -> torch.Tensor:
    """(x read as uint64) mod m, for int64 bits x and 0 < m < 2^63: a bit
    pattern read negative stands for x + 2^64."""
    r = torch.remainder(x, m)                      # x mod m, in [0, m)
    wrap = (1 << 64) % m
    t = r - (m - wrap)                             # r + wrap - m, no overflow
    fixed = torch.where(t >= 0, t, r + wrap)
    return torch.where(x < 0, fixed, r)


def _u64_div(x: torch.Tensor, m: int) -> torch.Tensor:
    """floor((x read as uint64) / m) for int64 bits x and 0 < m < 2^63."""
    half = (x >> 1) & INT64_MAX                    # floor(u / 2), exact
    q = (half // m) * 2                            # 2 floor(u / 2m)
    rem = x - q * m                                # bits of u - q m, a
    big = (rem < 0) | (rem >= m)                   # value in [0, 2m)
    return q + big.to(torch.int64)


def _upper(v: Value, t: torch.Tensor) -> int:
    """The largest value an integer operand can hold: its unsigned type's,
    a literal's own, else its storage type's."""
    if v.umax is not None:
        return v.umax
    if v.is_scalar and isinstance(v.py, int):
        return int(v.py)
    return 1 if t.dtype == torch.bool else torch.iinfo(t.dtype).max


def _unsigned_arith(op: str, a: Value, x, b: Value, y) -> Value:
    """+ and * with a UInt16/32/64 operand, in int64: ClickHouse types
    these results UInt32 or UInt64 (the JAX package wraps them in the
    operand's width instead, a fault of the reference: ROADMAP section 3).
    A result past 2^63-1 has no place in the int64 storage and is refused,
    not wrapped.  Unsigned operands are never negative, so only the sum or
    product of two non-negative values can pass the limit; where the
    operands' types keep the result under it (UInt32 plus or times a
    literal, UInt16 times UInt32) no test runs and the device is not
    waited for."""
    ua, ub = max(_upper(a, x), 0), max(_upper(b, y), 0)
    top = ua + ub if op == "+" else ua * ub
    x, y = x.to(torch.int64), y.to(torch.int64)
    d = x + y if op == "+" else x * y
    if top > INT64_MAX:
        _refuse_overflow(op, x, y, d)
    return Value(d, _both_valid(a, b), umax=min(top, INT64_MAX))


def _refuse_overflow(op: str, x, y, d) -> None:
    """Raise where d = x op y passed 2^63-1 (one host read)."""
    if op == "+":
        over = (x >= 0) & (y >= 0) & (d < 0)
    else:
        over = (x >= 0) & (y > 0) & (x > INT64_MAX // torch.clamp_min(y, 1))
    if bool(over.any()):
        raise EvalError(f"UInt64 result of {op!r} above 2^63-1: the torch "
                        "column store holds UInt64 values up to 2^63-1")


def _compare(op: str, a: Value, b: Value, env: Env) -> Value:
    a, b = _coerce_date_literal(a, b, env)
    # string comparisons via dictionary
    if a.is_string or b.is_string:
        return _compare_strings(op, a, b, env)
    x = _numeric(a, env.n_rows)
    y = _numeric(b, env.n_rows)
    if _is_bits(a) or _is_bits(b):
        return Value(_compare_u64(op, a, x, b, y), _both_valid(a, b))
    return Value(_compare_op(op, x, y), _both_valid(a, b))


def _compare_op(op: str, x, y):
    if op == "=":
        return x == y
    if op == "!=":
        return x != y
    if op == "<":
        return x < y
    if op == "<=":
        return x <= y
    if op == ">":
        return x > y
    if op == ">=":
        return x >= y
    raise EvalError(f"unknown comparison {op}")


def _u64_as_f64(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float64) + (x < 0).to(torch.float64) * 2.0 ** 64


def _compare_u64(op: str, a: Value, x, b: Value, y):
    """Compare with UInt64 bits read unsigned: two UInt64 operands order
    as their bits with the sign bit flipped; against a signed integer a
    bit pattern read negative (a value past 2^63-1) is the greater; against
    a float both sides go to f64."""
    if x.is_floating_point() or y.is_floating_point():
        return _compare_op(op, _u64_as_f64(x) if a.u64 else x,
                           _u64_as_f64(y) if b.u64 else y)
    x, y = x.to(torch.int64), y.to(torch.int64)
    if a.u64 and b.u64:
        return _compare_op(op, x ^ _I64_MIN, y ^ _I64_MIN)
    res = _compare_op(op, x, y)
    big = x < 0 if a.u64 else y < 0          # the unsigned side past 2^63-1
    a_greater = a.u64                        # where big, the u64 side wins
    wins = {"=": False, "!=": True,
            "<": not a_greater, "<=": not a_greater,
            ">": a_greater, ">=": a_greater}[op]
    return torch.where(big, wins, res)


_I64_MIN = -(1 << 63)


def _compare_strings(op: str, a: Value, b: Value, env: Env) -> Value:
    col, lit = (a, b) if a.dictionary is not None else (b, a)
    flipped = col is b
    if col.dictionary is None:
        # literal vs literal
        res = _py_compare(op, a.py, b.py)
        return Value(_scalar(res, env.device), is_scalar=True, py=res)
    if lit.dictionary is not None:
        # column vs column: remap rhs ids into lhs dictionary
        remap = np.array([col.dictionary.encode_one(s) for s in
                          lit.dictionary.values] or [-2], dtype=np.int32)
        rhs_ids = _dict_map(lit, remap)
        if op in ("=", "!="):
            d = col.data == rhs_ids if op == "=" else col.data != rhs_ids
            return Value(d, _both_valid(col, lit))
        # order-compare via merged dictionary ranks
        merged = StringDictionary(list(col.dictionary.values))
        for s in lit.dictionary.values:
            merged.encode_one(s, grow=True)
        ranks = merged.ranks()
        la = _dict_map(col, ranks[:len(col.dictionary)])
        remap2 = np.array([merged.index[s] for s in lit.dictionary.values]
                          or [0], dtype=np.int32)
        lb = _dict_map(lit, ranks[remap2])
        if flipped:
            la, lb = lb, la
        return _compare(op, Value(la), Value(lb), env)
    if not isinstance(lit.py, str):
        raise EvalError("cannot compare string column with non-string")
    if op in ("=", "!="):
        lid = _encode_str_literal(lit.py, col.dictionary)
        d = col.data == lid if op == "=" else col.data != lid
        return Value(d, col.valid)
    # order comparison against literal: evaluate on dictionary values
    import operator as _op
    pyop = {"<": _op.lt, "<=": _op.le, ">": _op.gt, ">=": _op.ge}[op]
    vals = col.dictionary.values
    if flipped:
        lut = np.array([pyop(lit.py, s) for s in vals] or [False], dtype=bool)
    else:
        lut = np.array([pyop(s, lit.py) for s in vals] or [False], dtype=bool)
    return Value(_dict_map(col, lut), col.valid)


def _py_compare(op, a, b):
    import operator as _op
    return {"=": _op.eq, "!=": _op.ne, "<": _op.lt, "<=": _op.le,
            ">": _op.gt, ">=": _op.ge}[op](a, b)


def _vector_literal(e: VectorLiteral) -> Value:
    # all-integer literals stay Int64; any float promotes to Float32, the
    # vector search element type
    flat = e.values[0] if e.values and isinstance(e.values[0], list) \
        else e.values
    all_int = all(isinstance(x, int) or float(x).is_integer()
                  and isinstance(x, int) for x in flat) if flat else False
    dt = np.int64 if all_int and not any(
        isinstance(x, float) for x in flat) else np.float32
    return Value(np.asarray(e.values, dtype=dt), is_scalar=True, py=e.values)


# -- external dictionaries (reference: FunctionsExternalDictionaries.h
# dictGet / dictGetOrDefault / dictHas over runtime/dictionaries.py)

def _get_dictionary(env: Env, name_val: Value):
    if not env.dictionaries:
        raise EvalError("no dictionaries defined in this session")
    name = name_val.py
    if not isinstance(name, str):
        raise EvalError("dictGet: dictionary name must be a string literal")
    d = env.dictionaries.get(name)
    if d is None:
        raise EvalError(f"unknown dictionary {name!r}")
    return d


def _dict_probe(d, key: Value, env: Env):
    """(row (n,) int32, found (n,) bool, scalar) of a dictGet key."""
    dev = env.device
    if isinstance(key.py, str):
        if not d.key_is_string:
            raise EvalError("dictGet: string key for a numeric-key dictionary")
        kid = d.key_dictionary.index.get(key.py, -2)
        row, found = d.lookup(torch.tensor([kid], dtype=torch.int64,
                                           device=dev),
                              probe_dictionary=d.key_dictionary)
        return row, found, True
    data = key.data.reshape(1) if key.is_scalar else key.data
    row, found = d.lookup(data, probe_dictionary=key.dictionary)
    if key.valid is not None and not key.is_scalar:
        found = found & key.valid
    return row, found, key.is_scalar


def _lookup_gather(col, row, found, scalar: bool, default,
                   nullable_result: bool) -> Value:
    """The attribute ``col`` at the probed rows: misses take the default
    (a String's '' or the given string, a number's 0 or the given value)."""
    dev = row.device
    if len(col) == 0:
        out = torch.zeros(row.shape, dtype=col.data.dtype, device=dev)
        found = torch.zeros(row.shape, dtype=torch.bool, device=dev)
    else:
        out = col.data[row.long()]
    if col.dtype is DataType.STRING:
        miss = col.dictionary.encode_one(
            default.py if default is not None and isinstance(default.py, str)
            else "", grow=True)
        out = torch.where(found, out, torch.full((), miss, dtype=out.dtype,
                                                 device=dev))
        return Value(out[0] if scalar else out, None, col.dictionary,
                     is_scalar=scalar)
    fill = torch.zeros((), dtype=out.dtype, device=dev) if default is None \
        else default.data.to(out.dtype)
    out = torch.where(found, out, fill)
    valid = None
    if nullable_result and col.valid is not None and not scalar:
        valid = col.valid[row.long()] & found
    return Value(out[0] if scalar else out, valid, is_scalar=scalar,
                 dt=col.dtype if col.dtype in (DataType.DATE,
                                               DataType.DATETIME) else None)


@func("dictget")
def _f_dictget(args, env):
    d = _get_dictionary(env, args[0])
    row, found, scalar = _dict_probe(d, args[2], env)
    return _lookup_gather(d.attribute(args[1].py), row, found, scalar, None,
                          True)


@func("dictgetordefault")
def _f_dictgetordefault(args, env):
    d = _get_dictionary(env, args[0])
    row, found, scalar = _dict_probe(d, args[2], env)
    return _lookup_gather(d.attribute(args[1].py), row, found, scalar,
                          args[3], True)


@func("dicthas")
def _f_dicthas(args, env):
    d = _get_dictionary(env, args[0])
    _row, found, scalar = _dict_probe(d, args[1], env)
    return Value(found[0] if scalar else found, is_scalar=scalar)


# -- Join-engine probes (reference: FunctionJoinGet.cpp over StorageJoin:
# joinGet('t', 'attr', keys...) answers from the table body, the build side)

def _get_join_table(env: Env, name_val: Value):
    sess = env.session
    if sess is None:
        raise EvalError("joinGet not available in this context")
    name = name_val.py
    if not isinstance(name, str):
        raise EvalError("joinGet: table name must be a string literal")
    info = sess._table_engines.get(name)
    if not info or info.get("engine") != "Join":
        raise EvalError(f"joinGet: {name!r} is not a Join-engine table")
    return name, sess.get_table(name), info


def _join_key(bc, kv: Value, n: int, dev):
    """(build keys, probe keys) of one joinGet key as comparable tensors:
    a String key in the build column's dictionary ids (probe values
    remapped on the host once per dictionary value), numbers in a common
    type."""
    if bc.dictionary is not None or kv.dictionary is not None or \
            isinstance(kv.py, str):
        if bc.dictionary is None:
            raise EvalError("joinGet: string key for a numeric column")
        if isinstance(kv.py, str):
            pid = torch.full((n,), bc.dictionary.index.get(kv.py, -2),
                             dtype=torch.int64, device=dev)
        elif kv.dictionary is not None:
            remap = np.array([bc.dictionary.index.get(s, -2)
                              for s in kv.dictionary.values] or [-2],
                             dtype=np.int64)
            pid = to_tensor(remap, dev)[torch.clamp(kv.data.long(), 0,
                                                    len(remap) - 1)]
        else:
            raise EvalError("joinGet: key type mismatch")
        return bc.data.to(torch.int64), pid
    data = kv.data.reshape(1) if kv.is_scalar else kv.data.expand(n)
    dt = torch.promote_types(bc.data.dtype, data.dtype)
    return bc.data.to(dt), data.to(dt)


def _join_probe(name, t, info, key_args, env: Env):
    """(build row, found, scalar) of joinGet's keys.  One key is looked up
    by ``torch.searchsorted`` over the table's keys, sorted once per
    mutation epoch (the session's derived-state cache); several keys go
    through the sort-merge ANY join of ops/hashtable.py.  Of equal keys
    the lowest row answers."""
    from myscaledb_tpu_torch.ops.hashtable import merge_join_any
    from myscaledb_tpu_torch.sql.executor import _derived
    if len(key_args) != len(info["keys"]):
        raise EvalError(f"joinGet: expected {len(info['keys'])} key(s)")
    scalar = all(k.is_scalar for k in key_args)
    n = 1 if scalar else env.n_rows
    dev = env.device
    builds, probes, pvalid = [], [], None
    for kc_name, kv in zip(info["keys"], key_args):
        if kc_name not in t:
            raise EvalError(f"joinGet: no key column {kc_name!r}")
        b, p = _join_key(t[kc_name], kv, n, dev)
        builds.append(b)
        probes.append(p)
        if kv.valid is not None and not kv.is_scalar:
            pvalid = kv.valid if pvalid is None else pvalid & kv.valid
    if t.n_rows == 0:
        return (torch.zeros(n, dtype=torch.int32, device=dev),
                torch.zeros(n, dtype=torch.bool, device=dev), scalar)
    if len(builds) == 1 and not builds[0].is_floating_point():
        b, p = builds[0].to(torch.int64), probes[0].to(torch.int64)
        srt, perm = _derived(
            env.session, "join_keys", name, t, info["keys"][0],
            lambda c: torch.sort(c.data.to(torch.int64), stable=True))
        pos = torch.clamp(torch.searchsorted(srt, p), max=srt.shape[0] - 1)
        found = srt[pos] == p
        row = perm[pos]
    else:
        row, found = merge_join_any(tuple(builds), tuple(probes),
                                    probe_valid=pvalid)
    if pvalid is not None:
        found = found & pvalid
    return torch.where(found, row, 0).to(torch.int32), found, scalar


def _join_get(args, env, default=None, or_null=False) -> Value:
    name, t, info = _get_join_table(env, args[0])
    attr = args[1].py
    keys = args[2:-1] if default is not None else args[2:]
    row, found, scalar = _join_probe(name, t, info, keys, env)
    if attr not in t:
        raise EvalError(f"joinGet: no column {attr!r}")
    v = _lookup_gather(t[attr], row, found, scalar, default, False)
    if or_null and not scalar:
        return Value(v.data, found, v.dictionary, dt=v.dt)
    return v


@func("joinget")
def _f_joinget(args, env):
    return _join_get(args, env)


@func("joingetordefault")
def _f_joingetordefault(args, env):
    return _join_get(args, env, default=args[-1])


@func("joingetornull")
def _f_joingetornull(args, env):
    return _join_get(args, env, or_null=True)


def eval_expr(e: Expr, env: Env) -> Value:
    if isinstance(e, Literal):
        if e.value is None:
            return Value(_scalar(0, env.device), is_scalar=True, py=None)
        if isinstance(e.value, str):
            return Value(None, is_scalar=True, py=e.value)
        return Value(_scalar(e.value, env.device), is_scalar=True,
                     py=e.value)
    if isinstance(e, VectorLiteral):
        return _vector_literal(e)
    if isinstance(e, Ident):
        return env.resolve(e)
    if isinstance(e, UnOp):
        v = eval_expr(e.operand, env)
        if e.op == "-":
            return _negate(v, env)
        if e.op == "NOT":
            return Value(~as_bool_mask(v, env.n_rows))
        raise EvalError(f"unknown unary {e.op}")
    if isinstance(e, BinOp):
        if e.op in ("AND", "OR"):
            a = as_bool_mask(eval_expr(e.left, env), env.n_rows)
            b = as_bool_mask(eval_expr(e.right, env), env.n_rows)
            return Value(a & b if e.op == "AND" else a | b)
        a = eval_expr(e.left, env)
        b = eval_expr(e.right, env)
        if e.op in ("+", "-", "*", "/", "%"):
            return _arith(e.op, a, b, env)
        return _compare(e.op, a, b, env)
    if isinstance(e, InSubquery):
        return _in_subquery(e, env)
    if isinstance(e, InList):
        v = eval_expr(e.expr, env)
        hits = None
        for item in e.items:
            it = eval_expr(item, env)
            hm = as_bool_mask(_compare("=", v, it, env), env.n_rows)
            hits = hm if hits is None else hits | hm
        if e.negated:
            hits = ~hits
            if v.valid is not None:
                hits = hits & v.valid
        return Value(hits)
    if isinstance(e, Between):
        v = eval_expr(e.expr, env)
        lo = eval_expr(e.low, env)
        hi = eval_expr(e.high, env)
        a = as_bool_mask(_compare(">=", v, lo, env), env.n_rows)
        b = as_bool_mask(_compare("<=", v, hi, env), env.n_rows)
        res = a & b
        if e.negated:
            res = ~res
            if v.valid is not None:
                res = res & v.valid
        return Value(res)
    if isinstance(e, FuncCall):
        if any(isinstance(a, Lambda) for a in e.args):
            return _arrays.eval_hof(e, env)
        impl = _FUNCS.get(e.name.lower())
        if impl is None:
            raise EvalError(f"unknown function {e.name!r}")
        args = [eval_expr(a, env) for a in e.args]
        return impl(args, env)
    if isinstance(e, WindowCall):
        # computed windows are read by name; one inside an expression is not
        raise EvalError(f"cannot evaluate {e!r}")
    raise EvalError(f"cannot evaluate {e!r}")


def _in_subquery(e: InSubquery, env: Env) -> Value:
    """x [NOT] IN (subquery): the subquery's first column is the member
    set; membership is ``torch.isin`` on the device.  Strings of another
    dictionary are remapped on the host once per dictionary value.  A NULL
    of x is never IN (and never NOT IN); a NULL in the subquery's column
    matches nothing (the JAX package matches the value stored under it:
    ROADMAP section 3)."""
    runner = env.subquery_runner
    if runner is None:
        raise EvalError("IN (subquery) not available in this context")
    sub_table = runner(e.query)
    col = next(iter(sub_table.columns.values()), None)
    v = eval_expr(e.expr, env)
    n = env.n_rows
    if col is None or sub_table.n_rows == 0:
        base = torch.zeros(n, dtype=torch.bool, device=env.device)
        return Value(~base if e.negated else base)
    members = col.data if not col.is_host else to_tensor(col.data,
                                                          env.device)
    if col.valid is not None:
        valid = col.valid if not col.is_host else to_tensor(col.valid,
                                                            env.device)
        members = members[valid]
    if v.dictionary is not None or col.dictionary is not None:
        if v.dictionary is None or col.dictionary is None:
            raise EvalError("IN type mismatch: string vs numeric")
        remap = np.array([v.dictionary.encode_one(s)
                          for s in col.dictionary.values] or [-2],
                         dtype=np.int32)
        members = _dict_map(Value(members), remap)
    x = v.data.expand(n) if v.is_scalar else v.data
    hit = torch.isin(x, members.to(x.device))
    if v.valid is not None:
        hit = hit & v.valid
    if e.negated:
        hit = ~hit
        if v.valid is not None:
            hit = hit & v.valid
    return Value(hit)


# register the array, datetime and extended scalar functions (imported at
# the bottom: these modules need this one fully initialized, as in the JAX
# package)
from myscaledb_tpu_torch.exec import arrays as _arrays  # noqa: E402
from myscaledb_tpu_torch.exec import datetime_fns as _dt_fns  # noqa: E402,F401
from myscaledb_tpu_torch.exec import scalar_fns as _scalar_fns  # noqa: E402,F401
