"""Expression evaluation: AST -> torch tensors over a table environment.

Port of the subset of myscaledb_tpu/exec/expr.py that WHERE/PREWHERE and
the vector slice's projections need: ``Value``, ``Env``, ``EvalError``,
``as_bool_mask``, ``_dict_map``, ``_arith``, ``_compare``,
``_compare_strings`` and ``eval_expr`` over literals, identifiers, vector
literals, comparisons, arithmetic, AND/OR/NOT, IN (list), BETWEEN, the
scalar functions abs .. isNotNull, and the string functions that build
binary query vectors: ``unhex``, ``unbin`` and ``char`` (the port of
myscaledb_tpu/exec/scalar_fns.py's, with ``_dict_transform``; ``char`` is
the second of its two registrations there, the one the JAX package runs).
exec/scalar_fns.py adds the array literals and functions the DDL statements
use (``array``, ``range``, ``length``, ``sleep``, ``currentDatabase``).
Every other node or function raises ``NotPortedError``.

String semantics ride the dictionary: predicates on strings are evaluated
once over the (small) dictionary on the host, then mapped to rows with one
device gather.  Validity masks propagate through arithmetic and
comparisons; WHERE treats NULL as false.

Type promotion: the JAX package runs with x64 on, and its literals are
weakly typed 0-d arrays (int64/float64) that take a column's type within
the same category.  Literals here are 0-d int64/float64 tensors, and
torch's rule for zero-dimensional operands gives the same result types.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from myscaledb_tpu_torch.core.types import DataType
from myscaledb_tpu_torch.core.table import Table, to_tensor
from myscaledb_tpu_torch.core.dictionary import StringDictionary
from myscaledb_tpu_torch.errors import NotPortedError
from myscaledb_tpu_torch.sql.ast import (Expr, Literal, VectorLiteral, Ident,
                                         BinOp, UnOp, FuncCall, InList,
                                         Between, WindowCall)

EXPR_SLICE = "expression and function breadth"
INT64_MAX = 2 ** 63 - 1
# the largest value of each unsigned type stored widened to a signed tensor
# (UInt64 up to 2^63-1, what the int64 store holds)
_WIDENED_UNSIGNED = {DataType.UINT16: 2 ** 16 - 1,
                     DataType.UINT32: 2 ** 32 - 1,
                     DataType.UINT64: INT64_MAX}


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

    @property
    def is_string(self) -> bool:
        return self.dictionary is not None and self.offsets is None \
            or isinstance(self.py, str)

    @property
    def is_array(self) -> bool:
        return self.offsets is not None


class Env:
    """Name -> Column resolution over one table, on ``device``."""

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
                return Value(data, valid, c.dictionary,
                             offsets=c.offsets, dt=tag,
                             umax=_WIDENED_UNSIGNED.get(c.dtype))
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
    return Value(torch.abs(_numeric(args[0], env.n_rows)), args[0].valid)

@func("negate")
def _f_negate(args, env):
    return Value(-_numeric(args[0], env.n_rows), args[0].valid)

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
    return Value(torch.floor_divide(a, b), _both_valid(args[0], args[1]))

@func("modulo")
def _f_modulo(args, env):
    a = _numeric(args[0], env.n_rows)
    b = _numeric(args[1], env.n_rows)
    return Value(torch.remainder(a, b), _both_valid(args[0], args[1]))

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


def _dict_transform(v: Value, fn) -> Value:
    """Apply a python string->string fn over dictionary values; returns a
    STRING Value with a fresh dictionary."""
    if v.dictionary is None:
        if isinstance(v.py, str):
            return Value(None, is_scalar=True, py=fn(v.py))
        raise EvalError("expected a string column")
    return Value(v.data, v.valid,
                 StringDictionary([fn(s) for s in v.dictionary.values]))


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


# ---------------------------------------------------------------------------
# core evaluation

def _arith(op: str, a: Value, b: Value, env: Env) -> Value:
    if a.dt is not None or b.dt is not None:
        raise NotPortedError("Date/DateTime arithmetic", EXPR_SLICE)
    if a.is_string or b.is_string:
        raise EvalError(f"arithmetic {op!r} on strings")
    x = _numeric(a, env.n_rows)
    y = _numeric(b, env.n_rows)
    if op in ("+", "*") and (a.umax is not None or b.umax is not None) \
            and not (x.is_floating_point() or y.is_floating_point()):
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
        d = torch.remainder(x, y)
    else:
        raise EvalError(f"unknown arithmetic op {op}")
    return Value(d, _both_valid(a, b))


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
    for col, lit in ((a, b), (b, a)):
        if col.dt is not None and isinstance(lit.py, str):
            raise NotPortedError("Date/DateTime literals", EXPR_SLICE)
    # string comparisons via dictionary
    if a.is_string or b.is_string:
        return _compare_strings(op, a, b, env)
    x = _numeric(a, env.n_rows)
    y = _numeric(b, env.n_rows)
    if op == "=":
        d = x == y
    elif op == "!=":
        d = x != y
    elif op == "<":
        d = x < y
    elif op == "<=":
        d = x <= y
    elif op == ">":
        d = x > y
    elif op == ">=":
        d = x >= y
    else:
        raise EvalError(f"unknown comparison {op}")
    return Value(d, _both_valid(a, b))


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


def eval_expr(e: Expr, env: Env) -> Value:
    if isinstance(e, Literal):
        if e.value is None:
            return Value(_scalar(0, env.device), is_scalar=True, py=None)
        if isinstance(e.value, str):
            return Value(None, is_scalar=True, py=e.value)
        if isinstance(e.value, (bool, int, float)):
            return Value(_scalar(e.value, env.device), is_scalar=True,
                         py=e.value)
        raise NotPortedError(f"literal {e.value!r}", EXPR_SLICE)
    if isinstance(e, VectorLiteral):
        return _vector_literal(e)
    if isinstance(e, Ident):
        return env.resolve(e)
    if isinstance(e, UnOp):
        v = eval_expr(e.operand, env)
        if e.op == "-":
            return Value(-_numeric(v, env.n_rows), v.valid)
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
        impl = _FUNCS.get(e.name.lower())
        if impl is None and e.name.lower() in DIST_FNS:
            raise EvalError(f"unknown function {e.name!r}")
        if impl is None:
            raise NotPortedError(f"function {e.name}()", EXPR_SLICE)
        args = [eval_expr(a, env) for a in e.args]
        return impl(args, env)
    if isinstance(e, WindowCall):
        # computed windows are read by name; one inside an expression is not
        raise EvalError(f"cannot evaluate {e!r}")
    raise NotPortedError(f"expression {type(e).__name__}", EXPR_SLICE)


# the DDL slice's scalar and array functions (imported at the bottom: that
# module needs this one fully initialized, as in the JAX package)
from myscaledb_tpu_torch.exec import scalar_fns as _scalar_fns  # noqa: E402,F401
