"""Extended scalar-function families: the port of
myscaledb_tpu/exec/scalar_fns.py (``finalizeAggregation`` comes with the
-State combinators).

* bit manipulation        (src/Functions/bitAnd.cpp … bitCount.cpp)
* extra math              (src/Functions/math*.cpp)
* integer/typed casts     (src/Functions/toInt*.cpp, FunctionsConversion.h)
* conditionals            multiIf/transform + string-aware if()
* hashing                 cityHash64, sipHash64, xxHash32/64, intHash32/64,
                          halfMD5, MD5/SHA (CityHash v1.0.2 like the
                          reference)
* encoding                hex/bin/base64 (src/Functions/FunctionsCoding.h)
* JSON extraction, URL parts, randomness, IPv4, environment info

Numeric inputs evaluate on the device: the closed-form short-input hashes
(a fixed-width column is a fixed-length message, so xxh64 / sipHash64 /
cityHash64 reduce to a handful of 64-bit ops) run on int64 bit patterns,
whose wrapping multiply and add give the uint64 results bit for bit and
whose logical right shifts are an arithmetic shift masked to the
shifted-in width.  Their UInt64 results are ``Value.u64`` values
(exec/expr.py).  String inputs evaluate once over the (small) dictionary
on the host and are mapped to rows with one device gather.  The host
algorithms (xxHash, SipHash, CityHash, JSON, URL) are copied from the JAX
package.
"""

from __future__ import annotations

import base64 as _b64
import hashlib
import json as _json
import math
import re
import socket
from urllib.parse import urlsplit, unquote, quote

import numpy as np
import torch

from myscaledb_tpu_torch.core.types import DataType, physical_dtype
from myscaledb_tpu_torch.core.dictionary import StringDictionary, NULL_ID
from myscaledb_tpu_torch.core.table import to_tensor
from myscaledb_tpu_torch.exec.expr import (
    Value, Env, EvalError, _FUNCS, UNSIGNED_OF_MAX, func, _dict_map,
    _dict_transform, _dict_lut, _numeric, _scalar, _both_valid, _f32,
    _is_bits, _is_null_literal, _string_branch_ids, as_bool_mask,
    host_rows, _trunc_div)
from myscaledb_tpu_torch.ops.hash import _to_i64_bits, _shr64, popcount64


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


@func("multiIf")
def _f_multiif(args, env):
    if len(args) % 2 == 0:
        raise EvalError("multiIf needs an odd number of arguments")
    out = args[-1]
    for i in range(len(args) - 3, -1, -2):
        out = _if_impl([args[i], args[i + 1], out], env)
    return out


def _literal_list(v: Value):
    """Reconstruct a python list from an array-literal Value (numeric
    VectorLiteral keeps .py; string array literals arrive as per-row ARRAY
    values — take row 0)."""
    if isinstance(v.py, list):
        return [x.tolist() if hasattr(x, "tolist") else x for x in v.py]
    if v.offsets is not None:
        off = np.asarray(v.offsets)
        if len(off) < 2:
            return []
        ids = v.data[int(off[0]):int(off[1])].cpu().numpy()
        if v.dictionary is not None:
            return [v.dictionary.values[i] for i in ids]
        return ids.tolist()
    return None


def _match_rows(x: Value, s_from, env):
    """Rows of x equal to one transform() source value."""
    if isinstance(s_from, str):
        if x.dictionary is None:
            raise EvalError("transform: string match on non-string")
        return x.data == x.dictionary.encode_one(s_from, grow=False)
    return _numeric(x, env.n_rows) == s_from


@func("transform")
def _f_transform(args, env):
    x = args[0]
    src = _literal_list(args[1])
    dst = _literal_list(args[2])
    if not isinstance(src, list) or not isinstance(dst, list) or \
            len(src) != len(dst):
        raise EvalError("transform: from/to must be equal-length array "
                        "literals")
    default = args[3] if len(args) > 3 else x
    str_out = any(isinstance(s, str) for s in dst) or default.is_string
    if str_out:
        d = StringDictionary()
        di, dv = _string_branch_ids(default, env, d) if (
            default.is_string or _is_null_literal(default)) else (None, None)
        if di is None:
            raise EvalError("transform: mixed string/numeric outputs")
        out, valid = di, dv
        for s_from, s_to in zip(src, dst):
            hit = _match_rows(x, s_from, env)
            tid = d.encode_one(str(s_to), grow=True)
            out = torch.where(hit, tid, out)
            if valid is not None:
                valid = valid | hit
        return Value(out, valid, d)
    # numeric output
    if default is x and x.is_string:
        raise EvalError("transform: string input needs explicit default for "
                        "numeric output")
    out = _numeric(default, env.n_rows)
    if default.is_scalar:
        out = out.expand(env.n_rows)
    for s_from, s_to in zip(src, dst):
        hit = _match_rows(x, s_from, env)
        out = torch.where(hit, torch.tensor(s_to, device=env.device)
                          .to(out.dtype), out)
    return Value(out, x.valid if default is x else default.valid)


# ---------------------------------------------------------------------------
# logical widths: UInt16/32 are stored widened, UInt64 as int64 bits

_U32 = 2 ** 32 - 1


def _u32_value(data: torch.Tensor, valid) -> Value:
    """A UInt32 result: int64 values below 2^32, typed UInt32."""
    return Value(data, valid, umax=_U32)


def _u64_value(data: torch.Tensor, valid, **kw) -> Value:
    return Value(data, valid, u64=True, **kw)


def _width_bytes(v: Value) -> int:
    """Bytes of the value's type in the JAX package (UInt16 and UInt32
    are stored widened here)."""
    if v.umax in UNSIGNED_OF_MAX:
        return physical_dtype(UNSIGNED_OF_MAX[v.umax]).itemsize
    return v.data.element_size()


def _host_lut_u64(values) -> np.ndarray:
    """Python ints in [0, 2^64) as int64 bits (one per dictionary id)."""
    return np.array(values or [0], dtype=np.uint64).view(np.int64)


# ---------------------------------------------------------------------------
# bit functions (device)

def _int_pair(args, env):
    a = _numeric(args[0], env.n_rows)
    b = _numeric(args[1], env.n_rows)
    if a.is_floating_point() or b.is_floating_point():
        raise EvalError("bit functions need integer arguments")
    return a, b


def _bitwise(op):
    def impl(args, env):
        a, b = _int_pair(args, env)
        return Value(op(a, b), _both_valid(args[0], args[1]),
                     u64=_is_bits(args[0]) or _is_bits(args[1]))
    return impl


func("bitAnd")(_bitwise(torch.bitwise_and))
func("bitOr")(_bitwise(torch.bitwise_or))
func("bitXor")(_bitwise(torch.bitwise_xor))


@func("bitNot")
def _f_bitnot(args, env):
    return Value(~_numeric(args[0], env.n_rows), args[0].valid,
                 u64=_is_bits(args[0]))


@func("bitShiftLeft")
def _f_bitshiftleft(args, env):
    a, b = _int_pair(args, env)
    return Value(a << b.to(a.dtype), _both_valid(args[0], args[1]),
                 u64=_is_bits(args[0]))


@func("bitShiftRight")
def _f_bitshiftright(args, env):
    a, b = _int_pair(args, env)
    k = b.to(a.dtype)
    if _is_bits(args[0]):           # uint64: a logical shift
        out = _shr_var(a.to(torch.int64), k.to(torch.int64))
        return _u64_value(out, _both_valid(args[0], args[1]))
    return Value(a >> k, _both_valid(args[0], args[1]))


def _shr_var(u: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Logical right shift of int64 bits by per-row amounts in [0, 63]."""
    mask = torch.where(k == 0, -1, (1 << (64 - k.clamp(1, 63))) - 1)
    return (u >> k) & mask


def _rotate(args, env, left: bool) -> Value:
    a, b = _int_pair(args, env)
    u = a.to(torch.int64)
    k = torch.remainder(b.to(torch.int64), 64)
    back = torch.remainder(64 - k, 64)
    if left:
        out = (u << k) | _shr_var(u, back)
    else:
        out = _shr_var(u, k) | (u << back)
    return Value(out.to(a.dtype), _both_valid(args[0], args[1]),
                 u64=_is_bits(args[0]))


@func("bitRotateLeft")
def _f_bitrotateleft(args, env):
    return _rotate(args, env, True)


@func("bitRotateRight")
def _f_bitrotateright(args, env):
    return _rotate(args, env, False)


@func("bitCount")
def _f_bitcount(args, env):
    x = _numeric(args[0], env.n_rows)
    if x.is_floating_point():
        raise EvalError("bitCount needs an integer argument")
    # count over the value's 64-bit sign extension (the JAX package's
    # astype(uint64))
    return Value(popcount64(x.to(torch.int64)).to(torch.uint8),
                 args[0].valid)


@func("bitTest")
def _f_bittest(args, env):
    a, b = _int_pair(args, env)
    return Value(((a >> b.to(a.dtype)) & 1).to(torch.uint8),
                 _both_valid(args[0], args[1]))


def _bit_test_many(args, env, combine) -> Value:
    x = _numeric(args[0], env.n_rows)
    out = None
    for a in args[1:]:
        bit = ((x >> _numeric(a, env.n_rows).to(x.dtype)) & 1) != 0
        out = bit if out is None else combine(out, bit)
    return Value(out.to(torch.uint8), args[0].valid)


@func("bitTestAll")
def _f_bittestall(args, env):
    return _bit_test_many(args, env, torch.logical_and)


@func("bitTestAny")
def _f_bittestany(args, env):
    return _bit_test_many(args, env, torch.logical_or)


@func("bitHammingDistance")
def _f_bithamming(args, env):
    a, b = _int_pair(args, env)
    x = a.to(torch.int64) ^ b.to(torch.int64)
    return _f_bitcount([Value(x, _both_valid(args[0], args[1]))], env)


# ---------------------------------------------------------------------------
# extra math (device)

def _ff(v, env):
    return _f32(_numeric(v, env.n_rows))


for _n, _f in [("atan2", torch.atan2), ("hypot", torch.hypot)]:
    def _mk2(fn):
        def impl(args, env):
            return Value(fn(_ff(args[0], env), _ff(args[1], env)),
                         _both_valid(args[0], args[1]))
        return impl
    _FUNCS[_n] = _mk2(_f)

for _n, _f in [("log1p", torch.log1p), ("expm1", torch.expm1),
               ("degrees", torch.rad2deg), ("radians", torch.deg2rad),
               ("asinh", torch.asinh), ("acosh", torch.acosh),
               ("atanh", torch.atanh), ("erf", torch.erf),
               ("erfc", torch.erfc), ("lgamma", torch.lgamma)]:
    def _mk1(fn):
        def impl(args, env):
            return Value(fn(_ff(args[0], env)), args[0].valid)
        return impl
    _FUNCS[_n] = _mk1(_f)


@func("tgamma")
def _f_tgamma(args, env):
    return Value(torch.exp(torch.lgamma(_ff(args[0], env))), args[0].valid)


@func("exp10")
def _f_exp10(args, env):
    return Value(torch.pow(10.0, _ff(args[0], env)), args[0].valid)


@func("e")
def _f_e(args, env):
    return Value(_scalar(math.e, env.device), is_scalar=True, py=math.e)


@func("intExp2")
def _f_intexp2(args, env):
    x = _numeric(args[0], env.n_rows)
    return Value(torch.ones((), dtype=torch.int64, device=x.device)
                 << x.to(torch.int64), args[0].valid)


@func("intExp10")
def _f_intexp10(args, env):
    x = _numeric(args[0], env.n_rows).to(torch.int64)
    pow10 = torch.tensor([10 ** i for i in range(19)], dtype=torch.int64,
                         device=x.device)
    return Value(pow10[x.clamp(0, 18)], args[0].valid)


@func("gcd")
def _f_gcd(args, env):
    a, b = _int_pair(args, env)
    return Value(torch.gcd(*torch.broadcast_tensors(a, b)),
                 _both_valid(args[0], args[1]))


@func("lcm")
def _f_lcm(args, env):
    a, b = _int_pair(args, env)
    return Value(torch.lcm(*torch.broadcast_tensors(a, b)),
                 _both_valid(args[0], args[1]))


@func("trunc", "truncate")
def _f_trunc(args, env):
    return Value(torch.trunc(_numeric(args[0], env.n_rows)), args[0].valid)


@func("roundBankers")
def _f_roundbankers(args, env):
    # torch.round, like jnp.round, IS round-half-even
    return _FUNCS["round"](args, env)


@func("roundToExp2")
def _f_roundtoexp2(args, env):
    x = _numeric(args[0], env.n_rows)
    xf = _f32(x)
    p = torch.floor(torch.log2(torch.clamp_min(xf, 1.0)))
    out = torch.where(xf < 1, torch.zeros_like(xf), torch.exp2(p))
    return Value(out if x.is_floating_point() else out.to(x.dtype),
                 args[0].valid)


@func("roundDown")
def _f_rounddown(args, env):
    x = _ff(args[0], env)
    bounds = np.sort(np.asarray(_literal_list(args[1]), dtype=np.float32))
    b = to_tensor(bounds, x.device)
    idx = torch.clamp_min(torch.searchsorted(b, x, right=True) - 1, 0)
    out = b[idx.clamp(0, len(bounds) - 1)]
    out = torch.where(x < b[0], b[0], out)
    return Value(out, args[0].valid)


def _float_class(fn):
    def impl(args, env):
        return Value(fn(_ff(args[0], env)).to(torch.uint8), args[0].valid)
    return impl


func("isFinite")(_float_class(torch.isfinite))
func("isInfinite")(_float_class(torch.isinf))
func("isNaN")(_float_class(torch.isnan))


@func("max2")
def _f_max2(args, env):
    return Value(torch.maximum(_ff(args[0], env), _ff(args[1], env)),
                 _both_valid(args[0], args[1]))


@func("min2")
def _f_min2(args, env):
    return Value(torch.minimum(_ff(args[0], env), _ff(args[1], env)),
                 _both_valid(args[0], args[1]))


def _or_zero(args, env, op) -> Value:
    a, b = _int_pair(args, env)
    safe = torch.where(b == 0, torch.ones_like(b), b)
    return Value(torch.where(b == 0, torch.zeros_like(a), op(a, safe)),
                 _both_valid(args[0], args[1]))


@func("intDivOrZero")
def _f_intdivorzero(args, env):
    return _or_zero(args, env, _trunc_div)


@func("moduloOrZero")
def _f_moduloorzero(args, env):
    return _or_zero(args, env, torch.fmod)


# ---------------------------------------------------------------------------
# casts (device); narrow casts wrap around like the reference's
# static_cast semantics

def _cast_int(args, env, bits, signed):
    x = _numeric(args[0], env.n_rows)
    if x.is_floating_point():
        x = torch.trunc(x)
    wide = x.to(torch.int64)
    if bits == 64:
        # toUInt64 reinterprets: toUInt64(-3) wraps (the bits are kept)
        return Value(wide, args[0].valid, u64=True)
    w = wide & ((1 << bits) - 1)
    if signed:
        sign = 1 << (bits - 1)
        w = torch.where((w & sign) != 0, w - (1 << bits), w)
    return Value(w.to(torch.int64 if bits > 32 or not signed
                      else torch.int32), args[0].valid)


for _bits, _signed, _name in [(8, True, "toInt8"), (16, True, "toInt16"),
                              (8, False, "toUInt8"), (16, False, "toUInt16"),
                              (32, False, "toUInt32"), (64, False, "toUInt64")]:
    def _mkc(bits, signed):
        return lambda args, env: _cast_int(args, env, bits, signed)
    _FUNCS[_name.lower()] = _mkc(_bits, _signed)


@func("toBool")
def _f_tobool(args, env):
    return Value(_numeric(args[0], env.n_rows) != 0, args[0].valid)


_TYPE_NAMES = {torch.int8: "Int8", torch.int16: "Int16",
               torch.int32: "Int32", torch.int64: "Int64",
               torch.uint8: "UInt8", torch.float32: "Float32",
               torch.float64: "Float64", torch.bool: "Bool"}


@func("toTypeName")
def _f_totypename(args, env):
    v = args[0]
    if v.is_string:
        name = "String"
    elif v.is_array:
        name = "Array(...)"
    elif v.dt is DataType.DATE:
        name = "Date"
    elif v.dt is DataType.DATETIME:
        name = "DateTime"
    elif v.u64:
        name = "UInt64"
    elif v.umax is not None:
        # a widened unsigned value (a column, or + and * over one, whose
        # largest value _unsigned_arith tracks): the narrowest UInt that
        # holds its largest value, UInt64 past UInt32 (ClickHouse types
        # UInt32 + 1 and UInt32 * 2 UInt64)
        name = next(t.value for t in (DataType.UINT8, DataType.UINT16,
                                      DataType.UINT32)
                    if v.umax <= np.iinfo(physical_dtype(t)).max) \
            if v.umax <= 0xFFFFFFFF else "UInt64"
    else:
        d = v.data.dtype
        name = _TYPE_NAMES.get(d, str(d))
    if v.valid is not None:
        name = f"Nullable({name})"
    return Value(None, is_scalar=True, py=name)


@func("identity", "materialize")
def _f_identity(args, env):
    return args[0]


@func("ignore")
def _f_ignore(args, env):
    return Value(torch.zeros((), dtype=torch.uint8, device=env.device),
                 is_scalar=True, py=0)


# ---------------------------------------------------------------------------
# hashing — device closed forms for fixed-width numerics over int64 bits,
# exact host algorithms over string dictionaries (FunctionsHashing.h
# analogs)

_P64_1 = 0x9E3779B185EBCA87
_P64_2 = 0xC2B2AE3D27D4EB4F
_P64_3 = 0x165667B19E3779F9
_P64_4 = 0x85EBCA77C2B2AE63
_P64_5 = 0x27D4EB2F165667C5


def _k(c: int) -> int:
    """A uint64 constant as the int64 multiplier/addend with its bits."""
    return _to_i64_bits(c & 0xFFFFFFFFFFFFFFFF)


def _rotl64(x, r: int):
    return (x << r) | _shr64(x, 64 - r)


def _xxh64_avalanche(h):
    h = h ^ _shr64(h, 33)
    h = h * _k(_P64_2)
    h = h ^ _shr64(h, 29)
    h = h * _k(_P64_3)
    return h ^ _shr64(h, 32)


def _xxh64_fixed(u: torch.Tensor, nbytes: int, seed=0) -> torch.Tensor:
    """xxHash64 of an nbytes little-endian message per lane (nbytes in
    {1,2,4,8}; 2-byte inputs hash as two 1-byte steps per the spec)."""
    h = torch.full_like(u, _k(seed + _P64_5 + nbytes))
    if nbytes == 8:
        k1 = _rotl64(u * _k(_P64_2), 31) * _k(_P64_1)
        h = h ^ k1
        h = _rotl64(h, 27) * _k(_P64_1) + _k(_P64_4)
    elif nbytes == 4:
        h = h ^ ((u & 0xFFFFFFFF) * _k(_P64_1))
        h = _rotl64(h, 23) * _k(_P64_2) + _k(_P64_3)
    else:
        for i in range(nbytes):
            byte = (u >> (8 * i)) & 0xFF
            h = h ^ (byte * _k(_P64_5))
            h = _rotl64(h, 11) * _k(_P64_1)
    return _xxh64_avalanche(h)


def _xxh64_bytes(data: bytes, seed: int = 0) -> int:
    """Exact xxHash64 (spec: github.com/Cyan4973/xxHash) on the host."""
    M = 0xFFFFFFFFFFFFFFFF
    def rotl(x, r):
        return ((x << r) | (x >> (64 - r))) & M
    P1, P2, P3, P4, P5 = _P64_1, _P64_2, _P64_3, _P64_4, _P64_5
    n = len(data)
    i = 0
    if n >= 32:
        v1 = (seed + P1 + P2) & M
        v2 = (seed + P2) & M
        v3 = seed & M
        v4 = (seed - P1) & M
        while i + 32 <= n:
            for vi, off in ((1, 0), (2, 8), (3, 16), (4, 24)):
                lane = int.from_bytes(data[i + off:i + off + 8], "little")
                v = (v1, v2, v3, v4)[vi - 1]
                v = (v + lane * P2) & M
                v = (rotl(v, 31) * P1) & M
                if vi == 1:
                    v1 = v
                elif vi == 2:
                    v2 = v
                elif vi == 3:
                    v3 = v
                else:
                    v4 = v
            i += 32
        h = (rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18)) & M
        for v in (v1, v2, v3, v4):
            k = (rotl((v * P2) & M, 31) * P1) & M
            h ^= k
            h = ((h * P1) + P4) & M
    else:
        h = (seed + P5) & M
    h = (h + n) & M
    while i + 8 <= n:
        lane = int.from_bytes(data[i:i + 8], "little")
        k = (rotl((lane * P2) & M, 31) * P1) & M
        h ^= k
        h = (rotl(h, 27) * P1 + P4) & M
        i += 8
    if i + 4 <= n:
        lane = int.from_bytes(data[i:i + 4], "little")
        h ^= (lane * P1) & M
        h = (rotl(h, 23) * P2 + P3) & M
        i += 4
    while i < n:
        h ^= (data[i] * P5) & M
        h = (rotl(h, 11) * P1) & M
        i += 1
    h ^= h >> 33
    h = (h * P2) & M
    h ^= h >> 29
    h = (h * P3) & M
    h ^= h >> 32
    return h


_P32_1 = 0x9E3779B1
_P32_2 = 0x85EBCA77
_P32_3 = 0xC2B2AE3D
_P32_4 = 0x27D4EB2F
_P32_5 = 0x165667B1


def _xxh32_bytes(data: bytes, seed: int = 0) -> int:
    M = 0xFFFFFFFF
    def rotl(x, r):
        return ((x << r) | (x >> (32 - r))) & M
    n = len(data)
    i = 0
    if n >= 16:
        v1 = (seed + _P32_1 + _P32_2) & M
        v2 = (seed + _P32_2) & M
        v3 = seed & M
        v4 = (seed - _P32_1) & M
        while i + 16 <= n:
            vs = [v1, v2, v3, v4]
            for j in range(4):
                lane = int.from_bytes(data[i + 4 * j:i + 4 * j + 4], "little")
                v = (vs[j] + lane * _P32_2) & M
                vs[j] = (rotl(v, 13) * _P32_1) & M
            v1, v2, v3, v4 = vs
            i += 16
        h = (rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18)) & M
    else:
        h = (seed + _P32_5) & M
    h = (h + n) & M
    while i + 4 <= n:
        lane = int.from_bytes(data[i:i + 4], "little")
        h = (h + lane * _P32_3) & M
        h = (rotl(h, 17) * _P32_4) & M
        i += 4
    while i < n:
        h = (h + data[i] * _P32_5) & M
        h = (rotl(h, 11) * _P32_1) & M
        i += 1
    h ^= h >> 15
    h = (h * _P32_2) & M
    h ^= h >> 13
    h = (h * _P32_3) & M
    h ^= h >> 16
    return h


def _siphash24_bytes(data: bytes, k0: int = 0, k1: int = 0) -> int:
    """SipHash-2-4 (reference src/Common/SipHash.h uses zero key)."""
    M = 0xFFFFFFFFFFFFFFFF
    def rotl(x, r):
        return ((x << r) | (x >> (64 - r))) & M
    v0 = 0x736f6d6570736575 ^ k0
    v1 = 0x646f72616e646f6d ^ k1
    v2 = 0x6c7967656e657261 ^ k0
    v3 = 0x7465646279746573 ^ k1

    def sipround(v0, v1, v2, v3):
        v0 = (v0 + v1) & M
        v1 = rotl(v1, 13) ^ v0
        v0 = rotl(v0, 32)
        v2 = (v2 + v3) & M
        v3 = rotl(v3, 16) ^ v2
        v0 = (v0 + v3) & M
        v3 = rotl(v3, 21) ^ v0
        v2 = (v2 + v1) & M
        v1 = rotl(v1, 17) ^ v2
        v2 = rotl(v2, 32)
        return v0, v1, v2, v3

    n = len(data)
    i = 0
    while i + 8 <= n:
        m = int.from_bytes(data[i:i + 8], "little")
        v3 ^= m
        v0, v1, v2, v3 = sipround(v0, v1, v2, v3)
        v0, v1, v2, v3 = sipround(v0, v1, v2, v3)
        v0 ^= m
        i += 8
    b = (n & 0xFF) << 56
    b |= int.from_bytes(data[i:n], "little")
    v3 ^= b
    v0, v1, v2, v3 = sipround(v0, v1, v2, v3)
    v0, v1, v2, v3 = sipround(v0, v1, v2, v3)
    v0 ^= b
    v2 ^= 0xFF
    for _ in range(4):
        v0, v1, v2, v3 = sipround(v0, v1, v2, v3)
    return (v0 ^ v1 ^ v2 ^ v3) & M


def _siphash24_fixed(u: torch.Tensor, nbytes: int) -> torch.Tensor:
    """SipHash-2-4 (zero key) of an nbytes little-endian message per lane,
    on int64 bits."""
    def sipround(v0, v1, v2, v3):
        v0 = v0 + v1
        v1 = _rotl64(v1, 13) ^ v0
        v0 = _rotl64(v0, 32)
        v2 = v2 + v3
        v3 = _rotl64(v3, 16) ^ v2
        v0 = v0 + v3
        v3 = _rotl64(v3, 21) ^ v0
        v2 = v2 + v1
        v1 = _rotl64(v1, 17) ^ v2
        v2 = _rotl64(v2, 32)
        return v0, v1, v2, v3

    v0 = torch.full_like(u, _k(0x736f6d6570736575))
    v1 = torch.full_like(u, _k(0x646f72616e646f6d))
    v2 = torch.full_like(u, _k(0x6c7967656e657261))
    v3 = torch.full_like(u, _k(0x7465646279746573))
    if nbytes == 8:
        m = u
        v3 = v3 ^ m
        v0, v1, v2, v3 = sipround(v0, v1, v2, v3)
        v0, v1, v2, v3 = sipround(v0, v1, v2, v3)
        v0 = v0 ^ m
        b = torch.full_like(u, 8 << 56)
    else:
        b = (nbytes << 56) | (u & ((1 << (8 * nbytes)) - 1))
    v3 = v3 ^ b
    v0, v1, v2, v3 = sipround(v0, v1, v2, v3)
    v0, v1, v2, v3 = sipround(v0, v1, v2, v3)
    v0 = v0 ^ b
    v2 = v2 ^ 0xFF
    for _ in range(4):
        v0, v1, v2, v3 = sipround(v0, v1, v2, v3)
    return v0 ^ v1 ^ v2 ^ v3


# CityHash v1.0.2 (the reference vendors this exact version:
# contrib/cityhash102) — full host implementation + device short path

_K0 = 0xc3a5c85c97cb3127
_K1 = 0xb492b66fbe98f273
_K2 = 0x9ae16a3b2f90404f
_K3 = 0xc949d7c7509e6557
_KMUL = 0x9ddfea08eb382d69
_M64 = 0xFFFFFFFFFFFFFFFF


def _ch_rot(x, r):
    return x if r == 0 else ((x >> r) | (x << (64 - r))) & _M64


def _ch_rot_at_least_1(x, r):
    return _ch_rot(x, r) if r else _ch_rot(x, 1)


def _hash128to64(lo, hi):
    a = ((lo ^ hi) * _KMUL) & _M64
    a ^= a >> 47
    b = ((hi ^ a) * _KMUL) & _M64
    b ^= b >> 47
    return (b * _KMUL) & _M64


def _f64(s, i):
    return int.from_bytes(s[i:i + 8], "little")


def _f32b(s, i):
    return int.from_bytes(s[i:i + 4], "little")


def _city_len0to16(s):
    n = len(s)
    if n > 8:
        a = _f64(s, 0)
        b = _f64(s, n - 8)
        return _hash128to64(a, _ch_rot_at_least_1((b + n) & _M64, n & 63)) ^ b
    if n >= 4:
        a = _f32b(s, 0)
        return _hash128to64((n + (a << 3)) & _M64, _f32b(s, n - 4))
    if n > 0:
        a, b, c = s[0], s[n >> 1], s[n - 1]
        y = (a + (b << 8)) & _M64
        z = (n + (c << 2)) & _M64
        return (_shift_mix((y * _K2) ^ (z * _K3)) * _K2) & _M64
    return _K2


def _city_len17to32(s):
    n = len(s)
    a = (_f64(s, 0) * _K1) & _M64
    b = _f64(s, 8)
    c = (_f64(s, n - 8) * _K2) & _M64
    d = (_f64(s, n - 16) * _K0) & _M64
    return _hash128to64(
        (_ch_rot((a - b) & _M64, 43) + _ch_rot(c, 30) + d) & _M64,
        (a + _ch_rot((b ^ _K3), 20) - c + n) & _M64)


def _city_weak(w, x, y, z, a, b):
    a = (a + w) & _M64
    b = _ch_rot((b + a + z) & _M64, 21)
    c = a
    a = (a + x + y) & _M64
    b = (b + _ch_rot(a, 44)) & _M64
    return (a + z) & _M64, (b + c) & _M64


def _city_weak_s(s, i, a, b):
    return _city_weak(_f64(s, i), _f64(s, i + 8), _f64(s, i + 16),
                      _f64(s, i + 24), a, b)


def _city_len33to64(s):
    n = len(s)
    z = _f64(s, 24)
    a = (_f64(s, 0) + (n + _f64(s, n - 16)) * _K0) & _M64
    b = _ch_rot((a + z) & _M64, 52)
    c = _ch_rot(a, 37)
    a = (a + _f64(s, 8)) & _M64
    c = (c + _ch_rot(a, 7)) & _M64
    a = (a + _f64(s, 16)) & _M64
    vf = (a + z) & _M64
    vs = (b + _ch_rot(a, 31) + c) & _M64
    a = (_f64(s, 16) + _f64(s, n - 32)) & _M64
    z = _f64(s, n - 8)
    b = _ch_rot((a + z) & _M64, 52)
    c = _ch_rot(a, 37)
    a = (a + _f64(s, n - 24)) & _M64
    c = (c + _ch_rot(a, 7)) & _M64
    a = (a + _f64(s, n - 16)) & _M64
    wf = (a + z) & _M64
    ws = (b + _ch_rot(a, 31) + c) & _M64
    r = _shift_mix(((vf + ws) * _K2 + (wf + vs) * _K0) & _M64)
    return (_shift_mix((r * _K0 + vs) & _M64) * _K2) & _M64


def _cityhash64_bytes(s: bytes) -> int:
    n = len(s)
    if n <= 16:
        return _city_len0to16(s)
    if n <= 32:
        return _city_len17to32(s)
    if n <= 64:
        return _city_len33to64(s)
    x = _f64(s, 0)
    y = (_f64(s, n - 16) ^ _K1) & _M64
    z = (_f64(s, n - 56) ^ _K0) & _M64
    v = _city_weak_s(s, n - 64, n, y)
    w = _city_weak_s(s, n - 32, (n * _K1) & _M64, _K0)
    z = (z + _shift_mix(v[1]) * _K1) & _M64
    x = (_ch_rot((z + x) & _M64, 39) * _K1) & _M64
    y = (_ch_rot(y, 33) * _K1) & _M64
    i = 0
    length = (n - 1) & ~63
    while True:
        x = (_ch_rot((x + y + v[0] + _f64(s, i + 16)) & _M64, 37) * _K1) & _M64
        y = (_ch_rot((y + v[1] + _f64(s, i + 48)) & _M64, 42) * _K1) & _M64
        x ^= w[1]
        y ^= v[0]
        z = _ch_rot((z ^ w[0]) & _M64, 33)
        v = _city_weak_s(s, i, (v[1] * _K1) & _M64, (x + w[0]) & _M64)
        w = _city_weak_s(s, i + 32, (z + w[1]) & _M64, y)
        z, x = x, z
        i += 64
        length -= 64
        if length == 0:
            break
    return _hash128to64(
        (_hash128to64(v[0], w[0]) + _shift_mix(y) * _K1 + z) & _M64,
        (_hash128to64(v[1], w[1]) + x) & _M64)


def _shift_mix(v):
    return (v ^ (v >> 47)) & _M64


def _city_fixed(u: torch.Tensor, nbytes: int) -> torch.Tensor:
    """CityHash64 of a 4- or 8-byte message per lane (HashLen0to16 closed
    form, CityHash v1.0.2), on int64 bits."""
    kmul = _k(_KMUL)

    def h128to64(lo, hi):
        a = (lo ^ hi) * kmul
        a = a ^ _shr64(a, 47)
        b = (hi ^ a) * kmul
        b = b ^ _shr64(b, 47)
        return b * kmul

    # HashLen0to16: 4..8-byte messages take the two-u32 branch
    # (a = first 4 bytes, b = last 4 bytes of the little-endian message)
    lo = u & 0xFFFFFFFF
    if nbytes == 8:
        return h128to64(8 + (lo << 3), _shr64(u, 32))
    return h128to64(nbytes + (lo << 3), lo)


def _as_u64_lanes(v: Value, env: Env) -> tuple:
    """(int64 lanes holding the message bits, message width in bytes) for
    a numeric value — hashing covers the value's in-memory bytes in the
    JAX package's type, like the reference."""
    x = _numeric(v, env.n_rows)
    if x.dtype == torch.bool:
        return x.to(torch.int64), 1
    w = _width_bytes(v)
    if x.is_floating_point():
        if w == 4:
            return x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF, 4
        return x.view(torch.int64), 8
    if w == 8:
        return x.to(torch.int64), 8
    # the JAX package's bitcast of the int32 cast to uint32
    return x.to(torch.int32).to(torch.int64) & 0xFFFFFFFF, w


def _hash_dispatch(v: Value, env: Env, device_fixed, host_bytes) -> Value:
    if v.is_string:
        if v.dictionary is None:
            h = host_bytes(v.py.encode())
            return Value(torch.tensor(_to_i64_bits(h), dtype=torch.int64,
                                      device=env.device),
                         is_scalar=True, py=h, u64=True)
        lut = _host_lut_u64([host_bytes(s.encode())
                             for s in v.dictionary.values])
        return _u64_value(_dict_map(v, lut), v.valid)
    u, w = _as_u64_lanes(v, env)
    if v.is_scalar:
        return _u64_value(device_fixed(u.reshape(1), w)[0], None,
                          is_scalar=True)
    return _u64_value(device_fixed(u, w), v.valid)


@func("xxHash64")
def _f_xxhash64(args, env):
    return _hash_dispatch(args[0], env, _xxh64_fixed, _xxh64_bytes)


@func("xxHash32")
def _f_xxhash32(args, env):
    v = args[0]
    if v.is_string and v.dictionary is not None:
        lut = np.array([_xxh32_bytes(s.encode()) for s in v.dictionary.values]
                       or [0], dtype=np.int64)
        return _u32_value(_dict_map(v, lut), v.valid)
    if v.is_string:
        h = _xxh32_bytes(v.py.encode())
        return Value(_scalar(h, env.device), is_scalar=True, py=h,
                     umax=_U32)
    # numerics: host evaluation over the raw bytes (exact)
    x = host_rows(v)
    if x.dtype == np.bool_:
        x = x.astype(np.uint8)
    out = np.array([_xxh32_bytes(r.tobytes()) for r in x.reshape(-1)],
                   dtype=np.int64).reshape(x.shape)
    return _u32_value(to_tensor(out, env.device), v.valid)


@func("sipHash64")
def _f_siphash64(args, env):
    return _hash_dispatch(args[0], env, _siphash24_fixed, _siphash24_bytes)


@func("cityHash64")
def _f_cityhash64(args, env):
    return _hash_dispatch(args[0], env, _city_fixed, _cityhash64_bytes)


def _int_hash64(x: torch.Tensor) -> torch.Tensor:
    # reference src/Common/HashTable/Hash.h intHash64: murmur-style
    # finalizer over the value's 64-bit sign extension
    u = x.to(torch.int64)
    u = u ^ _shr64(u, 33)
    u = u * _k(0xff51afd7ed558ccd)
    u = u ^ _shr64(u, 33)
    u = u * _k(0xc4ceb9fe1a85ec53)
    return u ^ _shr64(u, 33)


@func("intHash64")
def _f_inthash64(args, env):
    return _u64_value(_int_hash64(_numeric(args[0], env.n_rows)),
                      args[0].valid)


@func("intHash32")
def _f_inthash32(args, env):
    # reference intHash32: 64-bit mix folded to 32 (Hash.h intHash32<salt=0>)
    return _u32_value(_int_hash64(_numeric(args[0], env.n_rows)) &
                      0xFFFFFFFF, args[0].valid)


def _digest_fn(algo):
    def impl(args, env):
        v = args[0]
        def dig(s: str) -> str:
            return hashlib.new(algo, s.encode()).hexdigest().upper()
        if v.dictionary is None and isinstance(v.py, str):
            return Value(None, is_scalar=True, py=dig(v.py))
        if v.dictionary is None:
            raise EvalError(f"{algo} expects a string")
        nd = StringDictionary([dig(s) for s in v.dictionary.values])
        return Value(v.data, v.valid, nd)
    return impl


for _a, _nm in [("md5", "MD5"), ("sha1", "SHA1"), ("sha224", "SHA224"),
                ("sha256", "SHA256"), ("sha512", "SHA512")]:
    _FUNCS[_nm.lower()] = _digest_fn(_a)


@func("halfMD5")
def _f_halfmd5(args, env):
    v = args[0]
    def h(s: bytes) -> int:
        return int.from_bytes(hashlib.md5(s).digest()[:8], "big")
    if v.dictionary is None and isinstance(v.py, str):
        r = h(v.py.encode())
        return Value(torch.tensor(_to_i64_bits(r), dtype=torch.int64,
                                  device=env.device),
                     is_scalar=True, py=r, u64=True)
    if v.dictionary is not None:
        lut = _host_lut_u64([h(s.encode()) for s in v.dictionary.values])
        return _u64_value(_dict_map(v, lut), v.valid)
    x = host_rows(v)
    out = _host_lut_u64([h(r.tobytes()) for r in x.reshape(-1)])
    return _u64_value(to_tensor(out[:x.size].reshape(x.shape), env.device),
                      v.valid)


# ---------------------------------------------------------------------------
# encoding: hex/bin/base64 (unhex, unbin and char are in exec/expr.py)

def _unique_strings(v: Value, x: np.ndarray, fmt, env) -> Value:
    """A String value from a per-distinct-value formatter over host rows."""
    if v.is_scalar:
        return Value(None, is_scalar=True, py=fmt(np.asarray(x)[()]))
    uniq, inv = np.unique(x, return_inverse=True)
    sd = StringDictionary()
    remap = sd.encode([fmt(u) for u in uniq])
    return Value(to_tensor(remap[inv].astype(np.int32), env.device),
                 v.valid, sd)


@func("hex")
def _f_hex(args, env):
    v = args[0]
    if v.is_string:
        # latin-1: strings are byte-transparent (unhex/char round-trip)
        return _dict_transform(
            v, lambda s: s.encode("latin-1", "replace").hex().upper())
    x = host_rows(v)
    size = np.dtype(x.dtype).itemsize
    if np.issubdtype(x.dtype, np.floating):
        def fmt(r):
            return r.tobytes().hex().upper()
    else:
        def fmt(r):
            i = int(r)
            if i == 0:
                return "00"
            nb = max(1, (i.bit_length() + 7) // 8) if i >= 0 else size
            if i < 0:
                i &= (1 << (8 * size)) - 1
                nb = size
            return i.to_bytes(nb, "big").hex().upper()
    return _unique_strings(v, x, fmt, env)


@func("randomPrintableASCII")
def _f_random_printable_ascii(args, env):
    """Per-row random printable string of the given length (reference:
    src/Functions/randomPrintableASCII.cpp).  Deterministic per process via
    a module counter — golden tests only consume counts/lengths."""
    ln = args[0]
    n = env.n_rows
    length = int(ln.py if ln.is_scalar and ln.py is not None
                 else ln.data.reshape(-1)[0])
    global _RAND_ASCII_STATE
    rng = np.random.default_rng(_RAND_ASCII_STATE)
    _RAND_ASCII_STATE += 1
    chars = rng.integers(32, 127, size=(n, max(length, 0)))
    out = ["".join(chr(c) for c in row) for row in chars]
    sd = StringDictionary()
    ids = sd.encode(out)
    return Value(to_tensor(np.asarray(ids).astype(np.int32), env.device),
                 None, sd)


_RAND_ASCII_STATE = 12345


@func("bin")
def _f_bin(args, env):
    v = args[0]
    x = host_rows(v)
    w = 8 * np.dtype(x.dtype).itemsize

    def fmt(r):
        i = int(r)
        if i < 0:
            i &= (1 << w) - 1
        s = format(i, "b")
        pad = ((len(s) + 7) // 8) * 8
        return s.zfill(max(pad, 8))
    return _unique_strings(v, x, fmt, env)


@func("base64Encode")
def _f_base64encode(args, env):
    return _dict_transform(args[0],
                           lambda s: _b64.b64encode(s.encode()).decode())


@func("base64Decode", "tryBase64Decode")
def _f_base64decode(args, env):
    def dec(s):
        try:
            return _b64.b64decode(s).decode("utf-8", "replace")
        except Exception:
            return ""
    return _dict_transform(args[0], dec)


# ---------------------------------------------------------------------------
# JSON extraction (host over dictionary values;
# reference src/Functions/FunctionsJSON.h with simdjson)

def _json_walk(doc, path):
    cur = doc
    for p in path:
        if isinstance(p, str):
            if not isinstance(cur, dict) or p not in cur:
                return None, False
            cur = cur[p]
        else:
            if not isinstance(cur, (list, dict)):
                return None, False
            seq = list(cur.values()) if isinstance(cur, dict) else cur
            i = int(p)
            i = i - 1 if i > 0 else len(seq) + i    # 1-based; negatives from end
            if i < 0 or i >= len(seq):
                return None, False
            cur = seq[i]
    return cur, True


def _json_path(args):
    path = []
    for a in args:
        if isinstance(a.py, str):
            path.append(a.py)
        elif a.py is not None:
            path.append(int(a.py))
        else:
            path.append(int(a.data))   # e.g. unary-minus index
    return path


def _json_apply(args, env, fn, dtype=None, dictionary_out=False):
    v = args[0]
    path = _json_path(args[1:])

    def run(s):
        try:
            doc = _json.loads(s)
        except Exception:
            return fn(None, False)
        node, ok = _json_walk(doc, path)
        return fn(node, ok)
    if v.dictionary is None and isinstance(v.py, str):
        r = run(v.py)
        if dictionary_out:
            return Value(None, is_scalar=True, py=r)
        return Value(_scalar(r, env.device), is_scalar=True, py=r)
    if v.dictionary is None:
        raise EvalError("JSON functions expect a String argument")
    outs = [run(s) for s in v.dictionary.values]
    if dictionary_out:
        sd = StringDictionary()
        remap = sd.encode([o for o in outs] or [""])
        ids = v.data.cpu().numpy()
        if len(outs):
            ids = np.where(ids == NULL_ID, NULL_ID,
                           remap[np.clip(ids, 0, len(outs) - 1)])
        return Value(to_tensor(ids.astype(np.int32), env.device), v.valid,
                     sd)
    lut = np.array(outs or [0], dtype=dtype)
    return Value(_dict_map(v, lut), v.valid)


@func("JSONHas")
def _f_jsonhas(args, env):
    return _json_apply(args, env, lambda n, ok: ok, dtype=bool)


@func("JSONLength")
def _f_jsonlength(args, env):
    def fn(n, ok):
        if not ok or not isinstance(n, (list, dict)):
            return 0
        return len(n)
    return _json_apply(args, env, fn, dtype=np.int64)


@func("JSONType")
def _f_jsontype(args, env):
    def fn(n, ok):
        if not ok:
            return ""
        return {dict: "Object", list: "Array", str: "String", bool: "Bool",
                int: "Int64", float: "Double",
                type(None): "Null"}.get(type(n), "String")
    return _json_apply(args, env, fn, dictionary_out=True)


@func("JSONExtractString", "simpleJSONExtractString",
      "visitParamExtractString")
def _f_jsonextractstring(args, env):
    def fn(n, ok):
        if not ok or n is None:
            return ""
        return n if isinstance(n, str) else ""
    return _json_apply(args, env, fn, dictionary_out=True)


@func("JSONExtractInt", "simpleJSONExtractInt", "visitParamExtractInt")
def _f_jsonextractint(args, env):
    def fn(n, ok):
        if not ok:
            return 0
        if isinstance(n, bool):
            return int(n)
        if isinstance(n, (int, float)):
            return int(n)
        if isinstance(n, str):
            try:
                return int(float(n))
            except ValueError:
                return 0
        return 0
    return _json_apply(args, env, fn, dtype=np.int64)


@func("JSONExtractFloat", "simpleJSONExtractFloat", "visitParamExtractFloat")
def _f_jsonextractfloat(args, env):
    def fn(n, ok):
        if not ok:
            return 0.0
        if isinstance(n, (int, float)) and not isinstance(n, bool):
            return float(n)
        if isinstance(n, str):
            try:
                return float(n)
            except ValueError:
                return 0.0
        return 0.0
    return _json_apply(args, env, fn, dtype=np.float64)


@func("JSONExtractBool", "simpleJSONExtractBool", "visitParamExtractBool")
def _f_jsonextractbool(args, env):
    return _json_apply(args, env,
                       lambda n, ok: bool(n) if ok and
                       isinstance(n, bool) else False, dtype=bool)


@func("JSONExtractRaw", "simpleJSONExtractRaw", "visitParamExtractRaw")
def _f_jsonextractraw(args, env):
    def fn(n, ok):
        if not ok:
            return ""
        return _json.dumps(n, separators=(",", ":"))
    return _json_apply(args, env, fn, dictionary_out=True)


@func("JSONExtractKeys")
def _f_jsonextractkeys(args, env):
    # returns Array(String) of object keys
    from myscaledb_tpu_torch.exec.expr import _ragged_ids
    v = args[0]
    path = _json_path(args[1:])
    if v.dictionary is None:
        raise EvalError("JSONExtractKeys expects a String column")
    per_id = []
    for s in v.dictionary.values:
        try:
            node, ok = _json_walk(_json.loads(s), path)
        except Exception:
            node, ok = None, False
        per_id.append(list(node.keys()) if ok and isinstance(node, dict)
                      else [])
    flat, offsets, nd = _ragged_ids(per_id, v, env)
    return Value(flat, v.valid, nd, offsets=offsets)


@func("isValidJSON")
def _f_isvalidjson(args, env):
    v = args[0]

    def ok(s):
        try:
            _json.loads(s)
            return True
        except Exception:
            return False
    if v.dictionary is None and isinstance(v.py, str):
        r = ok(v.py)
        return Value(_scalar(r, env.device), is_scalar=True, py=r)
    lut = np.array([ok(s) for s in v.dictionary.values] or [False],
                   dtype=bool)
    return Value(_dict_map(v, lut), v.valid)


# ---------------------------------------------------------------------------
# URL functions (host over dictionary values; reference src/Functions/URL/*)

def _url_transform(fn):
    def impl(args, env):
        return _dict_transform(args[0], fn)
    return impl


def _u_protocol(s):
    i = s.find("://")
    return s[:i].lower() if i > 0 else ""

def _u_domain(s):
    try:
        netloc = urlsplit(s if "://" in s else "//" + s).netloc
    except ValueError:
        return ""
    host = netloc.rsplit("@", 1)[-1].split(":")[0]
    # ClickHouse domain.h checkAndReturnHost: a host without any '.' is not
    # a domain — plain strings yield '' (reference src/Functions/URL/domain.h).
    return host if "." in host else ""

def _u_domain_without_www(s):
    d = _u_domain(s)
    return d[4:] if d.startswith("www.") else d

def _u_tld(s):
    d = _u_domain(s)
    return d.rsplit(".", 1)[-1] if "." in d else ""

def _u_rest(s):
    """Everything after the authority (reference src/Functions/URL/path.h:
    the path starts at the first '/' past scheme://host — a string without
    one has no path at all, unlike urlsplit's relative-path reading)."""
    rest = s.split("://", 1)[1] if "://" in s else s
    i = rest.find("/")
    return "" if i < 0 else rest[i:]

def _u_path(s):
    return _u_rest(s).split("#", 1)[0].split("?", 1)[0]

def _u_pathfull(s):
    return _u_rest(s)

def _u_query(s):
    try:
        return urlsplit(s).query
    except ValueError:
        return ""

def _u_fragment(s):
    try:
        return urlsplit(s).fragment
    except ValueError:
        return ""

def _u_qsf(s):
    try:
        u = urlsplit(s)
    except ValueError:
        return ""
    out = u.query
    if u.fragment:
        out += "#" + u.fragment
    return out

def _u_cut_query(s):
    return s.split("?", 1)[0]

def _u_cut_fragment(s):
    return s.split("#", 1)[0]

def _u_cut_qsf(s):
    return s.split("#", 1)[0].split("?", 1)[0]

def _u_cut_www(s):
    return s.replace("://www.", "://", 1) if "://www." in s else \
        (s[4:] if s.startswith("www.") else s)

_FUNCS["protocol"] = _url_transform(_u_protocol)
_FUNCS["domain"] = _url_transform(_u_domain)
_FUNCS["domainwithoutwww"] = _url_transform(_u_domain_without_www)
_FUNCS["topleveldomain"] = _url_transform(_u_tld)
_FUNCS["path"] = _url_transform(_u_path)
_FUNCS["pathfull"] = _url_transform(_u_pathfull)
_FUNCS["querystring"] = _url_transform(_u_query)
_FUNCS["fragment"] = _url_transform(_u_fragment)
_FUNCS["querystringandfragment"] = _url_transform(_u_qsf)
_FUNCS["cutquerystring"] = _url_transform(_u_cut_query)
_FUNCS["cutfragment"] = _url_transform(_u_cut_fragment)
_FUNCS["cutquerystringandfragment"] = _url_transform(_u_cut_qsf)
_FUNCS["cutwww"] = _url_transform(_u_cut_www)
_FUNCS["decodeurlcomponent"] = _url_transform(unquote)
_FUNCS["encodeurlcomponent"] = _url_transform(
    lambda s: quote(s, safe=""))


@func("extractURLParameter")
def _f_extracturlparameter(args, env):
    name = args[1].py

    def fn(s):
        q = _u_query(s) or (_u_fragment(s).split("?", 1)[1]
                            if "?" in _u_fragment(s) else "")
        for kv in q.split("&"):
            if kv.startswith(name + "="):
                return kv[len(name) + 1:]
            if kv == name:
                return ""
        return ""
    return _dict_transform(args[0], fn)


@func("firstSignificantSubdomain")
def _f_firstsignificantsubdomain(args, env):
    def fn(s):
        d = _u_domain(s)
        parts = d.split(".")
        if len(parts) < 2:
            return d
        second = {"com", "net", "org", "co", "gov", "edu", "mil"}
        if len(parts) >= 3 and parts[-2] in second:
            return parts[-3]
        return parts[-2]
    return _dict_transform(args[0], fn)


# ---------------------------------------------------------------------------
# string extras

@func("left")
def _f_left(args, env):
    n = int(args[1].py)
    return _dict_transform(args[0], lambda s: s[:n] if n >= 0 else
                           s[:max(len(s) + n, 0)])


@func("right")
def _f_right(args, env):
    n = int(args[1].py)
    return _dict_transform(args[0], lambda s: s[-n:] if n > 0 else
                           (s[min(-n, len(s)):] if n < 0 else ""))


@func("space")
def _f_space(args, env):
    v = args[0]
    if v.is_scalar:
        return Value(None, is_scalar=True, py=" " * int(v.py))
    return _unique_strings(v, host_rows(v),
                           lambda u: " " * max(int(u), 0), env)


@func("ascii")
def _f_ascii(args, env):
    return _dict_lut(args[0], lambda s: ord(s[0]) if s else 0, np.int32, 0)


@func("concatWithSeparator", "concat_ws")
def _f_concatwithseparator(args, env):
    sep = args[0]
    if not isinstance(sep.py, str):
        raise EvalError("concatWithSeparator: separator must be a literal")
    new_args = []
    for i, a in enumerate(args[1:]):
        if i:
            new_args.append(Value(None, is_scalar=True, py=sep.py))
        new_args.append(a)
    return _FUNCS["concat"](new_args, env)


@func("substringIndex")
def _f_substringindex(args, env):
    delim, cnt = args[1].py, int(args[2].py)

    def fn(s):
        parts = s.split(delim)
        if cnt > 0:
            return delim.join(parts[:cnt])
        if cnt < 0:
            return delim.join(parts[cnt:])
        return ""
    return _dict_transform(args[0], fn)


@func("countSubstrings")
def _f_countsubstrings(args, env):
    pat = args[1].py
    return _dict_lut(args[0], lambda s: s.count(pat), np.int64, 0)


@func("positionCaseInsensitive")
def _f_positioncaseinsensitive(args, env):
    pat = args[1].py.lower()
    return _dict_lut(args[0], lambda s: s.lower().find(pat) + 1, np.int64,
                     0)


@func("multiSearchAny")
def _f_multisearchany(args, env):
    pats = _literal_list(args[1])
    if not isinstance(pats, list):
        raise EvalError("multiSearchAny needs an array literal of patterns")
    return _dict_lut(args[0], lambda s: any(str(p) in s for p in pats),
                     bool, False)


@func("multiSearchFirstIndex")
def _f_multisearchfirstindex(args, env):
    pats = [str(p) for p in _literal_list(args[1])]

    def first(s):
        for i, p in enumerate(pats):
            if p in s:
                return i + 1
        return 0
    return _dict_lut(args[0], first, np.int64, 0)


@func("hasToken")
def _f_hastoken(args, env):
    rx = re.compile(r"(?<![A-Za-z0-9_])" + re.escape(args[1].py) +
                    r"(?![A-Za-z0-9_])")
    return _dict_lut(args[0], lambda s: bool(rx.search(s)), bool, False)


# ---------------------------------------------------------------------------
# randomness (host-seeded; the reference's pcg-based FunctionsRandom)

@func("rand", "rand32")
def _f_rand(args, env):
    g = np.random.default_rng()
    out = g.integers(0, 1 << 32, env.n_rows, dtype=np.int64)
    return _u32_value(to_tensor(out, env.device), None)


@func("rand64")
def _f_rand64(args, env):
    g = np.random.default_rng()
    out = g.integers(0, 1 << 63, env.n_rows, dtype=np.int64)
    return _u64_value(to_tensor(out, env.device), None)


@func("randCanonical")
def _f_randcanonical(args, env):
    g = np.random.default_rng()
    return Value(to_tensor(g.random(env.n_rows, dtype=np.float32),
                           env.device))


@func("randConstant")
def _f_randconstant(args, env):
    g = np.random.default_rng()
    val = int(g.integers(0, 1 << 32))
    return Value(_scalar(val, env.device), is_scalar=True, py=val,
                 umax=_U32)


@func("generateUUIDv4")
def _f_generateuuidv4(args, env):
    import uuid
    sd = StringDictionary()
    ids = sd.encode([str(uuid.uuid4()) for _ in range(env.n_rows)])
    return Value(to_tensor(ids, env.device), None, sd)


# ---------------------------------------------------------------------------
# IPv4

@func("IPv4NumToString")
def _f_ipv4numtostring(args, env):
    v = args[0]
    x = host_rows(v).astype(np.int64)
    return _unique_strings(
        Value(None, v.valid), x,
        lambda u: socket.inet_ntoa(int(u % (1 << 32)).to_bytes(4, "big")),
        env)


@func("IPv4StringToNum", "toIPv4")
def _f_ipv4stringtonum(args, env):
    v = args[0]

    def conv(s):
        try:
            return int.from_bytes(socket.inet_aton(s), "big")
        except OSError:
            return 0
    if v.dictionary is None and isinstance(v.py, str):
        r = conv(v.py)
        return Value(_scalar(r, env.device), is_scalar=True, py=r, umax=_U32)
    lut = np.array([conv(s) for s in v.dictionary.values] or [0],
                   dtype=np.int64)
    return _u32_value(_dict_map(v, lut), v.valid)


# ---------------------------------------------------------------------------
# environment info

@func("hostName")
def _f_hostname(args, env):
    return Value(None, is_scalar=True, py=socket.gethostname())


@func("version")
def _f_version(args, env):
    from myscaledb_tpu_torch import __version__
    return Value(None, is_scalar=True, py=__version__)


@func("currentUser")
def _f_currentuser(args, env):
    user = getattr(env, "current_user", None) or "default"
    return Value(None, is_scalar=True, py=user)


@func("finalizeAggregation")
def _f_finalize_aggregation(args, env):
    """An aggregate -State value finalized to its result (reference:
    finalizeAggregation.cpp), as Float64: each distinct state string is
    parsed once (sql/agg_fns.py, kept in the session's derived-state
    cache) and the rows gather the results on the device."""
    from myscaledb_tpu_torch.sql.agg_fns import (_parse_states,
                                                 finalized_states,
                                                 parsed_states)
    v = args[0]
    if v.is_scalar:
        if not isinstance(v.py, str):
            raise EvalError("finalizeAggregation expects a state string")
        st = _json.loads(v.py)
        x = finalized_states(_parse_states(
            StringDictionary([v.py]), env.device))[0].item()
        if st.get("f") not in ("avg", "uniq", "qtd"):
            x = st.get("v")            # the state's own JSON number
        elif st.get("f") == "uniq":
            x = int(x)
        from myscaledb_tpu_torch.exec.expr import _scalar
        return Value(_scalar(0 if x is None else x, env.device),
                     is_scalar=True, py=x)
    if v.dictionary is None:
        raise EvalError("finalizeAggregation expects a state column")
    ps = parsed_states(env.session, v.dictionary, env.device) \
        if env.session is not None else \
        _parse_states(v.dictionary, env.device)
    lut = finalized_states(ps)
    ids = v.data.long()
    out = torch.where((ids >= 0) & (ids < len(v.dictionary)),
                      lut[torch.clamp(ids, 0, lut.shape[0] - 1)],
                      float("nan"))
    return Value(out, v.valid)
