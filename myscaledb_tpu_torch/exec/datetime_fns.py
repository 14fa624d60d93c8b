"""Date/time functions as integer tensor math: the port of
myscaledb_tpu/exec/datetime_fns.py.

Date = days since 1970-01-01 (int32 storage); DateTime = unix seconds
(int64 storage).  The reference decomposes dates through a 2-byte-per-day
lookup table (src/Common/DateLUTImpl.h); every calendar function here uses
the branch-free civil-calendar integer algorithm (Howard Hinnant's
days/civil algorithms) on int64 tensors, a handful of elementwise ops per
row on whatever device the column lives on.

``//`` and ``%`` on tensors are floor division and floor modulo, as
``jnp.floor_divide``/``jnp.mod`` are, so every result is the JAX package's
bit for bit.  ``formatDateTime`` formats on the host once per distinct
value.  Function inventory mirrors src/Functions/{toYear,toMonth,...}.cpp,
src/Functions/toStartOf*.cpp, addDays/addMonths etc.
(src/Functions/FunctionDateOrDateTimeAddInterval.h) and dateDiff
(src/Functions/dateDiff.cpp).
"""

from __future__ import annotations

import datetime as _dt

import numpy as np
import torch

from myscaledb_tpu_torch.core.types import DataType
from myscaledb_tpu_torch.core.dictionary import StringDictionary
from myscaledb_tpu_torch.core.table import to_tensor
from myscaledb_tpu_torch.exec.expr import (Env, Value, EvalError, func,
                                           _numeric, _both_valid, _dict_map,
                                           _scalar)

EPOCH = _dt.date(1970, 1, 1)
I32 = torch.int32
I64 = torch.int64


# ---------------------------------------------------------------------------
# civil-calendar math (all int64, branch-free)

def _days_of(v: Value, env: Env) -> torch.Tensor:
    """Days-since-epoch from a DATE or DATETIME value."""
    x = _numeric(v, env.n_rows).to(I64)
    if v.dt is DataType.DATETIME:
        return x // 86400
    return x


def _secs_of(v: Value, env: Env) -> torch.Tensor:
    """Seconds-since-epoch (DATE promotes to midnight)."""
    x = _numeric(v, env.n_rows).to(I64)
    if v.dt is DataType.DATE:
        return x * 86400
    return x


def civil_from_days(z):
    """days-since-epoch -> (year, month, day), int64 tensors."""
    z = z + 719468
    era = z // 146097
    doe = z - era * 146097                                   # [0, 146096]
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)          # [0, 365]
    mp = (5 * doy + 2) // 153                                # [0, 11]
    d = doy - (153 * mp + 2) // 5 + 1                        # [1, 31]
    m = mp + torch.where(mp < 10, 3, -9)                     # [1, 12]
    return y + (m <= 2).to(I64), m, d


def days_from_civil(y, m, d):
    """(year, month, day) -> days-since-epoch, int64 tensors."""
    y = y - (m <= 2).to(I64)
    era = y // 400
    yoe = y - era * 400                                      # [0, 399]
    mp = m + torch.where(m > 2, -3, 9)
    doy = (153 * mp + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def _weekday(days):
    """ISO day of week: 1 = Monday … 7 = Sunday (1970-01-01 was a Thursday)."""
    return (days + 3) % 7 + 1


def _i64(x, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=I64, device=like.device)


# ---------------------------------------------------------------------------
# literal parsing (host)

def parse_date_literal(s: str, target: DataType):
    """'2024-05-01' / '2024-05-01 12:30:45' -> days or seconds since epoch."""
    s = s.strip()
    try:
        if len(s) <= 10:
            d = _dt.date.fromisoformat(s)
            days = (d - EPOCH).days
            return days if target is DataType.DATE else days * 86400
        t = _dt.datetime.fromisoformat(s)
        secs = int((t - _dt.datetime(1970, 1, 1)).total_seconds())
        return secs // 86400 if target is DataType.DATE else secs
    except ValueError:
        raise EvalError(f"cannot parse date literal {s!r}")


def _date_value(days, valid=None) -> Value:
    return Value(days.to(I32), valid, dt=DataType.DATE)


def _datetime_value(secs, valid=None) -> Value:
    return Value(secs.to(I64), valid, dt=DataType.DATETIME)


def _from_string_arg(v: Value, env: Env, target: DataType):
    """toDate/toDateTime over a string literal or dictionary column."""
    if isinstance(v.py, str):
        n = parse_date_literal(v.py, target)
        return Value(_scalar(n, env.device), is_scalar=True, py=n, dt=target)
    if v.dictionary is not None:
        lut = np.array([parse_date_literal(s, target)
                        for s in v.dictionary.values] or [0], dtype=np.int64)
        return Value(_dict_map(v, lut), v.valid, dt=target)
    return None


# ---------------------------------------------------------------------------
# constructors / conversions

@func("toDate")
def _f_todate(args, env):
    v = args[0]
    s = _from_string_arg(v, env, DataType.DATE)
    if s is not None:
        return s
    return _date_value(_days_of(v, env) if v.dt else
                       _numeric(v, env.n_rows).to(I64), v.valid)


@func("toDateTime")
def _f_todatetime(args, env):
    v = args[0]
    s = _from_string_arg(v, env, DataType.DATETIME)
    if s is not None:
        return s
    return _datetime_value(_secs_of(v, env) if v.dt else
                           _numeric(v, env.n_rows).to(I64), v.valid)


@func("toUnixTimestamp")
def _f_tounixtimestamp(args, env):
    v = args[0]
    if isinstance(v.py, str) or v.dictionary is not None:
        v = _from_string_arg(v, env, DataType.DATETIME)
    return Value(_secs_of(v, env), v.valid)


@func("fromUnixTimestamp", "FROM_UNIXTIME")
def _f_fromunixtimestamp(args, env):
    return _datetime_value(_numeric(args[0], env.n_rows).to(I64),
                           args[0].valid)


def _scalar_day(days: int, env) -> Value:
    return Value(torch.tensor(days, dtype=I32, device=env.device),
                 is_scalar=True, py=days, dt=DataType.DATE)


@func("today")
def _f_today(args, env):
    return _scalar_day((_dt.date.today() - EPOCH).days, env)


@func("yesterday")
def _f_yesterday(args, env):
    return _scalar_day((_dt.date.today() - EPOCH).days - 1, env)


@func("now")
def _f_now(args, env):
    secs = int(_dt.datetime.now().timestamp())
    return Value(torch.tensor(secs, dtype=I64, device=env.device),
                 is_scalar=True, py=secs, dt=DataType.DATETIME)


@func("makeDate")
def _f_makedate(args, env):
    y = _numeric(args[0], env.n_rows).to(I64)
    m = _numeric(args[1], env.n_rows).to(I64)
    d = _numeric(args[2], env.n_rows).to(I64)
    valid = _both_valid(args[0], args[1])
    valid = _both_valid(Value(None, valid), args[2])
    return _date_value(days_from_civil(y, m, d), valid)


@func("makeDateTime")
def _f_makedatetime(args, env):
    parts = [_numeric(a, env.n_rows).to(I64) for a in args[:6]]
    while len(parts) < 6:
        parts.append(torch.zeros((), dtype=I64, device=env.device))
    y, mo, d, h, mi, s = parts
    days = days_from_civil(y, mo, d)
    return _datetime_value(days * 86400 + h * 3600 + mi * 60 + s)


# ---------------------------------------------------------------------------
# calendar parts

@func("toYear")
def _f_toyear(args, env):
    y, _, _ = civil_from_days(_days_of(args[0], env))
    return Value(y.to(I32), args[0].valid)


@func("toMonth")
def _f_tomonth(args, env):
    _, m, _ = civil_from_days(_days_of(args[0], env))
    return Value(m.to(I32), args[0].valid)


@func("toDayOfMonth")
def _f_todayofmonth(args, env):
    _, _, d = civil_from_days(_days_of(args[0], env))
    return Value(d.to(I32), args[0].valid)


@func("toDayOfWeek")
def _f_todayofweek(args, env):
    return Value(_weekday(_days_of(args[0], env)).to(I32), args[0].valid)


@func("toDayOfYear")
def _f_todayofyear(args, env):
    days = _days_of(args[0], env)
    y, _, _ = civil_from_days(days)
    one = _i64(1, days)
    jan1 = days_from_civil(y, one, one)
    return Value((days - jan1 + 1).to(I32), args[0].valid)


@func("toQuarter")
def _f_toquarter(args, env):
    _, m, _ = civil_from_days(_days_of(args[0], env))
    return Value(((m - 1) // 3 + 1).to(I32), args[0].valid)


@func("toHour")
def _f_tohour(args, env):
    s = _secs_of(args[0], env)
    return Value((s % 86400 // 3600).to(I32), args[0].valid)


@func("toMinute")
def _f_tominute(args, env):
    s = _secs_of(args[0], env)
    return Value((s % 3600 // 60).to(I32), args[0].valid)


@func("toSecond")
def _f_tosecond(args, env):
    s = _secs_of(args[0], env)
    return Value((s % 60).to(I32), args[0].valid)


@func("toYYYYMM")
def _f_toyyyymm(args, env):
    y, m, _ = civil_from_days(_days_of(args[0], env))
    return Value((y * 100 + m).to(I32), args[0].valid)


@func("toYYYYMMDD")
def _f_toyyyymmdd(args, env):
    y, m, d = civil_from_days(_days_of(args[0], env))
    return Value((y * 10000 + m * 100 + d).to(I32), args[0].valid)


@func("toYYYYMMDDhhmmss")
def _f_toyyyymmddhhmmss(args, env):
    s = _secs_of(args[0], env)
    y, m, d = civil_from_days(s // 86400)
    tod = s % 86400
    return Value((y * 10 ** 10 + m * 10 ** 8 + d * 10 ** 6 +
                  (tod // 3600) * 10 ** 4 + (tod % 3600 // 60) * 100 +
                  tod % 60).to(I64), args[0].valid)


# ---------------------------------------------------------------------------
# truncation (toStartOf*)

@func("toStartOfYear")
def _f_tostartofyear(args, env):
    y, _, _ = civil_from_days(_days_of(args[0], env))
    one = _i64(1, y)
    return _date_value(days_from_civil(y, one, one), args[0].valid)


@func("toStartOfQuarter")
def _f_tostartofquarter(args, env):
    y, m, _ = civil_from_days(_days_of(args[0], env))
    qm = ((m - 1) // 3) * 3 + 1
    return _date_value(days_from_civil(y, qm, _i64(1, y)), args[0].valid)


@func("toStartOfMonth")
def _f_tostartofmonth(args, env):
    y, m, _ = civil_from_days(_days_of(args[0], env))
    return _date_value(days_from_civil(y, m, _i64(1, y)), args[0].valid)


@func("toMonday", "toStartOfWeek")
def _f_tomonday(args, env):
    days = _days_of(args[0], env)
    return _date_value(days - (_weekday(days) - 1), args[0].valid)


@func("toStartOfDay")
def _f_tostartofday(args, env):
    return _datetime_value(_days_of(args[0], env) * 86400, args[0].valid)


def _truncate_secs(step: int):
    def impl(args, env):
        s = _secs_of(args[0], env)
        return _datetime_value(s - s % step, args[0].valid)
    return impl


func("toStartOfHour")(_truncate_secs(3600))
func("toStartOfMinute")(_truncate_secs(60))
func("toStartOfFifteenMinutes")(_truncate_secs(900))
func("toStartOfFiveMinutes")(_truncate_secs(300))


# ---------------------------------------------------------------------------
# interval arithmetic

def _add_months(days, k):
    y, m, d = civil_from_days(days)
    t = y * 12 + (m - 1) + k
    ny, nm = t // 12, t % 12 + 1
    # clamp day to the target month's length
    one = _i64(1, ny)
    next_m = days_from_civil(ny + (nm == 12).to(I64),
                             torch.where(nm == 12, 1, nm + 1), one)
    first = days_from_civil(ny, nm, one)
    mlen = next_m - first
    return first + torch.minimum(d, mlen) - 1


def _interval_fn(unit: str, sign: int):
    def impl(args, env):
        v = args[0]
        k = _numeric(args[1], env.n_rows).to(I64) * sign
        valid = _both_valid(args[0], args[1])
        if unit in ("year", "quarter", "month"):
            mult = {"year": 12, "quarter": 3, "month": 1}[unit]
            days = _days_of(v, env)
            out = _add_months(days, k * mult)
            if v.dt is DataType.DATETIME:
                s = _secs_of(v, env)
                return _datetime_value(out * 86400 + s % 86400, valid)
            return _date_value(out, valid)
        day_units = {"week": 7, "day": 1}
        if unit in day_units:
            if v.dt is DataType.DATETIME:
                return _datetime_value(
                    _secs_of(v, env) + k * day_units[unit] * 86400, valid)
            return _date_value(_days_of(v, env) + k * day_units[unit], valid)
        sec_units = {"hour": 3600, "minute": 60, "second": 1}
        return _datetime_value(_secs_of(v, env) + k * sec_units[unit], valid)
    return impl


for _u in ("year", "quarter", "month", "week", "day", "hour", "minute",
           "second"):
    func(f"add{_u.capitalize()}s")(_interval_fn(_u, 1))
    func(f"subtract{_u.capitalize()}s")(_interval_fn(_u, -1))


@func("dateAdd", "date_add", "timestampAdd")
def _f_dateadd(args, env):
    unit = args[0].py
    if not isinstance(unit, str):
        raise EvalError("dateAdd(unit, n, date): unit must be a string")
    return _interval_fn(unit.lower(), 1)([args[2], args[1]], env)


@func("dateSub", "date_sub", "timestampSub")
def _f_datesub(args, env):
    unit = args[0].py
    if not isinstance(unit, str):
        raise EvalError("dateSub(unit, n, date): unit must be a string")
    return _interval_fn(unit.lower(), -1)([args[2], args[1]], env)


@func("dateDiff", "date_diff")
def _f_datediff(args, env):
    unit = args[0].py
    if not isinstance(unit, str):
        raise EvalError("dateDiff(unit, a, b)")
    unit = unit.lower()
    a, b = args[1], args[2]
    valid = _both_valid(a, b)
    if unit in ("second", "minute", "hour"):
        div = {"second": 1, "minute": 60, "hour": 3600}[unit]
        d = (_secs_of(b, env) - _secs_of(a, env)) // div
        return Value(d, valid)
    da, db = _days_of(a, env), _days_of(b, env)
    if unit == "day":
        return Value(db - da, valid)
    if unit == "week":
        # reference relativeWeekNum: weeks start Monday
        return Value(((db - (_weekday(db) - 1)) -
                      (da - (_weekday(da) - 1))) // 7, valid)
    ya, ma, _ = civil_from_days(da)
    yb, mb, _ = civil_from_days(db)
    if unit == "month":
        return Value((yb * 12 + mb) - (ya * 12 + ma), valid)
    if unit == "quarter":
        return Value((yb * 4 + (mb - 1) // 3) - (ya * 4 + (ma - 1) // 3),
                     valid)
    if unit == "year":
        return Value(yb - ya, valid)
    raise EvalError(f"dateDiff: unknown unit {unit!r}")


# ---------------------------------------------------------------------------
# formatting (string-producing: handled host-side per distinct value)

@func("formatDateTime")
def _f_formatdatetime(args, env):
    v, fmt = args[0], args[1].py
    if not isinstance(fmt, str):
        raise EvalError("formatDateTime(x, 'format')")
    secs = _secs_of(v, env).cpu().numpy()
    uniq, inv = np.unique(secs, return_inverse=True)
    out = [(_dt.datetime(1970, 1, 1) +
            _dt.timedelta(seconds=int(s))).strftime(fmt) for s in uniq]
    d = StringDictionary()
    ids = d.encode(out)
    return Value(to_tensor(ids[inv] if len(uniq) else
                           np.zeros(0, dtype=np.int32), env.device),
                 v.valid, d)


def format_date(days) -> str:
    if isinstance(days, _dt.date):
        return days.isoformat()
    return (EPOCH + _dt.timedelta(days=int(days))).isoformat()


def format_datetime(secs) -> str:
    if isinstance(secs, _dt.datetime):
        return secs.strftime("%Y-%m-%d %H:%M:%S")
    return (_dt.datetime(1970, 1, 1) +
            _dt.timedelta(seconds=int(secs))).strftime("%Y-%m-%d %H:%M:%S")
