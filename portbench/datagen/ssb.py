"""The Star Schema Benchmark's five tables (P. O'Neil, E. O'Neil, X. Chen,
*Star Schema Benchmark*, Revision 3, 2009), made from the seed by dbgen's
rules, reimplemented: lineorder on the device, the four dimensions with
their keys and codes on the device and their String values on the host.

- ``rows`` is lineorder's target: ``rows / 4`` orders of 1-7 lines each
  (uniform), so about ``rows`` lines; the dimensions scale with it from
  their SF 100 sizes in ``table_rows`` (``dwdate`` is always the spec's
  2,556 days from 1992-01-01).
- An order's date is uniform over 1992-01-01 .. 1998-08-02, its customer
  uniform over the customers whose key is not a multiple of 3, its
  priority uniform over five; a line's commit date is 30-90 days after
  its order's, its part uniform, its supplier one of the part's four
  (TPC-H's PARTSUPP rule), quantity 1-50, discount 0-10, tax 0-8.
- Prices in cents: a part's retail price is TPC-H's
  ``90000 + (partkey / 10) mod 20001 + 100 (partkey mod 1000)``;
  ``lo_extendedprice = quantity * retail``, ``lo_revenue =
  extendedprice (100 - discount) / 100``, ``lo_supplycost = 6 retail /
  10``, ``lo_ordtotalprice`` the order's sum of ``extendedprice (100 -
  discount) (100 + tax) / 10000`` (integer divisions).
- Cities are the nation's first 9 characters (blank-padded) and a digit;
  parts are ``MFGR#m``, categories ``MFGR#mc``, brands ``MFGR#mcb`` with
  b in 1..40; names and addresses are unique per key (addresses 11-25
  base-62 characters, phones a bijection of the key), formatted by numpy
  over byte arrays rather than one Python string at a time.

A String column is ``(codes, values)``: int32 codes on the device into a
list of distinct values.  Nothing here imports the program.
"""

from __future__ import annotations

import datetime as dt

import numpy as np
import torch

from portbench.datagen.embeddings import stream_seed

SF100_ROWS = 600_000_000
FIRST_DAY = dt.date(1992, 1, 1)
LAST_ORDER_DAY = dt.date(1998, 8, 2)
DATE_ROWS = 2556
CHUNK = 1 << 26

NATIONS = (
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1))
REGIONS = ("AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST")
CITIES = [f"{n[:9]:<9}{d}" for n, _r in NATIONS for d in range(10)]
SEGMENTS = ("AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD")
PRIORITIES = ("1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW")
SHIPMODES = ("REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB")
COLORS = (
    "almond antique aquamarine azure beige bisque black blanched blue blush "
    "brown burlywood burnished chartreuse chiffon chocolate coral "
    "cornflower cornsilk cream cyan dark deep dim dodger drab firebrick "
    "floral forest frosted gainsboro ghost goldenrod green grey honeydew "
    "hot indian ivory khaki lace lavender lawn lemon light lime linen "
    "magenta maroon medium metallic midnight mint misty moccasin navajo "
    "navy olive orange orchid pale papaya peach peru pink plum powder puff "
    "purple red rose rosy royal saddle salmon sandy seashell sienna sky "
    "slate smoke snow spring steel tan thistle tomato turquoise violet "
    "wheat white yellow").split()
TYPES = [f"{a} {b} {c}"
         for a in ("STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO")
         for b in ("ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED")
         for c in ("TIN", "NICKEL", "BRASS", "STEEL", "COPPER")]
CONTAINERS = [f"{a} {b}" for a in ("SM", "LG", "MED", "JUMBO", "WRAP")
              for b in ("CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN",
                        "DRUM")]
BRANDS = [f"MFGR#{m}{c}{b}" for m in range(1, 6) for c in range(1, 6)
          for b in range(1, 41)]
CATEGORIES = [f"MFGR#{m}{c}" for m in range(1, 6) for c in range(1, 6)]
MFGRS = [f"MFGR#{m}" for m in range(1, 6)]
HOLIDAYS = {(1, 1), (2, 14), (5, 31), (7, 4), (9, 6), (10, 31), (11, 11),
            (11, 25), (12, 24), (12, 25), (12, 31)}
SEASONS = {12: "Christmas", 1: "Winter", 2: "Winter", 3: "Spring",
           4: "Spring", 5: "Spring", 6: "Summer", 7: "Summer", 8: "Summer",
           9: "Fall", 10: "Fall", 11: "Fall"}
B62 = np.frombuffer(b"0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ"
                    b"abcdefghijklmnopqrstuvwxyz", dtype=np.uint8)


def sizes(cfg: dict) -> dict:
    """Rows of each table at the configuration's ``rows`` (lineorder's
    target): the dimensions' SF 100 sizes scaled, with floors that keep
    every nation, city and brand present."""
    scale = int(cfg["rows"]) / SF100_ROWS
    full = cfg["table_rows"]
    floors = {"customer": 250, "supplier": 250, "part": 1000}
    out = {t: max(floors[t], round(int(full[t]) * scale)) for t in floors}
    out["orders"] = max(1, int(cfg["rows"]) // 4)
    return out


def _strings(chars: np.ndarray) -> list:
    """Rows of a (n, w) uint8 array of ASCII, NUL-padded at the end, as
    Python strings."""
    n, w = chars.shape
    return np.ascontiguousarray(chars).view(f"S{w}").reshape(n) \
        .astype(f"U{w}").tolist()


def _digits(x: np.ndarray, width: int) -> np.ndarray:
    """(n, width) ASCII digits of non-negative x, zero-padded."""
    p = 10 ** np.arange(width - 1, -1, -1, dtype=np.int64)
    return (x[:, None] // p % 10 + 48).astype(np.uint8)


def _mix(x: np.ndarray, salt: int) -> np.ndarray:
    """A bijection of uint64 (splitmix64's finaliser)."""
    with np.errstate(over="ignore"):
        z = x.astype(np.uint64) + np.uint64(salt)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


def names(prefix: str, keys: np.ndarray) -> list:
    """``<prefix>#<key, 9 digits>``: TPC-H's names."""
    head = np.frombuffer(f"{prefix}#".encode(), dtype=np.uint8)
    return _strings(np.hstack([np.broadcast_to(head, (len(keys), len(head))),
                               _digits(keys, 9)]))


def addresses(keys: np.ndarray, salt: int) -> list:
    """11 base-62 characters of a bijection of the key (so unique), then
    0-14 more of a second hash: 11-25 characters."""
    h = _mix(keys, salt)
    p = np.uint64(62) ** np.arange(11, dtype=np.uint64)
    head = B62[(h[:, None] // p % np.uint64(62)).astype(np.int64)]
    g = _mix(keys, salt + 1)
    tail = B62[(g[:, None] >> np.arange(0, 56, 4, dtype=np.uint64)
                & np.uint64(61)).astype(np.int64)]
    extra = (g >> np.uint64(58)) % np.uint64(15)
    tail[np.arange(14)[None, :] >= extra.astype(np.int64)[:, None]] = 0
    return _strings(np.hstack([head, tail]))


def phones(keys: np.ndarray, nation: np.ndarray) -> list:
    """``CC-NNN-NNN-NNNN``: CC = nation + 10, the ten digits a bijection of
    the key modulo 10^10 (unique per key)."""
    x = keys.astype(np.int64) * 3_141_592_653 % 10 ** 10
    d = _digits(x, 10)
    dash = np.full((len(keys), 1), ord("-"), dtype=np.uint8)
    return _strings(np.hstack([_digits(nation.astype(np.int64) + 10, 2),
                               dash, d[:, :3], dash, d[:, 3:6], dash,
                               d[:, 6:]]))


def _lut(values, device):
    return torch.tensor(values, dtype=torch.int32, device=device)


def date_table(device) -> tuple:
    """(dwdate's columns, yyyymmdd of day i from 1992-01-01 for the
    order and commit dates)."""
    days = [FIRST_DAY + dt.timedelta(days=i) for i in range(DATE_ROWS)]
    key = [d.year * 10000 + d.month * 100 + d.day for d in days]

    def col(values, dtype):
        return torch.tensor(values, dtype=dtype, device=device)

    def text(values):
        distinct = sorted(set(values))
        at = {v: i for i, v in enumerate(distinct)}
        return (col([at[v] for v in values], torch.int32), distinct)
    dow = [(d.isoweekday() % 7) + 1 for d in days]       # Sunday = 1
    last_in_month = [(d + dt.timedelta(days=1)).month != d.month
                     for d in days]
    cols = {
        "d_datekey": col(key, torch.int32),
        "d_date": text([f"{d:%B} {d.day}, {d.year}" for d in days]),
        "d_dayofweek": text([f"{d:%A}" for d in days]),
        "d_month": text([f"{d:%B}" for d in days]),
        "d_year": col([d.year for d in days], torch.int32),
        "d_yearmonthnum": col([d.year * 100 + d.month for d in days],
                              torch.int32),
        "d_yearmonth": text([f"{d:%b}{d.year}" for d in days]),
        "d_daynuminweek": col(dow, torch.uint8),
        "d_daynuminmonth": col([d.day for d in days], torch.uint8),
        "d_daynuminyear": col([d.timetuple().tm_yday for d in days],
                              torch.int32),
        "d_monthnuminyear": col([d.month for d in days], torch.uint8),
        "d_weeknuminyear": col([(d.timetuple().tm_yday - 1) // 7 + 1
                                for d in days], torch.uint8),
        "d_sellingseason": text([SEASONS[d.month] for d in days]),
        "d_lastdayinweekfl": col([w == 7 for w in dow], torch.uint8),
        "d_lastdayinmonthfl": col(last_in_month, torch.uint8),
        "d_holidayfl": col([(d.month, d.day) in HOLIDAYS for d in days],
                           torch.uint8),
        "d_weekdayfl": col([2 <= w <= 6 for w in dow], torch.uint8)}
    span = (dt.date(1998, 10, 31) - FIRST_DAY).days + 1
    ymd = [(FIRST_DAY + dt.timedelta(days=i)) for i in range(span)]
    return cols, _lut([d.year * 10000 + d.month * 100 + d.day for d in ymd],
                      device)


def customer(n: int, gen, device) -> dict:
    keys = np.arange(1, n + 1, dtype=np.int64)
    nation = torch.randint(0, 25, (n,), generator=gen, device=device)
    city = nation * 10 + torch.randint(0, 10, (n,), generator=gen,
                                       device=device)
    region = _lut([r for _n, r in NATIONS], device)[nation]
    nat_np = nation.cpu().numpy()
    ids = torch.arange(n, dtype=torch.int32, device=device)
    return {
        "c_custkey": torch.arange(1, n + 1, dtype=torch.int32, device=device),
        "c_name": (ids, names("Customer", keys)),
        "c_address": (ids.clone(), addresses(keys, 0xC0)),
        "c_city": (city.to(torch.int32), CITIES),
        "c_nation": (nation.to(torch.int32), [m for m, _r in NATIONS]),
        "c_region": (region, list(REGIONS)),
        "c_phone": (ids.clone(), phones(keys, nat_np)),
        "c_mktsegment": (torch.randint(0, 5, (n,), generator=gen,
                                       device=device).to(torch.int32),
                         list(SEGMENTS))}


def supplier(n: int, gen, device) -> dict:
    keys = np.arange(1, n + 1, dtype=np.int64)
    nation = torch.randint(0, 25, (n,), generator=gen, device=device)
    city = nation * 10 + torch.randint(0, 10, (n,), generator=gen,
                                       device=device)
    region = _lut([r for _n, r in NATIONS], device)[nation]
    ids = torch.arange(n, dtype=torch.int32, device=device)
    return {
        "s_suppkey": torch.arange(1, n + 1, dtype=torch.int32, device=device),
        "s_name": (ids, names("Supplier", keys)),
        "s_address": (ids.clone(), addresses(keys, 0x50)),
        "s_city": (city.to(torch.int32), CITIES),
        "s_nation": (nation.to(torch.int32), [m for m, _r in NATIONS]),
        "s_region": (region, list(REGIONS)),
        "s_phone": (ids.clone(), phones(keys, nation.cpu().numpy()))}


def part(n: int, gen, device) -> dict:
    def draw(k):
        return torch.randint(0, k, (n,), generator=gen, device=device)
    m, c, b = draw(5), draw(5), draw(40)
    c1, c2 = draw(len(COLORS)), draw(len(COLORS))
    return {
        "p_partkey": torch.arange(1, n + 1, dtype=torch.int32, device=device),
        "p_name": ((c1 * len(COLORS) + c2).to(torch.int32),
                   [f"{x} {y}" for x in COLORS for y in COLORS]),
        "p_mfgr": (m.to(torch.int32), MFGRS),
        "p_category": ((m * 5 + c).to(torch.int32), CATEGORIES),
        "p_brand1": (((m * 5 + c) * 40 + b).to(torch.int32), BRANDS),
        "p_color": (c1.to(torch.int32), list(COLORS)),
        "p_type": (draw(len(TYPES)).to(torch.int32), TYPES),
        "p_size": (draw(50) + 1).to(torch.uint8),
        "p_container": (draw(len(CONTAINERS)).to(torch.int32), CONTAINERS)}


def retail_cents(partkey: torch.Tensor) -> torch.Tensor:
    """TPC-H's P_RETAILPRICE in cents (int32)."""
    pk = partkey.to(torch.int32)
    return 90000 + (pk // 10) % 20001 + 100 * (pk % 1000)


def lineorder(sz: dict, gen, ymd: torch.Tensor, device) -> dict:
    n_orders, n_part = sz["orders"], sz["part"]
    n_supp, n_cust = sz["supplier"], sz["customer"]
    i32 = torch.int32

    def draw(lo, hi, n):
        return torch.randint(lo, hi, (n,), generator=gen, device=device)
    # orders: lines, key (TPC-H's sparse keys), date, customer, priority
    lines = draw(1, 8, n_orders)
    n = int(lines.sum())
    first = torch.cumsum(lines, 0) - lines
    o = torch.arange(n_orders, device=device)
    o_key = ((o >> 3 << 5) | (o & 7)).add_(1).to(i32)
    o_day = draw(0, (LAST_ORDER_DAY - FIRST_DAY).days + 1, n_orders) \
        .to(torch.int16)
    r = draw(0, n_cust - n_cust // 3, n_orders)
    o_cust = (3 * (r // 2) + r % 2 + 1).to(i32)         # key % 3 != 0
    o_prio = draw(0, 5, n_orders).to(i32)
    del o, r
    order_of = torch.repeat_interleave(
        torch.arange(n_orders, dtype=i32, device=device), lines,
        output_size=n)
    first32 = first.to(i32)
    del lines, first
    cols = {name: torch.empty(n, dtype=dtype, device=device) for name, dtype
            in (("lo_orderkey", i32), ("lo_linenumber", torch.uint8),
                ("lo_custkey", i32), ("lo_partkey", i32),
                ("lo_suppkey", i32), ("lo_orderdate", i32),
                ("lo_orderpriority", i32), ("lo_shippriority", torch.uint8),
                ("lo_quantity", torch.uint8), ("lo_extendedprice", i32),
                ("lo_ordtotalprice", i32), ("lo_discount", torch.uint8),
                ("lo_revenue", i32), ("lo_supplycost", i32),
                ("lo_tax", torch.uint8), ("lo_commitdate", i32),
                ("lo_shipmode", i32))}
    cols["lo_shippriority"].zero_()
    o_total = torch.zeros(n_orders, dtype=torch.int64, device=device)
    for lo in range(0, n, CHUNK):
        hi = min(n, lo + CHUNK)
        m = hi - lo
        oi = order_of[lo:hi].long()
        cols["lo_orderkey"][lo:hi] = o_key[oi]
        cols["lo_linenumber"][lo:hi] = (
            torch.arange(lo, hi, dtype=i32, device=device)
            - first32[oi] + 1)
        cols["lo_custkey"][lo:hi] = o_cust[oi]
        day = o_day[oi].long()
        cols["lo_orderdate"][lo:hi] = ymd[day]
        cols["lo_commitdate"][lo:hi] = ymd[day + draw(30, 91, m)]
        cols["lo_orderpriority"][lo:hi] = o_prio[oi]
        pk = draw(1, n_part + 1, m)
        cols["lo_partkey"][lo:hi] = pk
        i = draw(0, 4, m)
        cols["lo_suppkey"][lo:hi] = (
            pk + i * (n_supp // 4 + (pk - 1) // n_supp)) % n_supp + 1
        qty = draw(1, 51, m)
        disc = draw(0, 11, m)
        tax = draw(0, 9, m)
        retail = retail_cents(pk).long()
        ext = qty * retail
        cols["lo_quantity"][lo:hi] = qty
        cols["lo_discount"][lo:hi] = disc
        cols["lo_tax"][lo:hi] = tax
        cols["lo_extendedprice"][lo:hi] = ext
        cols["lo_revenue"][lo:hi] = ext * (100 - disc) // 100
        cols["lo_supplycost"][lo:hi] = 6 * retail // 10
        o_total.index_add_(0, oi, ext * (100 - disc) * (100 + tax) // 10000)
        cols["lo_shipmode"][lo:hi] = draw(0, len(SHIPMODES), m)
        del oi, day, pk, i, qty, disc, tax, retail, ext
    for lo in range(0, n, CHUNK):
        hi = min(n, lo + CHUNK)
        cols["lo_ordtotalprice"][lo:hi] = o_total[order_of[lo:hi].long()]
    del order_of, o_total
    cols["lo_orderpriority"] = (cols["lo_orderpriority"], list(PRIORITIES))
    cols["lo_shipmode"] = (cols["lo_shipmode"], list(SHIPMODES))
    return cols


def make(cfg: dict, seed: int, device, n_queries: int = 0) -> dict:
    sz = sizes(cfg)

    def gen(stream):
        return torch.Generator(device=device).manual_seed(
            stream_seed(seed, stream))
    dates, ymd = date_table(device)
    tables = {"dwdate": dates,
              "customer": customer(sz["customer"], gen(21), device),
              "supplier": supplier(sz["supplier"], gen(22), device),
              "part": part(sz["part"], gen(23), device),
              "lineorder": lineorder(sz, gen(24), ymd, device)}
    return {"tables": tables, "queries": None}
