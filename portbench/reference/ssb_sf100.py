"""Plain reference of the Star Schema Benchmark's 13 statements (Q1.1 to
Q4.3) over the generated tables.

It reads the generated columns the program was handed (String columns as
their codes and the list of distinct values) and nothing the program
derived.  Each dimension's predicate is evaluated on the dimension table;
lineorder's foreign keys are looked up by ``torch.searchsorted`` in the
dimension's sorted keys, in row blocks, and the sums are exact int64
``index_add_``s over the groups the blocks find.  Each statement's answer
is computed once, and every returned copy of it is compared.

The guarantee: exact sums and groups, in the spec's ORDER BY; where the
order is by the sum (Q3.x: ``d_year ASC, revenue DESC``) rows that tie
may come in any order, so those rows are compared as a multiset whose
order is non-decreasing in the sort keys.

``control_rows`` breaks the guarantee the way a lower precision would:
``lo_revenue`` is summed in float32.  Nothing here imports the program.
"""

from __future__ import annotations

import torch

BLOCK = 1 << 26
AMERICA, ASIA, EUROPE = "AMERICA", "ASIA", "EUROPE"


def _eq(col, value):
    return ("eq", col, value)


# statement name -> (dimension predicates, lineorder predicate, group-by
# columns (dimension attributes), summed value, select order, order key)
def _q1(dpred, lpred):
    return {"dims": {"dwdate": dpred}, "lo": lpred, "group": [],
            "value": "ext_disc", "select": ["sum"], "order": None}


def _q2(ppred, region):
    return {"dims": {"dwdate": [], "part": ppred,
                     "supplier": [_eq("s_region", region)]},
            "lo": [], "group": ["d_year", "p_brand1"], "value": "revenue",
            "select": ["sum", "d_year", "p_brand1"],
            "order": ["d_year", "p_brand1"]}


def _q3(attr, cpred, spred, dpred):
    return {"dims": {"customer": cpred, "supplier": spred, "dwdate": dpred},
            "lo": [], "group": [f"c_{attr}", f"s_{attr}", "d_year"],
            "value": "revenue",
            "select": [f"c_{attr}", f"s_{attr}", "d_year", "sum"],
            "order": ["d_year", "-sum"]}


YEARS_92_97 = [("between", "d_year", 1992, 1997)]
UK_CITIES = ("UNITED KI1", "UNITED KI5")
MFGR12 = [("in", "p_mfgr", ("MFGR#1", "MFGR#2"))]
Y97_98 = [("in", "d_year", (1997, 1998))]

STATEMENTS = {
    "q1_1": _q1([_eq("d_year", 1993)],
                [("between", "lo_discount", 1, 3), ("lt", "lo_quantity", 25)]),
    "q1_2": _q1([_eq("d_yearmonthnum", 199401)],
                [("between", "lo_discount", 4, 6),
                 ("between", "lo_quantity", 26, 35)]),
    "q1_3": _q1([_eq("d_weeknuminyear", 6), _eq("d_year", 1994)],
                [("between", "lo_discount", 5, 7),
                 ("between", "lo_quantity", 26, 35)]),
    "q2_1": _q2([_eq("p_category", "MFGR#12")], AMERICA),
    "q2_2": _q2([("between", "p_brand1", "MFGR#2221", "MFGR#2228")], ASIA),
    "q2_3": _q2([_eq("p_brand1", "MFGR#2239")], EUROPE),
    "q3_1": _q3("nation", [_eq("c_region", ASIA)], [_eq("s_region", ASIA)],
                YEARS_92_97),
    "q3_2": _q3("city", [_eq("c_nation", "UNITED STATES")],
                [_eq("s_nation", "UNITED STATES")], YEARS_92_97),
    "q3_3": _q3("city", [("in", "c_city", UK_CITIES)],
                [("in", "s_city", UK_CITIES)], YEARS_92_97),
    "q3_4": _q3("city", [("in", "c_city", UK_CITIES)],
                [("in", "s_city", UK_CITIES)],
                [_eq("d_yearmonth", "Dec1997")]),
    "q4_1": {"dims": {"dwdate": [], "customer": [_eq("c_region", AMERICA)],
                      "supplier": [_eq("s_region", AMERICA)],
                      "part": MFGR12},
             "lo": [], "group": ["d_year", "c_nation"], "value": "profit",
             "select": ["d_year", "c_nation", "sum"],
             "order": ["d_year", "c_nation"]},
    "q4_2": {"dims": {"dwdate": Y97_98,
                      "customer": [_eq("c_region", AMERICA)],
                      "supplier": [_eq("s_region", AMERICA)],
                      "part": MFGR12},
             "lo": [], "group": ["d_year", "s_nation", "p_category"],
             "value": "profit",
             "select": ["d_year", "s_nation", "p_category", "sum"],
             "order": ["d_year", "s_nation", "p_category"]},
    "q4_3": {"dims": {"dwdate": Y97_98,
                      "customer": [_eq("c_region", AMERICA)],
                      "supplier": [_eq("s_nation", "UNITED STATES")],
                      "part": [_eq("p_category", "MFGR#14")]},
             "lo": [], "group": ["d_year", "s_city", "p_brand1"],
             "value": "profit",
             "select": ["d_year", "s_city", "p_brand1", "sum"],
             "order": ["d_year", "s_city", "p_brand1"]},
}

# dimension -> (its key, lineorder's foreign key)
KEYS = {"dwdate": ("d_datekey", "lo_orderdate"),
        "customer": ("c_custkey", "lo_custkey"),
        "supplier": ("s_suppkey", "lo_suppkey"),
        "part": ("p_partkey", "lo_partkey")}
TABLE_OF = {"d": "dwdate", "c": "customer", "s": "supplier", "p": "part",
            "lo": "lineorder"}


def _table(col: str) -> str:
    return TABLE_OF[col.split("_", 1)[0]]


def _holds(data, term) -> torch.Tensor:
    """A predicate over a table's rows: strings by their values, through
    the codes."""
    op, col, *args = term
    v = data[_table(col)][col]
    if isinstance(v, tuple):
        codes, values = v
        test = {"eq": lambda s: s == args[0],
                "in": lambda s: s in args[0],
                "between": lambda s: args[0] <= s <= args[1]}[op]
        lut = torch.tensor([test(s) for s in values], dtype=torch.bool,
                           device=codes.device)
        return lut[codes.long()]
    x = v.long()
    if op == "eq":
        return x == args[0]
    if op == "lt":
        return x < args[0]
    if op == "in":
        return (x == args[0][0]) | (x == args[0][1])
    return (x >= args[0]) & (x <= args[1])


def _value(kind: str, lo: dict, a: int, b: int, float32: bool):
    if kind == "ext_disc":
        return lo["lo_extendedprice"][a:b].long() \
            * lo["lo_discount"][a:b].long()
    rev = lo["lo_revenue"][a:b]
    if float32:
        rev = rev.float()
    else:
        rev = rev.long()
    if kind == "profit":
        return rev - lo["lo_supplycost"][a:b].to(rev.dtype)
    return rev


def _attr(data, col, rows):
    """(codes or ints of a dimension attribute at ``rows``, a decoder)."""
    v = data[_table(col)][col]
    if isinstance(v, tuple):
        codes, values = v
        return codes[rows].long(), lambda i: values[i]
    return v[rows].long(), int


def answer(data: dict, name: str, float32: bool = False) -> list:
    """Statement ``name``'s rows, in its ORDER BY (ties by the group
    key)."""
    q = STATEMENTS[name]
    tables = data["tables"]
    lo = tables["lineorder"]
    n = lo["lo_orderkey"].shape[0]
    dims = {}
    for t, preds in q["dims"].items():
        key_col, fk = KEYS[t]
        keys, order = torch.sort(tables[t][key_col].long())
        keep = torch.ones(keys.shape[0], dtype=torch.bool,
                          device=keys.device)
        for term in preds:
            keep &= _holds(tables, term)
        dims[t] = (keys, order, keep, fk)
    sums, decoders = {}, None
    dev = lo["lo_orderkey"].device
    for a in range(0, n, BLOCK):
        b = min(n, a + BLOCK)
        mask = torch.ones(b - a, dtype=torch.bool, device=dev)
        for term in q["lo"]:
            col = term[1]
            mask &= _holds({"lineorder": {col: lo[col][a:b]}}, term)
        rows_of = {}
        for t, (keys, order, keep, fk) in dims.items():
            k = lo[fk][a:b].long()
            pos = torch.searchsorted(keys, k).clamp_(max=keys.shape[0] - 1)
            row = order[pos]
            mask &= (keys[pos] == k) & keep[row]
            rows_of[t] = row
        val = _value(q["value"], lo, a, b, float32)[mask]
        cols, decoders = [], []
        for col in q["group"]:
            c, dec = _attr(tables, col, rows_of[_table(col)][mask])
            cols.append(c)
            decoders.append(dec)
        if not cols:
            sums[()] = sums.get((), 0) + (float(val.double().sum())
                                          if float32 else int(val.sum()))
            continue
        if val.numel() == 0:
            continue
        uniq, inv = torch.unique(torch.stack(cols, 1), dim=0,
                                 return_inverse=True)
        acc = torch.zeros(uniq.shape[0], dtype=val.dtype, device=val.device)
        acc.index_add_(0, inv, val)
        for key, s in zip(map(tuple, uniq.tolist()), acc.tolist()):
            sums[key] = sums.get(key, 0) + s
    if not q["group"]:
        return [(sums.get((), 0),)]
    groups = []
    for key, s in sums.items():
        named = {col: dec(k) for col, dec, k in zip(q["group"], decoders,
                                                     key)}
        named["sum"] = s
        groups.append(named)
    groups.sort(key=lambda g: tuple(g[c] for c in q["group"]))
    groups.sort(key=lambda g: _order_key(q, g))
    return [tuple(g[c] for c in q["select"]) for g in groups]


def _order_key(q, g):
    return tuple(-g[c[1:]] if c.startswith("-") else g[c]
                 for c in q["order"])


def matches(name: str, rows, want) -> bool:
    q = STATEMENTS[name]
    rows = [tuple(r) for r in rows]
    if not q["order"] or not any(c.startswith("-") for c in q["order"]):
        return rows == want
    # ties in the sum may come in any order
    if sorted(rows, key=repr) != sorted(want, key=repr):
        return False
    keys = [_order_key(q, dict(zip(q["select"], r))) for r in rows]
    return keys == sorted(keys)


def judge(cfg: dict, data: dict, items: list) -> dict:
    """``items``: (params, rows) of every statement that came back, each
    params with the statement's ``name``."""
    want = {name: answer(data, name)
            for name in sorted({p["name"] for p, _ in items})}
    wrong = sum(not matches(p["name"], rows, want[p["name"]])
                for p, rows in items)
    return {"numbers": {"wrong_statements": wrong}, "wrong": wrong}


def control_rows(cfg: dict, data: dict, items: list) -> list:
    """Each statement's rows with ``lo_revenue`` summed in float32."""
    got = {name: answer(data, name, float32=True)
           for name in sorted({p["name"] for p, _ in items})}
    return [got[p["name"]] for p, _ in items]
