"""Plain reference of the ClickBench statements over the hits table.

It reads the generated columns the program was handed (the String columns
as their codes and the list of distinct values) and nothing the program
derived: distinct counts by ``torch.unique``, groups by ``bincount``, the
LIKE pattern matched in Python over the values and looked up by code,
minute buckets by integer division.  Each statement's expected rows are
computed once and every returned copy of it is compared.

Where a statement orders by a key that may tie and cuts the rows (``ORDER
BY u DESC LIMIT 10``) or orders only by a count, any order of tied rows is
right: the rows are then checked as a set, each with its true value, in
non-increasing order, and with the multiset of values the exact answer
has.

``control_rows`` breaks the configuration's guarantee of exact results
the way a lower precision would: it keys UserID by its float32 rounding,
so distinct users that share a float32 value count once.  Nothing here
imports the program.
"""

from __future__ import annotations

import datetime as dt

import torch

EPOCH = dt.date(1970, 1, 1)
BASE = dt.datetime(1970, 1, 1)


def _cols(data):
    (cols,) = data["tables"].values()
    return cols


def _distinct_users(uid):
    return int(torch.unique(uid).numel())


def _region_users(region, uid):
    _, inv = torch.unique(uid, return_inverse=True)
    nu = int(inv.max()) + 1
    pairs = torch.unique(region.long() * nu + inv)
    per = torch.bincount(pairs // nu)
    return {int(r): int(per[r]) for r in torch.nonzero(per).flatten()}


def expected(name: str, c: dict, user_key=None):
    """The exact answer of statement ``name``: a list of rows, or for the
    tie-tolerant statements a dict of every group's value."""
    uid = c["UserID"] if user_key is None else user_key
    ed, et = c["EventDate"], c["EventTime"]
    if name == "distinct_users":
        return [(_distinct_users(uid),)]
    if name == "distinct_phrases":
        return [(int(torch.unique(c["SearchPhrase"][0]).numel()),)]
    if name == "date_range":
        return [(EPOCH + dt.timedelta(days=int(ed.min())),
                 EPOCH + dt.timedelta(days=int(ed.max())))]
    if name == "adv_engines":
        cnt = torch.bincount(c["AdvEngineID"].long())
        return {a: int(cnt[a]) for a in torch.nonzero(cnt).flatten().tolist()
                if a != 0}
    if name == "region_users":
        return _region_users(c["RegionID"], uid)
    if name == "url_like":
        codes, values = c["URL"]
        lut = torch.tensor(["google" in v for v in values],
                           device=codes.device)
        return [(int(lut[codes.long()].sum()),)]
    if name == "minute_views":
        d14 = (dt.date(2013, 7, 14) - EPOCH).days
        keep = ((c["CounterID"] == 62) & (ed >= d14) & (ed <= d14 + 1)
                & (c["IsRefresh"] == 0) & (c["DontCountHits"] == 0))
        minutes, views = torch.unique(et[keep] // 60 * 60,
                                      return_counts=True)
        return [(BASE + dt.timedelta(seconds=int(m)), int(v))
                for m, v in zip(minutes[1000:1010].tolist(),
                                views[1000:1010].tolist())]
    raise KeyError(f"no reference for statement {name!r}")


LIMITS = {"region_users": 10, "adv_engines": None}


def matches(name: str, rows, want) -> bool:
    if not isinstance(want, dict):
        return rows == want
    limit = LIMITS[name]
    values = sorted(want.values(), reverse=True)
    n = len(values) if limit is None else min(limit, len(values))
    keys = [r[0] for r in rows]
    got = [r[1] for r in rows]
    return (len(rows) == n and len(set(keys)) == n
            and all(want.get(k) == v for k, v in rows)
            and got == sorted(got, reverse=True) and got == values[:n])


def _answers(data, names, user_key=None):
    c = _cols(data)
    return {name: expected(name, c, user_key) for name in sorted(set(names))}


def judge(cfg: dict, data: dict, items: list) -> dict:
    """``items``: (params, rows) of every statement that came back, each
    params with the statement's ``name``."""
    want = _answers(data, [p["name"] for p, _ in items])
    wrong = sum(not matches(p["name"], rows, want[p["name"]])
                for p, rows in items)
    return {"numbers": {"wrong_statements": wrong}, "wrong": wrong}


def control_rows(cfg: dict, data: dict, items: list) -> list:
    """Each statement's rows with UserID keyed by its float32 rounding."""
    key = _cols(data)["UserID"].float()
    got = _answers(data, [p["name"] for p, _ in items], user_key=key)
    out = []
    for p, _ in items:
        w = got[p["name"]]
        if isinstance(w, dict):
            top = sorted(w.items(), key=lambda kv: (-kv[1], kv[0]))
            w = top[:LIMITS[p["name"]] or len(top)]
        out.append(w)
    return out
