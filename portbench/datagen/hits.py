"""ClickBench's ``hits`` table in shape (ClickHouse/ClickBench,
``clickhouse/create.sql``), the columns the mixes read, made on the device
from the seed in one generator.  Only the columns the configuration's schema
names are made.  String columns are int32 codes into lists of distinct
values, drawn skewed to small codes, as many distinct values as the
configuration's ``distinct`` gives each.

The distributions (``assumed`` in the configuration file): UserID over
about ``users`` distinct values, skewed to small indexes and spread over
62 bits by an odd multiplier; EventTime uniform over July 2013; CounterID
62 in 30% of rows; RegionID skewed over ``regions`` values; AdvEngineID 0
in 97% of rows; SearchPhrase empty in 80% of rows.  With ``order_by`` the
rows are stored sorted by those columns, as a MergeTree table stores them
by its primary key.  Nothing here imports the program.
"""

from __future__ import annotations

import torch

from portbench.datagen.embeddings import stream_seed

JULY_2013 = 1_372_636_800        # 2013-07-01 00:00:00 UTC
HOSTS = ("www.google.com", "yandex.ru", "mail.ru", "google.ru", "vk.com",
         "news.example.org", "shop.example.com", "m.auto.ru",
         "forum.example.net", "www.avito.ru", "ok.ru", "docs.google.com",
         "images.example.com", "kinopoisk.ru", "video.example.tv",
         "wiki.example.org")
WORDS = ("weather", "news", "auto", "cheap", "flights", "moscow",
         "football", "recipes", "music", "download", "free", "online",
         "games", "maps", "train", "hotel")


def make(cfg: dict, seed: int, device, n_queries: int = 0) -> dict:
    (tname, schema), = cfg["tables"].items()
    n = int(cfg["rows"])
    a = cfg["assumed"]
    n_users, n_regions = int(a["users"]), int(a["regions"])
    names = {c[0] for c in schema}
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, 9))

    def u():
        # f64: with f32's 24 bits, u^2 * users would skip every other user
        # index near the top of the range
        return torch.rand(n, generator=gen, device=device,
                          dtype=torch.float64)

    def ints(lo, hi):
        return torch.randint(lo, hi, (n,), generator=gen, device=device)

    user_idx = (u() ** 2 * n_users).long()
    mix = user_idx * -0x61C8864680B583EB + 0x632BE59BD9B4E019
    user_id = (mix ^ (mix >> 29)) & ((1 << 62) - 1)
    del user_idx, mix
    event_time = JULY_2013 + ints(0, 31 * 86400)
    counter = torch.where(u() < 0.3, 62,
                          (u() ** 3 * 7000).long() + 1).to(torch.int32)
    region = (u() ** 2 * n_regions).to(torch.int32)
    adv = torch.where(u() < 0.97, 0, ints(1, 60)).to(torch.int16)
    width = ints(320, 2561).to(torch.int16)
    refresh = (u() < 0.1).to(torch.int16)
    dont_count = (u() < 0.05).to(torch.int16)
    cols = {"UserID": user_id, "EventTime": event_time,
            "EventDate": (event_time // 86400).to(torch.int32),
            "CounterID": counter, "RegionID": region, "AdvEngineID": adv,
            "ResolutionWidth": width, "IsRefresh": refresh,
            "DontCountHits": dont_count}
    if "URL" in names:
        m = int(cfg["distinct"]["URL"])
        codes = (u() ** 3 * m).to(torch.int32)
        cols["URL"] = (codes, [
            f"http://{HOSTS[i % len(HOSTS)]}/page/{i}?id={i * 7919 % 100003}"
            for i in range(m)])
    if "SearchPhrase" in names:
        m = int(cfg["distinct"]["SearchPhrase"])
        codes = torch.where(u() < 0.8, 0, (u() ** 2 * (m - 1)).long() + 1) \
            .to(torch.int32)
        cols["SearchPhrase"] = (codes, [""] + [
            f"{WORDS[i % 16]} {WORDS[i // 16 % 16]} {i}"
            for i in range(1, m)])
    cols = {k: v for k, v in cols.items() if k in names}
    order = cfg.get("order_by", [])
    if order:
        # MergeTree stores a part's rows sorted by its primary key: stable
        # sorts from the last key column to the first
        perm = torch.arange(n, device=device)
        for key in reversed(order):
            perm = perm[torch.sort(cols[key][perm], stable=True).indices]
        cols = {k: (v[0][perm], v[1]) if isinstance(v, tuple) else v[perm]
                for k, v in cols.items()}
    return {"tables": {tname: cols}, "queries": None}
