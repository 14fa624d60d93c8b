"""Unit-normalised embeddings drawn from a seeded mixture of clusters, made
on the device in a few large calls.

A row is ``normalize(c_j + sigma * g / sqrt(dim))``: ``c_j`` one of
``clusters`` unit centres, ``j`` uniform, ``g`` standard normal.  A query
is a fresh draw from the same mixture (its own ``j`` and ``g``), so every
query differs from every row and from every other query.  Row ``i`` has
``id = i``.  Nothing here imports the program.
"""

from __future__ import annotations

import math

import torch

CHUNK_ROWS = 1 << 20


def stream_seed(seed: int, stream: int) -> int:
    """A generator seed for one of the run's independent streams."""
    return (int(seed) * 0x9E3779B1 + stream * 0x85EBCA77) % (1 << 63)


def _draw(gen, centres, n, sigma, out):
    d = centres.shape[1]
    for lo in range(0, n, CHUNK_ROWS):
        hi = min(n, lo + CHUNK_ROWS)
        j = torch.randint(0, centres.shape[0], (hi - lo,), generator=gen,
                          device=centres.device)
        v = torch.randn((hi - lo, d), generator=gen, device=centres.device)
        v.mul_(sigma / math.sqrt(d)).add_(centres[j])
        out[lo:hi] = v / torch.linalg.vector_norm(v, dim=1, keepdim=True)


def make(cfg: dict, seed: int, device, n_queries: int) -> dict:
    """The table's columns and ``n_queries`` query vectors (float32)."""
    (tname, _schema), = cfg["tables"].items()
    n, d = int(cfg["rows"]), int(cfg["dim"])
    a = cfg["assumed"]
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, 1))
    centres = torch.randn((int(a["clusters"]), d), generator=gen,
                          device=device)
    centres /= torch.linalg.vector_norm(centres, dim=1, keepdim=True)
    emb = torch.empty((n, d), dtype=torch.float32, device=device)
    _draw(gen, centres, n, float(a["sigma"]), emb)
    queries = torch.empty((n_queries, d), dtype=torch.float32, device=device)
    qgen = torch.Generator(device=device).manual_seed(stream_seed(seed, 2))
    _draw(qgen, centres, n_queries, float(a["sigma"]), queries)
    ids = torch.arange(n, dtype=torch.int64, device=device)
    return {"tables": {tname: {"id": ids, "emb": emb}}, "queries": queries}
