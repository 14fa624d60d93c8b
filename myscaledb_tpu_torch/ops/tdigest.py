"""Copy of myscaledb_tpu/ops/tdigest.py (numpy on the host, as there).

t-digest quantile sketch: fixed-size, mergeable (reference:
src/AggregateFunctions/QuantileTDigest.h — the centroid-merging digest of
Dunning's t-digest, used by quantileTDigest / quantileTiming-class
functions for distributed and streaming quantiles).

Construction here is the sorted-input form of the merging digest: sort the
values (the engine's native primitive), take each element's mid-quantile
q = (rank + w/2) / W, and assign it to centroid bucket
floor(delta * k(q)) with the k1 scale function
k(q) = asin(2q - 1)/pi + 1/2 — tails get fine buckets, the middle coarse,
the classic t-digest accuracy profile.  Merging concatenates centroid
lists, re-sorts by mean and re-compresses with weights; sizes stay
O(delta) regardless of input count, so shard states merge without
re-gathering rows (IAggregateFunction mergeable-state contract).

Quantile extraction mirrors QuantileTDigest::getResult: linear
interpolation between adjacent centroid mid-positions, clamped at the
extreme centroids.
"""

from __future__ import annotations

import numpy as np

DELTA = 100        # compression: max centroids (matches the sketch class)


def _compress(means: np.ndarray, counts: np.ndarray,
              delta: int = DELTA) -> tuple[np.ndarray, np.ndarray]:
    """Weighted values sorted by mean -> <= delta centroids."""
    order = np.argsort(means, kind="stable")
    m = np.asarray(means, dtype=np.float64)[order]
    w = np.asarray(counts, dtype=np.float64)[order]
    total = w.sum()
    if total <= 0:
        return np.zeros(0), np.zeros(0)
    mid = np.cumsum(w) - w / 2
    q = mid / total
    k = np.floor(delta * (np.arcsin(2 * q - 1) / np.pi + 0.5))
    k = np.clip(k, 0, delta - 1).astype(np.int64)
    sums = np.bincount(k, weights=m * w, minlength=delta)
    ws = np.bincount(k, weights=w, minlength=delta)
    nz = ws > 0
    return sums[nz] / ws[nz], ws[nz]


def build_digest(values: np.ndarray,
                 delta: int = DELTA) -> tuple[np.ndarray, np.ndarray]:
    """(means, counts) centroid arrays for raw values."""
    v = np.asarray(values, dtype=np.float64)
    v = v[np.isfinite(v)]
    if v.size == 0:
        return np.zeros(0), np.zeros(0)
    return _compress(v, np.ones_like(v), delta)


def merge_digests(digests, delta: int = DELTA):
    """Merge [(means, counts), ...] -> one digest."""
    ms = [np.asarray(d[0], dtype=np.float64) for d in digests]
    ws = [np.asarray(d[1], dtype=np.float64) for d in digests]
    if not ms:
        return np.zeros(0), np.zeros(0)
    return _compress(np.concatenate(ms), np.concatenate(ws), delta)


def digest_quantile(means: np.ndarray, counts: np.ndarray,
                    level: float) -> float:
    """QuantileTDigest::getResult-style interpolation."""
    m = np.asarray(means, dtype=np.float64)
    w = np.asarray(counts, dtype=np.float64)
    if m.size == 0:
        return float("nan")
    if m.size == 1:
        return float(m[0])
    total = w.sum()
    x = level * total
    mid = np.cumsum(w) - w / 2
    if x <= mid[0]:
        return float(m[0])
    if x >= mid[-1]:
        return float(m[-1])
    i = np.searchsorted(mid, x) - 1
    frac = (x - mid[i]) / (mid[i + 1] - mid[i])
    return float(m[i] + frac * (m[i + 1] - m[i]))


# -- serialization (the engine's AggregateFunction state wire form) ----------

def serialize_digest(means: np.ndarray, counts: np.ndarray) -> str:
    import base64
    buf = np.concatenate([np.asarray(means, dtype="<f8"),
                          np.asarray(counts, dtype="<f8")]).tobytes()
    return base64.b64encode(buf).decode()


def deserialize_digest(s: str) -> tuple[np.ndarray, np.ndarray]:
    import base64
    arr = np.frombuffer(base64.b64decode(s), dtype="<f8")
    h = arr.size // 2
    return arr[:h].copy(), arr[h:].copy()
