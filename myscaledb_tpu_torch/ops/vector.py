"""Fused vector-distance scan with exact top-k: the port of
myscaledb_tpu/ops/vector.py (``exact_distance``, ``_f32_sum``, ``_rescore``,
``_distance_scan_oneshot_impl``, ``_distance_scan_pallas`` (here
``_distance_scan_segmin``), ``build_sq8``, ``_distance_scan_sq8``,
``_distance_scan_impl``, ``distance_scan``, ``distance_scan_streaming``,
``rowwise_distance``, ``precompute_sqnorm``).

Distance semantics (the engine's bit-exactness contract):
  * L2     -> squared L2 computed directly as sum((x-q)^2) in f32, ascending.
  * Cosine -> 1 - dot(x/|x|, q/|q|) with f32-normalized vectors, ascending.
  * IP     -> inner product, descending.
  * ties   -> ascending row id.

Execution is two-stage: stage 1 selects candidates with the
|x|^2 - 2 x.q + |q|^2 decomposition (a matrix product, or the K1/K2
kernels' per-segment minima), stage 2 rescores the candidates with the
exact direct formula and ranks them by (exact distance, id).  The certified
int8 path (K1) is used when a sidecar exists and its certificate holds;
otherwise the f32 segment-min path (K2) runs.  On a CUDA tensor the
kernels launch; on a CPU tensor their plain versions run, on the same
branches.  Row ids are int64 tensors; INVALID_ID marks padding.
"""

from __future__ import annotations

import numpy as np
import torch

from myscaledb_tpu_torch.ops.topk import (block_topk_min, merge_sorted_topk,
                                          sort_by_score_then_id,
                                          stable_argsort_min, POS_INF)
from myscaledb_tpu_torch.ops.kernels.distance import (pallas_supported,
                                                      query_aux, segmin_f32,
                                                      segmin_scores)
from myscaledb_tpu_torch.ops.kernels.distance_q import (INV_127, segmin_sq8,
                                                        sidecar_pad_rows,
                                                        sq8_supported)

INVALID_ID = 2 ** 31 - 1

METRICS = ("L2", "Cosine", "IP")

# score-matrix budget for the one-shot path: nq * n * 4 bytes
ONESHOT_BYTES = 512 * 1024 * 1024
SEG = 128   # segment width for the min-prefilter


def _as_f32(a, device) -> torch.Tensor:
    """Tensor of float32 on ``device`` (numpy arrays and lists are
    copied there)."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)


def exact_distance(xc, q, metric: str):
    """Exact reference-semantics distance.

    xc: (..., d) candidate vectors; q: broadcastable (..., d) queries.
    Returns the metric's native distance (L2 squared / cosine distance / IP).
    """
    if metric == "L2":
        diff = xc - q
        return _f32_sum(diff * diff)
    if metric == "Cosine":
        xn = _sqrt_f32(_sq_norm(xc))[..., None]
        qn = _sqrt_f32(_sq_norm(q))[..., None]
        xu = torch.where(xn > 0, xc / xn, 0.0)
        qu = torch.where(qn > 0, q / qn, 0.0)
        return 1.0 - _f32_sum(xu * qu)
    return _f32_sum(xc * q)   # IP


def _fma_f32(a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor) -> torch.Tensor:
    """a * b + c for f32 tensors with one rounding, as a fused multiply-add
    gives it.  The product of two f32 values is exact in f64; the f64 sum
    is made round-to-odd (TwoSum's error term nudges an inexact even
    result one ulp toward the exact value), so its rounding to f32 equals
    the single rounding of the exact a * b + c."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).double()
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def _sqrt_f32(v: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root.  torch's vectorized f32 sqrt on
    the CPU is off by an ulp for some inputs; the root taken in f64 and
    rounded once to f32 is the IEEE result (53 >= 2 * 24 + 2 bits)."""
    return torch.sqrt(v.double()).float()


def _sq_norm(v: torch.Tensor) -> torch.Tensor:
    """Squared norm over the last axis in the JAX package's order on its
    CPU backend: XLA compiles sum(v * v) at d <= 4 into a chain of fused
    multiply-adds from 0, and at 5 <= d <= 8 into one f32 multiply and add
    at a time, in order.  Larger d keeps the library reduction."""
    d = v.shape[-1]
    if d > 8:
        return (v * v).sum(dim=-1)
    out = torch.zeros(v.shape[:-1], dtype=v.dtype, device=v.device)
    for t in range(d):
        vt = v[..., t]
        out = _fma_f32(vt, vt, out) if d <= 4 else out + vt * vt
    return out


def _f32_sum(terms: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis; for d <= 8 one f32 add at a time, in order,
    so small-dimension results are bit-equal to the reference's sequential
    f32 sums (the JAX package forces the same with a lax.scan).  Larger d
    keeps the library reduction, whose order no golden pins."""
    d = terms.shape[-1]
    if d > 8:
        return terms.sum(dim=-1)
    out = torch.zeros(terms.shape[:-1], dtype=terms.dtype,
                      device=terms.device)
    for t in range(d):
        out = out + terms[..., t]
    return out


def _final_dist(fs, metric):
    """Selection scores of the k winners -> the metric's native distance
    (+inf padding becomes -inf for IP)."""
    pad = -torch.inf if metric == "IP" else torch.inf
    return torch.where(torch.isposinf(fs), pad, -fs if metric == "IP" else fs)


def _pad_to_k(dist, ids, k, metric):
    if dist.shape[-1] >= k:
        return dist, ids
    padw = k - dist.shape[-1]
    nq = dist.shape[0]
    pad = -torch.inf if metric == "IP" else torch.inf
    dist = torch.cat([dist, torch.full((nq, padw), pad, dtype=dist.dtype,
                                       device=dist.device)], dim=1)
    ids = torch.cat([ids, torch.full((nq, padw), INVALID_ID, dtype=ids.dtype,
                                     device=ids.device)], dim=1)
    return dist, ids


def _segment_ids(segidx: torch.Tensor) -> torch.Tensor:
    """(nq, kseg) segment numbers -> (nq, kseg * SEG) row ids."""
    nq, kseg = segidx.shape
    lane = torch.arange(SEG, dtype=torch.int64, device=segidx.device)
    return (segidx[:, :, None] * SEG + lane).reshape(nq, kseg * SEG)


def _rescore(x, q, cs, ci, metric, k):
    """Stage 2: exact direct-formula rescore of candidates, cut to k."""
    invalid = ci == INVALID_ID
    safe_ids = torch.where(invalid, 0, ci)
    xc = x[safe_ids]                                   # (nq, ksel, d)
    ex = exact_distance(xc, q[:, None, :], metric)     # (nq, ksel)
    score = torch.where(invalid, POS_INF, -ex if metric == "IP" else ex)
    fs, fi = sort_by_score_then_id(score, ci)
    fs, fi = fs[:, :k], fi[:, :k]
    return _final_dist(fs, metric), fi


def _rescore_segments(x, q, segidx, mask, has_mask, metric, k):
    """Exact rescore of every row of the selected segments (ascending
    segment order, so the lowest-index tie rule is the lowest-id rule).
    Returns (scores of the k best, their ids, dist)."""
    n = x.shape[0]
    cid = _segment_ids(segidx)
    valid = cid < n
    safe = torch.where(valid, cid, 0)
    if has_mask:
        valid = valid & mask[safe]
    xc = x[safe]                                  # (nq, kseg*SEG, d)
    ex = exact_distance(xc, q[:, None, :], metric)
    score = torch.where(valid, -ex if metric == "IP" else ex, POS_INF)
    order = stable_argsort_min(score)[:, :min(k, score.shape[-1])]
    fs = torch.gather(score, 1, order)
    fi = torch.gather(cid, 1, order)
    fi = torch.where(torch.isposinf(fs), INVALID_ID, fi)
    return fs, fi, _final_dist(fs, metric)


def _distance_scan_oneshot_impl(x, q, mask, x_sqnorm, metric: str, k: int,
                                has_mask: bool, margin: int = 16):
    """One-shot path: materialize the (nq, n) selection-score matrix, prune
    with per-segment minima (the top-s segments by (min, segid) contain
    every top-s element), then take candidates by (score, id) and rescore.
    The ragged <128-row tail always joins the candidates."""
    n, d = x.shape
    nq = q.shape[0]
    ksel = min(k + margin, n)
    n_floor = (n // SEG) * SEG
    q_aux = query_aux(q, metric)
    # selection only: stage 2 rescores exactly
    s = segmin_scores(q @ x.T, x_sqnorm, q_aux, metric)        # (nq, n)
    if has_mask:
        s = torch.where(mask[None, :], s, POS_INF)
    nseg = n_floor // SEG
    dev = x.device
    if nseg > 0:
        sr = s[:, :n_floor].reshape(nq, nseg, SEG)
        kseg = min(ksel, nseg)
        segmin = sr.amin(dim=-1)                               # (nq, nseg)
        segidx = stable_argsort_min(segmin)[:, :kseg]
        segidx = torch.sort(segidx, dim=-1).values
        cand = torch.gather(sr, 1, segidx[:, :, None].expand(nq, kseg, SEG))
        cand = cand.reshape(nq, kseg * SEG)
        cid = _segment_ids(segidx)
    else:
        cand = torch.zeros((nq, 0), dtype=torch.float32, device=dev)
        cid = torch.zeros((nq, 0), dtype=torch.int64, device=dev)
    if n_floor != n:
        tail_ids = torch.arange(n_floor, n, dtype=torch.int64, device=dev)
        cand = torch.cat([cand, s[:, n_floor:]], dim=1)
        cid = torch.cat([cid, tail_ids[None, :].expand(nq, n - n_floor)],
                        dim=1)
    order = stable_argsort_min(cand)[:, :min(ksel, cand.shape[1])]
    cs = torch.gather(cand, 1, order)
    ci = torch.gather(cid, 1, order)
    ci = torch.where(torch.isposinf(cs), INVALID_ID, ci)
    return _rescore(x, q, cs, ci, metric, k)


def _distance_scan_segmin(x, q, mask, x_sqnorm, metric: str, k: int,
                          has_mask: bool, margin: int = 16):
    """Segment-min path (JAX: ``_distance_scan_pallas``): the K2 kernel
    computes per-segment score minima with x read once; the k + margin
    best segments are then rescored with the exact direct formula."""
    n = x.shape[0]
    ksel = min(k + margin, n)
    q_aux = query_aux(q, metric)
    mask_f = mask.float() if has_mask else None
    segmins = segmin_f32(x, q, x_sqnorm, q_aux, mask_f, metric)
    kseg = min(ksel, segmins.shape[1])
    segidx = stable_argsort_min(segmins)[:, :kseg]
    segidx = torch.sort(segidx, dim=-1).values
    _fs, fi, dist = _rescore_segments(x, q, segidx, mask, has_mask, metric, k)
    return _pad_to_k(dist, fi, k, metric)


def build_sq8(x: torch.Tensor):
    """SQ8 sidecar for the certified int8 stage 1: per-row symmetric int8
    quantization plus the side fields the error bound needs, padded to
    sidecar_pad_rows(n).  Returns (x8 (n_pad, d) int8, sides (4, n_pad) f32)
    with sides rows [|x|^2, |x - scale x8|, scale, valid]."""
    x = x.float()
    n = x.shape[0]
    n_pad = sidecar_pad_rows(n)
    pr = n_pad - n
    scale = torch.clamp_min(x.abs().amax(dim=1) * INV_127, 1e-30)
    x8 = torch.clamp(torch.round(x / scale[:, None]), -127, 127) \
        .to(torch.int8)
    resid = x - x8.float() * scale[:, None]
    r = torch.sqrt((resid * resid).sum(dim=1))
    sqn = (x * x).sum(dim=1)
    del resid
    x8 = torch.nn.functional.pad(x8, (0, 0, 0, pr))
    pad1 = lambda v: torch.nn.functional.pad(v, (0, pr))  # noqa: E731
    valid = (torch.arange(n_pad, device=x.device) < n).float()
    sides = torch.stack([pad1(sqn), pad1(r), pad1(scale), valid])
    return x8, sides


def _distance_scan_sq8(x, x8, sides, q, mask, metric: str, k: int,
                       has_mask: bool, margin: int = 16):
    """Certified-exact quantized scan: int8 stage-1 lower bounds (K1), the
    exact f32 rescore of the selected segments, and a certificate (``ok``):
    every unselected segment's lower bound exceeds the exact k-th candidate
    score.  Returns (dist, ids, ok) with ok a bool tensor; the caller must
    fall back to a full-precision path when ok is False."""
    n = x.shape[0]
    n_pad = x8.shape[0]
    nq = q.shape[0]
    if has_mask:
        mv = (torch.nn.functional.pad(mask.float(), (0, n_pad - n))[None, :]
              * sides[3:4])
    else:
        mv = sides[3:4]
    seg_lb = segmin_sq8(x8, sides, q, mv.contiguous(), metric)
    nseg = seg_lb.shape[1]
    M = min(k + margin, nseg)
    take = min(M + 1, nseg)
    order = stable_argsort_min(seg_lb)[:, :take]
    if take > M:
        unsel_min = torch.gather(seg_lb, 1, order[:, M:M + 1])[:, 0]
    else:
        unsel_min = torch.full((nq,), torch.inf, device=x.device)
    segidx = torch.sort(order[:, :M], dim=-1).values
    fs, fi, dist = _rescore_segments(x, q, segidx, mask, has_mask, metric, k)
    d_k = fs[:, min(k, fs.shape[1]) - 1]          # exact k-th candidate score
    ok = torch.all(unsel_min > d_k)
    if dist.shape[-1] < k:
        ok = torch.zeros((), dtype=torch.bool, device=x.device)  # under-full
    dist, fi = _pad_to_k(dist, fi, k, metric)
    return dist, fi, ok


def _distance_scan_impl(x, q, mask, x_sqnorm, metric: str, k: int,
                        block_rows: int, has_mask: bool, margin: int = 16):
    """Block-streaming path for score matrices over the one-shot budget:
    per block, the top-(k + margin) selection merges into a sorted carry
    by (score, id); the ragged last block's missing rows score +inf (the
    JAX package pads the table instead; x is never copied here)."""
    n, d = x.shape
    nq = q.shape[0]
    b = min(block_rows, max(8, n))
    nb = -(-n // b)
    ksel = min(k + margin, n)
    q_aux = query_aux(q, metric)
    dev = x.device
    cs = torch.full((nq, ksel), POS_INF, dtype=torch.float32, device=dev)
    ci = torch.full((nq, ksel), INVALID_ID, dtype=torch.int64, device=dev)
    kk = min(ksel, b)
    for bi in range(nb):
        lo, hi = bi * b, min((bi + 1) * b, n)
        s = segmin_scores(q @ x[lo:hi].T, x_sqnorm[lo:hi], q_aux, metric)
        if has_mask:
            s = torch.where(mask[None, lo:hi], s, POS_INF)
        if hi - lo < b:
            s = torch.cat([s, torch.full((nq, b - (hi - lo)), POS_INF,
                                         device=dev)], dim=1)
        bs, bpos = block_topk_min(s, kk)
        bids = torch.where(torch.isposinf(bs), INVALID_ID, bpos + lo)
        cs, ci = merge_sorted_topk(cs, ci, bs, bids, ksel)
    return _rescore(x, q, cs, ci, metric, k)


def distance_scan(x, q, metric: str = "L2", k: int = 10, mask=None,
                  block_rows: int = 32768, x_sqnorm=None, margin: int = 16,
                  sq8=None, oneshot_bytes: int = None):
    """Exact top-k nearest scan of queries ``q`` (nq, d) over the rows of
    the tensor ``x`` (n, d), under an optional boolean predicate ``mask``
    (n,).  Runs on x's device.

    Returns (dist (nq, k), ids (nq, k) int64).  Entries with id ==
    INVALID_ID are padding (fewer than k rows satisfied the mask).  ``dist``
    is in the metric's native convention; rows are ordered best first
    (ascending for L2/Cosine, descending for IP), ties by id.

    ``sq8``: optional (x8, sides) sidecar from build_sq8 — enables the
    certified int8 stage 1; when its certificate cannot prove the selection
    the f32 path runs, so the result never depends on the quantization.
    """
    if metric not in METRICS:
        raise ValueError(f"metric must be one of {METRICS}, got {metric!r}")
    if not isinstance(x, torch.Tensor):
        raise TypeError("distance_scan: x must be a tensor on the scan's "
                        "device")
    dev = x.device
    x = x.float()
    q = _as_f32(q, dev)
    if q.dim() == 1:
        q = q[None, :]
    if x_sqnorm is None:
        x_sqnorm = precompute_sqnorm(x)
    x_sqnorm = _as_f32(x_sqnorm, dev)
    has_mask = mask is not None
    if has_mask:
        mask = torch.as_tensor(mask, device=dev).bool()
    n, d = x.shape
    nq = q.shape[0]
    k = int(k)
    margin = int(margin)
    if sq8 is not None and n >= (1 << 16) and sq8_supported(d, nq):
        x8, sides = sq8
        d_, i_, ok = _distance_scan_sq8(x, x8, sides, q, mask, metric, k,
                                        has_mask, max(margin, 16))
        if bool(ok):
            return d_, i_
        # certificate failed (clustered/tied data): full-precision path
    if pallas_supported(d, nq) and n >= (1 << 16) \
            and (k + margin) * SEG <= max(n, SEG):
        return _distance_scan_segmin(x, q, mask, x_sqnorm, metric, k,
                                     has_mask, margin)
    if nq * n * 4 <= (oneshot_bytes if oneshot_bytes else ONESHOT_BYTES):
        return _distance_scan_oneshot_impl(x, q, mask, x_sqnorm, metric, k,
                                           has_mask, margin)
    return _distance_scan_impl(x, q, mask, x_sqnorm, metric, k,
                               int(block_rows), has_mask, margin)


def distance_scan_streaming(x_host: np.ndarray, q, metric: str = "L2",
                            k: int = 10, mask=None,
                            block_rows: int = 1 << 20, margin: int = 16):
    """Out-of-device exact top-k scan: the table lives in host RAM and
    streams through q's device block by block; the copy of block b+1 is
    issued before block b is scanned.  Each block runs the resident exact
    scan and blocks merge on (exact score, global id), so the result is the
    one a resident scan gives."""
    if metric not in METRICS:
        raise ValueError(f"metric must be one of {METRICS}, got {metric!r}")
    if not isinstance(q, torch.Tensor):
        raise TypeError("distance_scan_streaming: q must be a tensor on the "
                        "scan's device")
    dev = q.device
    x_host = np.ascontiguousarray(x_host, dtype=np.float32)
    q = q.float()
    if q.dim() == 1:
        q = q[None, :]
    n = x_host.shape[0]
    mask_host = None if mask is None else np.asarray(mask, dtype=bool)
    nb = max(1, -(-n // block_rows))

    def put(b):
        lo, hi = b * block_rows, min((b + 1) * block_rows, n)
        xb = torch.from_numpy(x_host[lo:hi]).to(dev, non_blocking=True)
        mb = torch.from_numpy(mask_host[lo:hi]).to(dev, non_blocking=True) \
            if mask_host is not None else None
        return lo, xb, mb

    parts_s, parts_i = [], []
    nxt = put(0)
    for b in range(nb):
        lo, xb, mb = nxt
        if b + 1 < nb:
            nxt = put(b + 1)
        dloc, iloc = distance_scan(xb, q, metric=metric,
                                   k=min(k, xb.shape[0]), mask=mb,
                                   margin=margin)
        invalid = iloc == INVALID_ID
        parts_s.append(torch.where(invalid, POS_INF,
                                   -dloc if metric == "IP" else dloc))
        parts_i.append(torch.where(invalid, INVALID_ID, iloc + lo))
    ss, ii = sort_by_score_then_id(torch.cat(parts_s, dim=1),
                                   torch.cat(parts_i, dim=1))
    ss, ii = ss[:, :k], ii[:, :k]
    return _pad_to_k(_final_dist(ss, metric), ii, k, metric)


def rowwise_distance(x, q, metric: str = "L2") -> torch.Tensor:
    """Materialized per-row distance column (the non-fused path, used when
    distance() appears outside an ORDER BY ... LIMIT pattern)."""
    x = x.float()
    q = _as_f32(q, x.device)
    if q.dim() == 2:
        q = q[0]
    return exact_distance(x, q[None, :], metric)


def precompute_sqnorm(x) -> torch.Tensor:
    """Squared row norms (built once per table and column)."""
    x = x.float()
    return (x * x).sum(dim=1)
