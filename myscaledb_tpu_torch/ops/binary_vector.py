"""Binary-vector distance scans: Hamming / Jaccard over packed bit vectors.
The port of myscaledb_tpu/ops/binary_vector.py (``BINARY_METRICS``,
``pack_binary``, ``pack_binary_segs``, ``to_segs_layout``,
``_binary_scan_impl``, ``_block_scores``, ``_binary_scan_stream``,
``_binary_rescore``, ``_binary_scan_segs``, ``binary_distance_scan``).

Reference: src/VectorIndex/Common/BruteForceSearch.h:63-110 — binary vectors
are FixedString(N) columns (N bytes = 8N bits, VIUtils.cpp:666); Hamming =
popcount(x XOR y) (integer, ascending), Jaccard = (|x OR y| - |x AND y|) /
|x OR y| (float, ascending; empty union -> distance 1).  Ties break by
ascending row id.

Vectors pack into 32-bit words, little-endian within each word, ceil(N/4)
words per row.  On the host the packed words are numpy uint32, as in the
JAX package; on the device they are int32 tensors holding the same bits
(``words_tensor``), since torch has few operations on uint32.  Row ids are
int64; INVALID_ID stands for rows that do not exist or were masked out
(their scores are +inf).

Dispatch follows the JAX package: on the card, a segment-major table of
more than 2^16 rows runs K5 (ops/kernels/binary_scan.py) and an exact
rescore of the best k segments; everything else takes the row-major path,
one block or streamed block by block.
"""

from __future__ import annotations

import numpy as np
import torch

from myscaledb_tpu_torch.ops.kernels.binary_scan import (SEG, SEGS_PER_STEP,
                                                         binary_segment_mins,
                                                         word_scores)
from myscaledb_tpu_torch.ops.topk import (block_topk_min, merge_sorted_topk,
                                         sort_by_score_then_id)
from myscaledb_tpu_torch.ops.vector import INVALID_ID

BINARY_METRICS = ("Hamming", "Jaccard")


def pack_binary(raw, nbytes: int) -> np.ndarray:
    """(n,) byte strings (or latin-1 str) -> (n, ceil(nbytes/4)) uint32,
    little-endian within each word; short rows are zero-padded (FixedString
    pads with \\0) and long rows cut to nbytes.  Rows that all have exactly
    nbytes bytes are packed in one pass over one joined buffer."""
    n = len(raw)
    words = max(1, -(-nbytes // 4))
    buf = np.zeros((n, words * 4), dtype=np.uint8)
    flat = None
    if n and nbytes and set(map(len, raw)) == {nbytes}:
        try:
            flat = "".join(raw).encode("latin-1", "replace")
        except TypeError:
            try:
                flat = b"".join(raw)
            except TypeError:
                flat = None
    if flat is not None and len(flat) == n * nbytes:
        buf[:, :nbytes] = np.frombuffer(flat, dtype=np.uint8).reshape(
            n, nbytes)
    else:
        for i, r in enumerate(raw):
            b = r if isinstance(r, (bytes, bytearray)) else \
                str(r).encode("latin-1", "replace")
            b = b[:nbytes]
            buf[i, :len(b)] = np.frombuffer(b, dtype=np.uint8)
    return buf.view("<u4").reshape(n, words)


def words_tensor(a, device=None) -> torch.Tensor:
    """Packed words (uint32 numpy, or an int32 tensor) -> int32 tensor with
    the same bits, on ``device`` if one is given."""
    if isinstance(a, torch.Tensor):
        if a.dtype != torch.int32:
            raise ValueError(f"packed words must be an int32 tensor, got "
                             f"{a.dtype}")
        return a if device is None else a.to(device)
    a = np.asarray(a)
    if a.dtype not in (np.uint32, np.int32):
        raise ValueError(f"packed words must be uint32, got {a.dtype}")
    t = torch.from_numpy(np.array(a, order="C").view(np.int32))
    return t if device is None else t.to(device)


def pack_binary_segs(raw, nbytes: int) -> np.ndarray:
    """Segment-major packed layout (nseg, words, SEG), the layout K5 reads."""
    return to_segs_layout(pack_binary(raw, nbytes))


def to_segs_layout(xw: np.ndarray) -> np.ndarray:
    """(n, words) -> (nseg, words, SEG) with zero row padding to a whole
    number of SEGS_PER_STEP segments (the JAX package's padding, so the two
    sidecars are bit-equal)."""
    xw = np.asarray(xw)
    n, words = xw.shape
    span = SEG * SEGS_PER_STEP
    npad = -(-max(n, 1) // span) * span
    if npad != n:
        xw = np.pad(xw, ((0, npad - n), (0, 0)))
    return np.ascontiguousarray(
        xw.reshape(npad // SEG, SEG, words).transpose(0, 2, 1))


def _block_scores(xc, qw, mask_c, metric: str, has_mask: bool):
    """(nq, C) scores for one row block; masked rows -> +inf."""
    score = torch.stack([word_scores(xc, q[None, :], metric, dim=1)
                         for q in qw]) if qw.shape[0] else \
        torch.zeros((0, xc.shape[0]), device=xc.device)
    if has_mask:
        score = torch.where(mask_c[None, :], score, float("inf"))
    return score


def _binary_scan_impl(xw, qw, mask, metric: str, k: int, has_mask: bool):
    kk = min(k, xw.shape[0])
    score = _block_scores(xw, qw, mask, metric, has_mask)
    s, i = block_topk_min(score, kk)
    if has_mask:
        i = torch.where(torch.isposinf(s), INVALID_ID, i)
    return s, i


def _binary_scan_stream(xw, qw, mask, metric: str, k: int, has_mask: bool,
                        chunk: int, n: int):
    """Streaming scan + k-select over row chunks: each chunk's (nq, chunk)
    scores fold into a running (nq, k) best through a lexicographic
    (score, id) merge, so the (nq, n) score matrix never exists."""
    nq = qw.shape[0]
    dev = xw.device
    bs = torch.full((nq, k), float("inf"), device=dev)
    bi = torch.full((nq, k), INVALID_ID, dtype=torch.int64, device=dev)
    for base in range(0, xw.shape[0], chunk):
        mc = mask[base:base + chunk] if has_mask else None
        score = _block_scores(xw[base:base + chunk], qw, mc, metric,
                              has_mask)
        row = base + torch.arange(chunk, device=dev)
        score = torch.where(row[None, :] < n, score, float("inf"))
        s, idx = block_topk_min(score, min(k, chunk))
        bs, bi = merge_sorted_topk(bs, bi, s, idx + base, k)
    return bs, torch.where(torch.isposinf(bs), INVALID_ID, bi)


def _binary_rescore(x3, qw, segmins, mask2, metric: str, k: int, n: int,
                    has_mask: bool):
    """Pass 2: take the top-k segments per query by (min, segment id) and
    rescore them exactly; lexicographic (score, id) cut.  Exact including
    ties by id: if a true top-k row r in segment s were outside the k chosen
    segments, k segments precede (min_s, s), each with a row that beats r
    (a smaller score, or an equal score at a lower id, since segments are
    contiguous row ranges) — k rows beating r contradicts r in the top k."""
    nseg, words, _ = x3.shape
    nq = qw.shape[0]
    dev = x3.device
    kk = min(k, n)
    m = min(max(kk, 1), nseg)
    _, segs = block_topk_min(segmins.T.contiguous(), m)     # (nq, m)
    xseg = x3[segs.reshape(-1)].reshape(nq, m, words, SEG)
    score = word_scores(xseg, qw[:, None, :, None], metric, dim=2)
    ids = segs[:, :, None] * SEG + torch.arange(SEG, device=dev)
    live = ids < n
    if has_mask:
        live &= mask2[segs.reshape(-1)].reshape(nq, m, SEG) != 0
    score = torch.where(live, score, float("inf")).reshape(nq, m * SEG)
    ids = torch.where(live, ids, INVALID_ID).reshape(nq, m * SEG)
    s, i = sort_by_score_then_id(score, ids)
    s, i = s[:, :kk], i[:, :kk]
    return s, torch.where(torch.isposinf(s), INVALID_ID, i)


def _binary_scan_segs(x3, qw, metric, k, mask, n):
    """Two-pass exact top-k over the segment-major layout: K5's segment
    minima (the (nq, n) scores never exist) + an exact rescore of k
    segments."""
    nseg = x3.shape[0]
    has_mask = mask is not None
    if has_mask:
        mask_u8 = torch.as_tensor(mask, device=x3.device).to(torch.uint8)
        mask_u8 = torch.nn.functional.pad(mask_u8,
                                          (0, nseg * SEG - mask_u8.shape[0]))
        mask2 = mask_u8.reshape(nseg, SEG)
    else:
        mask2 = x3        # a placeholder: nothing reads it without a mask
    segmins = binary_segment_mins(x3, qw, mask2, metric, n, has_mask)
    return _binary_rescore(x3, qw, segmins, mask2, metric, k, n, has_mask)


def binary_distance_scan(xw, qw, metric: str = "Hamming", k: int = 10,
                         mask=None, block_rows: int = 1 << 20,
                         layout: str = "rows", n: int | None = None):
    """Exact top-k binary scan.  xw: (n, words) packed rows (layout
    "rows"), or (nseg, words, SEG) segment-major (layout "segs", n the real
    row count under the padding); packed words as uint32 numpy or int32
    tensors (``words_tensor``).  Returns (dist (nq, kk) float32 — integral
    values for Hamming — and ids (nq, kk) int64, ties by id ascending) on
    xw's device.  Large row counts stream blockwise; on the card the
    segment-major layout over more than 2^16 rows runs K5 and the
    rescore."""
    xw = words_tensor(xw)
    qw = words_tensor(qw, xw.device)
    if metric not in BINARY_METRICS:
        raise ValueError(f"unknown binary vector metric {metric!r}")
    nq = qw.shape[0]
    empty = (torch.zeros((nq, 0), device=xw.device),
             torch.zeros((nq, 0), dtype=torch.int64, device=xw.device))
    if mask is not None:
        mask = torch.as_tensor(mask, dtype=torch.bool, device=xw.device)
    if layout == "segs":
        nseg, words, _seg = xw.shape
        n = nseg * SEG if n is None else int(n)
        if n == 0:
            return empty
        if xw.device.type != "cpu" and n > (1 << 16):
            return _binary_scan_segs(xw, qw, metric, k, mask, n)
        # small / CPU: unpack back to the row-major path
        xw = xw.transpose(1, 2).reshape(nseg * SEG, words)[:n]
    n = xw.shape[0]
    if n == 0:
        return empty
    has_mask = mask is not None
    if n <= block_rows:
        return _binary_scan_impl(xw, qw, mask, metric, k, has_mask)
    # chunk sized so the (nq, chunk) block stays small
    chunk = max(1 << 13, min(block_rows, (1 << 23) // max(nq, 1)))
    npad = -(-n // chunk) * chunk
    if npad != n:
        xw = torch.nn.functional.pad(xw, (0, 0, 0, npad - n))
        if has_mask:
            mask = torch.cat([mask, torch.zeros(npad - n, dtype=torch.bool,
                                                device=mask.device)])
    return _binary_scan_stream(xw, qw, mask, metric, min(k, n), has_mask,
                               chunk, n)
