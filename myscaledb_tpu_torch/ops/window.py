"""Window functions over sorted partitions: the port of
myscaledb_tpu/ops/window.py (``WindowLayout`` with ``row_number``,
``rank``, ``dense_rank``, ``ntile``, ``first_value``, ``last_value``,
``shift`` and ``agg``; ``_segmented_scan``).  Reference analog:
src/Processors/Transforms/WindowTransform.cpp.

Everything reduces to one sorted layout: rows ordered by (partition id,
ORDER BY keys, row id).  On that layout every window quantity is a
segmented scan/cumsum:

  row_number   position - partition_start + 1
  rank         peer_start - partition_start + 1
  dense_rank   peer_index - peer_index_at_partition_start + 1
  sum/count/avg/min/max without ORDER BY: whole-partition aggregate,
               broadcast back to rows
  with ORDER BY: running aggregate over the RANGE frame (unbounded preceding
               .. current row INCLUDING peers — ClickHouse's default frame):
               cumulative value at the END of the row's peer group
  lag/lead     shifted gather guarded by partition boundaries

Results are scattered back to original row order through the permutation.
The JAX package takes the layout from one multi-operand ``lax.sort``; here
it comes from stable sorts, last operand first, as ``sort_permutation``
does.  Float sums keep the JAX formula (an f32 cumsum less the value before
the partition's start), but the cumsum adds in another order (on the CPU
PyTorch accumulates in f64), so float sums and averages agree with the JAX
package's within a tolerance, not bit for bit.
"""

from __future__ import annotations

import torch


def _first_flags(sorted_key: torch.Tensor) -> torch.Tensor:
    """True where a row's key differs from the previous row's (and at 0)."""
    first = torch.ones(sorted_key.shape[0], dtype=torch.bool,
                       device=sorted_key.device)
    first[1:] = sorted_key[1:] != sorted_key[:-1]
    return first


def _segment_bounds(seg_first: torch.Tensor):
    """seg_first: bool (m,), True at the first row of each segment.
    Returns (start, end): (m,) int64 index of the first and of the last row
    of every row's segment.  The JAX package takes them as a ``cummax`` of
    the marked starts and a reversed ``cummin`` of the marked ends; here
    they are the marks' positions gathered by each row's segment number (a
    cumsum): on the card ``torch.cummax``/``cummin`` over a 1-D tensor are
    slow (on an H100 a window statement over 10M rows took 122 ms of device
    time with them, 6.2 ms without; chip_smoke.py, phase sql_window)."""
    marks = torch.nonzero(seg_first).flatten()
    seg = torch.cumsum(seg_first, 0) - 1
    nxt = torch.cat([marks[1:], marks.new_full((1,), seg_first.shape[0])])
    return marks[seg], nxt[seg] - 1


def _sum_dtype(v: torch.Tensor) -> torch.dtype:
    return torch.float32 if v.is_floating_point() else torch.int64


class WindowLayout:
    """Sorted layout shared by all window functions of one OVER clause."""

    def __init__(self, part_gid, order_operands, n: int):
        """part_gid: (n,) partition id (0 if no PARTITION BY);
        order_operands: list of ascending-encoded key tensors (may be [])."""
        ops = [part_gid.to(torch.int32)] + list(order_operands)
        perm = torch.arange(n, dtype=torch.int64, device=part_gid.device)
        for op in reversed(ops):
            perm = perm[torch.sort(op[perm], stable=True).indices]
        self.perm = perm                          # sorted -> original row
        self.gid_s = ops[0][perm]
        self.n = n
        self.part_first = _first_flags(self.gid_s)
        peer_first = self.part_first
        for o in order_operands:
            peer_first = peer_first | _first_flags(o[perm])
        self.peer_first = peer_first
        self.part_start, self.part_end = _segment_bounds(self.part_first)
        self.peer_start, self.peer_end = _segment_bounds(self.peer_first)
        self.has_order = len(order_operands) > 0

    def unsort(self, vals_sorted: torch.Tensor) -> torch.Tensor:
        """Scatter a sorted-layout result back to original row order."""
        out = torch.empty_like(vals_sorted)
        out[self.perm] = vals_sorted
        return out

    def _pos(self) -> torch.Tensor:
        return torch.arange(self.n, dtype=torch.int64,
                            device=self.perm.device)

    # -- ranking ------------------------------------------------------------

    def row_number(self):
        return self.unsort(self._pos() - self.part_start + 1)

    def rank(self):
        return self.unsort(self.peer_start - self.part_start + 1)

    def dense_rank(self):
        peer_idx = torch.cumsum(self.peer_first.to(torch.int64), 0) - 1
        return self.unsort(peer_idx - peer_idx[self.part_start] + 1)

    def ntile(self, buckets: int):
        pos = self._pos() - self.part_start
        cnt = self.part_end - self.part_start + 1
        return self.unsort(torch.div(pos * buckets, cnt,
                                     rounding_mode="floor") + 1)

    # -- aggregates ---------------------------------------------------------

    def agg(self, fn: str, values: torch.Tensor, valid=None):
        """sum/count/avg/min/max over the default frame: the whole
        partition without ORDER BY, else up to the row's last peer.  NULL
        rows (``valid`` False) are skipped, as ClickHouse skips them:
        count counts the frame's values, avg divides by that count, and a
        frame with no value gives NULL.  Returns (values, validity or
        None)."""
        end = self.peer_end if self.has_order else self.part_end

        def frame_sum(v_s):
            cum = torch.cumsum(v_s, 0)
            base = torch.where(self.part_start > 0,
                               cum[(self.part_start - 1).clamp(min=0)], 0)
            return cum[end] - base

        have = valid[self.perm] if valid is not None else None
        cnt = end - self.part_start + 1 if have is None else \
            frame_sum(have.to(torch.int64))
        if fn == "count":
            return self.unsort(cnt), None
        v_s = values[self.perm]
        if fn in ("sum", "avg"):
            if have is not None:
                v_s = torch.where(have, v_s, torch.zeros_like(v_s))
            total = frame_sum(v_s.to(_sum_dtype(v_s)))
            if fn == "avg":
                total = total.to(torch.float32) / cnt.to(torch.float32)
        elif fn in ("min", "max"):
            if have is not None:
                v_s = torch.where(have, v_s, _identity(v_s, fn))
            total = _segmented_scan(v_s, self.part_first, fn)[end]
        else:
            raise ValueError(fn)
        return self.unsort(total), \
            None if have is None else self.unsort(cnt > 0)

    def first_value(self, values):
        return self.unsort(values[self.perm][self.part_start])

    def last_value(self, values):
        end = self.peer_end if self.has_order else self.part_end
        return self.unsort(values[self.perm][end])

    # -- shifts -------------------------------------------------------------

    def shift(self, values, offset: int, default, lead: bool):
        """lag/lead: the value ``offset`` rows before (after, for lead) in
        the sorted layout where that row is in the same partition, else
        ``default``.  Returns (values, in-partition flags)."""
        v_s = values[self.perm]
        idx = self._pos() + (offset if lead else -offset)
        ok = (idx >= 0) & (idx < self.n)
        safe = idx.clamp(0, max(self.n - 1, 0))
        same_part = ok & (self.gid_s[safe] == self.gid_s)
        dv = torch.tensor(default, dtype=v_s.dtype, device=v_s.device)
        out_s = torch.where(same_part, v_s[safe], dv)
        return self.unsort(out_s), self.unsort(same_part)


def _identity(v: torch.Tensor, fn: str) -> torch.Tensor:
    """The value min (max) never picks: its dtype's largest (smallest)."""
    if v.is_floating_point():
        big = float("inf")
    elif v.dtype == torch.bool:
        big = True
    else:
        big = torch.iinfo(v.dtype).max
    if fn == "max":
        big = -big if v.is_floating_point() else (
            False if v.dtype == torch.bool else torch.iinfo(v.dtype).min)
    return torch.full_like(v, big)


def _segmented_scan(v, seg_first, fn):
    """Segment-resetting running min/max: the JAX package's associative
    scan on (flag, value) pairs, as log2(n) doubling steps (an element
    combines with the one ``d`` rows before it; a set flag stops the
    segment's earlier values)."""
    op = torch.minimum if fn == "min" else torch.maximum
    flags, vals = seg_first, v
    d = 1
    while d < v.shape[0]:
        fb, vb = flags[d:], vals[d:]
        vals = torch.cat([vals[:d], torch.where(fb, vb, op(vals[:-d], vb))])
        flags = torch.cat([flags[:d], fb | flags[:-d]])
        d *= 2
    return vals
