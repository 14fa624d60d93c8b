"""Durable table = a directory of immutable parts + background merges: the
port of myscaledb_tpu/storage/table_store.py.

Reference analog: MergeTreeData part-set management
(src/Storages/MergeTree/MergeTreeData.cpp): INSERTs create new parts
atomically; a merge rewrites several small parts into one bigger part and
retires the originals; crash recovery is re-listing the directory (tmp_
leftovers are garbage-collected).  Checkpoint/restore is this layer.

A store reads its parts onto one device, given at construction; a sorted
insert orders the rows on that device (ops/sort.py) before the part is
written.
"""

from __future__ import annotations

import os
import re
import shutil
import threading
from concurrent.futures import ThreadPoolExecutor

import torch

from myscaledb_tpu_torch.core.table import Table, concat_tables, to_tensor
from myscaledb_tpu_torch.runtime import metrics as M
from myscaledb_tpu_torch.runtime.faults import INJECTOR, with_retries
from myscaledb_tpu_torch.storage.part import part_rows, read_part, write_part

_PART_RE = re.compile(r"^part_(\d+)_(\d+)$")


class TableStore:
    """Manages the on-disk parts of one table.

    Thread-safety: the part-set COMMIT (rename-in + retire-out) happens
    under ``_lock`` and bumps ``epoch``, so concurrent queries and the
    background merge executor always see a consistent snapshot
    (MergeTreeData::DataPartsLock)."""

    def __init__(self, path: str, *, device):
        self.path = path
        self.device = torch.device(device)
        self._lock = threading.RLock()
        self.epoch = 0
        self._merge_inflight = False
        os.makedirs(path, exist_ok=True)
        self._gc_tmp()

    def _gc_tmp(self):
        for d in os.listdir(self.path):
            if d.startswith("tmp_"):
                shutil.rmtree(os.path.join(self.path, d), ignore_errors=True)

    def parts(self) -> list[str]:
        with self._lock:
            found = []
            for d in os.listdir(self.path):
                m = _PART_RE.match(d)
                if m and os.path.isfile(os.path.join(self.path, d,
                                                     "meta.json")):
                    found.append((int(m.group(1)), d))
            # numeric seq order — lexicographic would put part_10 before
            # part_2 and scramble insert order past 9 parts
            return [os.path.join(self.path, d) for _, d in sorted(found)]

    def _next_seq(self) -> int:
        seqs = [int(_PART_RE.match(os.path.basename(p)).group(1))
                for p in self.parts()]
        return (max(seqs) + 1) if seqs else 0

    def insert(self, table: Table, sort_key: list[str] | None = None,
               codec_overrides: dict | None = None) -> str:
        """Append one part.  With a sort_key the rows are sorted by it
        first, on the table's device (the reference sorts every part by
        primary key on insert, MergeTreeDataWriter.cpp:338)."""
        if sort_key:
            from myscaledb_tpu_torch.ops.sort import SortKey, sort_permutation
            keys = []
            for name in sort_key:
                c = table[name]
                data = c.data
                if c.dictionary is not None:
                    ranks = to_tensor(c.dictionary.ranks(), data.device)
                    data = ranks[torch.clamp(data.to(torch.int64), min=0)] \
                        if ranks.numel() else torch.zeros_like(data)
                keys.append(SortKey(data, valid=c.valid))
            table = table.take(sort_permutation(keys))
        with self._lock:
            name = f"part_{self._next_seq()}_{table.n_rows}"
            out = with_retries(
                lambda: (INJECTOR.maybe_fail("part_write"),
                         write_part(os.path.join(self.path, name), table,
                                    sort_key=sort_key,
                                    codec_overrides=codec_overrides))[1],
                retries=3, site="part_write")
            self.epoch += 1
            return out

    def _read(self, p: str, columns) -> Table:
        return with_retries(
            lambda: (INJECTOR.maybe_fail("part_read"),
                     read_part(p, columns, device=self.device))[1],
            retries=3, site="part_read")

    def load(self, columns: list[str] | None = None) -> Table:
        """Materialize all parts into one resident Table (dictionary merge
        by concat_tables).  Parts are read concurrently on a small thread
        pool (the reference's MergeTreePrefetchedReadPool; decompression
        and file reads release the interpreter lock).  Retries once if a
        background merge retires a part between the snapshot and the
        read."""
        for attempt in (0, 1):
            parts = self.parts()
            if not parts:
                return Table([])
            try:
                if len(parts) > 1:
                    with ThreadPoolExecutor(
                            max_workers=min(8, len(parts))) as ex:
                        tables = list(ex.map(lambda p: self._read(p, columns),
                                             parts))
                else:
                    tables = [self._read(parts[0], columns)]
            except FileNotFoundError:
                if attempt:
                    raise
                continue
            return tables[0] if len(tables) == 1 else concat_tables(tables)

    def total_rows(self) -> int:
        return sum(part_rows(p) for p in self.parts())

    def merge_parts(self, max_parts: int | None = None) -> str | None:
        """Compact all (or the first max_parts) parts into one (MergeTask).
        Data is read and the new part written outside the lock; only the
        commit (rename-in + retire-out) holds it, so queries and inserts
        proceed during the merge."""
        parts = self.parts()
        if max_parts:
            parts = parts[:max_parts]
        if len(parts) < 2:
            return None
        merged = concat_tables([read_part(p, device=self.device)
                                for p in parts])
        with self._lock:
            # parts() may have grown since the snapshot; only the snapshot
            # parts are retired (new inserts survive untouched)
            live = set(self.parts())
            if not all(p in live for p in parts):
                return None   # a concurrent merge took them
            name = f"part_{self._next_seq()}_{merged.n_rows}"
            out = write_part(os.path.join(self.path, name), merged)
            for p in parts:
                shutil.rmtree(p)
            self.epoch += 1
        return out

    def maybe_schedule_merge(self, executor=None, min_parts: int = 8,
                             max_parts: int = 16) -> bool:
        """Schedule a background compaction when the part count builds up
        (StorageMergeTree::scheduleDataProcessingJob).  At most one merge
        per store is in flight."""
        if len(self.parts()) < min_parts:
            return False
        with self._lock:
            if self._merge_inflight:
                return False
            self._merge_inflight = True
        if executor is None:
            from myscaledb_tpu_torch.storage.background import \
                default_executor
            executor = default_executor()

        def task():
            try:
                # merges are idempotent (commit under lock, snapshot-based
                # retire), so the task retries transient failures like the
                # reference's re-queued merge entries
                out = with_retries(
                    lambda: (INJECTOR.maybe_fail("merge"),
                             self.merge_parts(max_parts=max_parts))[1],
                    retries=3, site="merge")
                if out is not None:
                    M.increment(M.PARTS_MERGED)
            finally:
                with self._lock:
                    self._merge_inflight = False

        executor.schedule(task)
        return True

    def drop(self):
        shutil.rmtree(self.path, ignore_errors=True)


def open_table(path: str, columns: list[str] | None = None, *,
               device) -> Table:
    """The table stored at ``path``, resident on ``device``."""
    return TableStore(path, device=device).load(columns)
