"""Copy of myscaledb_tpu/core/dictionary.py (JAX-free; imports renamed to this package).

Host-side string dictionary (the reference's LowCardinality analog).

Strings never cross into HBM: each STRING column carries a host dictionary
mapping string -> int32 id, and the device column holds ids.  Equality and IN
predicates are evaluated on ids; ORDER BY over a string column goes through a
host-computed rank table (id -> sorted position) so the device sorts ints.

Reference analog: src/Columns/ColumnLowCardinality.h and
src/DataTypes/DataTypeLowCardinality.h — we make it the *only* string
representation rather than an opt-in wrapper, because variable-length data has
no efficient TPU layout.
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np

NULL_ID = -1  # id reserved for NULL strings


class StringDictionary:
    __slots__ = ("values", "index", "_ranks", "__weakref__")

    def __init__(self, values: Optional[list[str]] = None):
        self.values: list[str] = list(values) if values else []
        self.index: dict[str, int] = {v: i for i, v in enumerate(self.values)}
        self._ranks: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return len(self.values)

    def encode(self, strings: Iterable) -> np.ndarray:
        """Encode strings to int32 ids, growing the dictionary as needed.
        (The JAX package sends batches of 4096 or more with no NULL to its
        native C++ encoder.  Here every batch takes this loop, which assigns
        the same ids: the native encoder, as bound today, marshals the whole
        dictionary on each call and measured slower on the card's host.)"""
        strings = list(strings) if not isinstance(strings, list) else strings
        idx = self.index
        vals = self.values
        out = np.empty(len(strings), dtype=np.int32)
        grew = False
        for i, s in enumerate(strings):
            if s is None:
                out[i] = NULL_ID
                continue
            s = str(s)
            j = idx.get(s)
            if j is None:
                j = len(vals)
                vals.append(s)
                idx[s] = j
                grew = True
            out[i] = j
        if grew:
            self._ranks = None
        return out

    def encode_one(self, s: str, grow: bool = False) -> int:
        """Encode a single literal; -2 means 'not present' (matches nothing)."""
        j = self.index.get(str(s))
        if j is None:
            if not grow:
                return -2
            j = len(self.values)
            self.values.append(str(s))
            self.index[str(s)] = j
            self._ranks = None
        return j

    def decode(self, ids: np.ndarray) -> list:
        vals = self.values
        return [None if i == NULL_ID else vals[int(i)] for i in np.asarray(ids)]

    def ranks(self) -> np.ndarray:
        """rank[id] = position of value in lexicographic order (for ORDER BY)."""
        if self._ranks is None or len(self._ranks) != len(self.values):
            order = np.argsort(np.asarray(self.values, dtype=object), kind="stable")
            r = np.empty(len(self.values), dtype=np.int32)
            r[order] = np.arange(len(self.values), dtype=np.int32)
            self._ranks = r
        return self._ranks

    def copy(self) -> "StringDictionary":
        """An independent dictionary with the same ids (the list and the
        index copied whole, not re-encoded value by value)."""
        out = StringDictionary()
        out.values = list(self.values)
        out.index = dict(self.index)
        return out

    def merge_from(self, other: "StringDictionary") -> np.ndarray:
        """Merge another dictionary into this one; returns an id-remap array
        such that remap[other_id] = self_id (used when concatenating parts)."""
        remap = np.empty(len(other.values), dtype=np.int32)
        for i, v in enumerate(other.values):
            remap[i] = self.encode_one(v, grow=True)
        return remap
