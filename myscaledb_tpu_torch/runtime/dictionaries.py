"""External dictionaries over a table: the port of
myscaledb_tpu/runtime/dictionaries.py (``Dictionary``).

Reference analog: src/Dictionaries/ (FlatDictionary, HashedDictionary,
ComplexKeyHashedDictionary); the functions are exec/expr.py's dictGet,
dictGetOrDefault and dictHas.

The snapshot lives on the session's device.  FLAT keeps a direct-index
table over dense non-negative integer keys (sparse keys fall back to
HASHED, as in the JAX package); HASHED sorts the keys once when the
dictionary is built, and a lookup is one ``torch.searchsorted`` over
them: no host round trip per row.  Of equal keys the lowest source row
answers, the JAX package's hash-table representative.  String keys are
dictionary ids: a probe's ids are remapped into the key column's id space
once per probe dictionary value.
"""

from __future__ import annotations

import numpy as np
import torch

from myscaledb_tpu_torch.core.table import Table, to_tensor
from myscaledb_tpu_torch.core.types import DataType

INT32_MAX = 2 ** 31 - 1


class Dictionary:
    """One loaded dictionary: the key column and attribute columns."""

    def __init__(self, name: str, source: Table, key: str,
                 layout: str = "hashed", source_desc: str = ""):
        if key not in source:
            raise ValueError(f"dictionary key column {key!r} not in source")
        self.name = name
        self.key_name = key
        self.layout = layout.lower()
        self.source_desc = source_desc
        self.table = source
        kc = source[key]
        self.key_is_string = kc.dtype is DataType.STRING
        self.key_dictionary = kc.dictionary
        keys = to_tensor(kc.data, source.device).to(torch.int64) \
            if kc.is_host else kc.data.to(torch.int64)
        n = source.n_rows
        self._lut = self._sorted = self._perm = None
        if self.layout == "flat" and not self.key_is_string and n:
            kmin, kmax = int(keys.min()), int(keys.max())
            if kmin >= 0 and kmax <= max(4 * n, 1 << 20):
                # the lowest row of each key
                self._lut = torch.full((kmax + 2,), INT32_MAX,
                                       dtype=torch.int32, device=keys.device)
                self._lut.scatter_reduce_(
                    0, keys, torch.arange(n, dtype=torch.int32,
                                          device=keys.device), "amin")
        if self._lut is None:
            self.layout = "complex_key_hashed" if self.key_is_string \
                else "hashed"
            self._sorted, perm = torch.sort(keys, stable=True)
            self._perm = perm.to(torch.int32)

    @property
    def n_rows(self) -> int:
        return self.table.n_rows

    def _remap_string_keys(self, ids, probe_dictionary) -> torch.Tensor:
        """Probe-side dictionary ids in the key column's id space."""
        if probe_dictionary is self.key_dictionary:
            return ids.to(torch.int64)
        remap = np.array([self.key_dictionary.index.get(v, -2)
                          for v in probe_dictionary.values] or [-2],
                         dtype=np.int64)
        return to_tensor(remap, ids.device)[
            torch.clamp(ids.long(), 0, len(remap) - 1)]

    def lookup(self, keys: torch.Tensor, probe_dictionary=None):
        """keys: (n,) tensor (string keys as probe-side dictionary ids).
        Returns (row (n,) int32, 0 where not found; found (n,) bool)."""
        if self.key_is_string:
            if probe_dictionary is None:
                raise ValueError(
                    f"dictionary {self.name!r} has a String key; got a "
                    f"numeric probe")
            keys = self._remap_string_keys(keys, probe_dictionary)
        keys = keys.to(torch.int64)
        if self.n_rows == 0:
            z = torch.zeros(keys.shape[0], dtype=torch.int32,
                            device=keys.device)
            return z, torch.zeros(keys.shape[0], dtype=torch.bool,
                                  device=keys.device)
        if self._lut is not None:
            idx = torch.clamp(keys, 0, self._lut.shape[0] - 1)
            row = self._lut[idx]
            found = (row != INT32_MAX) & (keys == idx)
            return torch.where(found, row, 0), found
        pos = torch.clamp(torch.searchsorted(self._sorted, keys), max=
                          self._sorted.shape[0] - 1)
        found = self._sorted[pos] == keys
        return torch.where(found, self._perm[pos], 0), found

    def attribute(self, attr: str):
        if attr not in self.table:
            raise ValueError(f"dictionary {self.name!r} has no attribute "
                             f"{attr!r} (have {self.table.column_names})")
        return self.table[attr]
