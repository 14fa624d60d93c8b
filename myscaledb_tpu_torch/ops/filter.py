"""Selection: the port of myscaledb_tpu/ops/filter.py
(``compact_table_host``).

Predicates stay boolean masks through the fused operators (the vector scan
takes the mask itself); a table is compacted only where a later operator
needs dense rows.
"""

from __future__ import annotations

import torch


def compact_table_host(table, mask: torch.Tensor):
    """Gather the rows where ``mask`` is true.  Reads the count back to the
    host (one synchronisation).  Returns (table, count)."""
    idx = torch.nonzero(mask.bool(), as_tuple=False).reshape(-1)
    cnt = int(idx.shape[0])
    out = table.take(idx) if cnt else table.head(0)
    return out, cnt
