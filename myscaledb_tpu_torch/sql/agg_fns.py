"""Aggregation helpers: the port of the part of myscaledb_tpu/sql/agg_fns.py
that the plain aggregates need (``_column_range``).  The special aggregates
(``_special_aggregate``: uniqExact, quantiles, argMin, ...) and the
-State/-Merge combinators (``_state_combinator``) come with the expression
and function breadth slice."""

from __future__ import annotations

import numpy as np

from myscaledb_tpu_torch.sql.ast import Ident


def _column_range(expr, table):
    """(min, max) bounds for a bare integer column reference, from its zone
    map (built at INSERT) — the JAX package's group-aggregate kernel picks
    its single-limb path with them; K3 accepts and ignores them."""
    if not isinstance(expr, Ident):
        return None
    if expr.name not in table:
        return None
    zm = table[expr.name].zonemap
    if zm is None or not len(zm.mins):
        return None
    if not np.issubdtype(np.asarray(zm.mins).dtype, np.integer):
        return None
    return (int(zm.mins.min()), int(zm.maxs.max()))
