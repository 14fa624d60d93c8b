"""Carry state across from host arrays: a database's "weights" are its
tables and their derived state.

``table_from_numpy`` builds this package's Table from the same column dict
that the JAX package's ``Table.from_dict`` takes; ``sq8_sidecar_from_numpy``
turns the arrays the JAX ``build_sq8`` returns (after ``np.asarray``) into
this package's (x8, sides) sidecar, so both packages can scan one sidecar.
"""

from __future__ import annotations

import numpy as np
import torch

from myscaledb_tpu_torch.core.table import Table
from myscaledb_tpu_torch.ops.kernels.distance_q import SEG


def table_from_numpy(columns: dict, device, dtypes=None) -> Table:
    """Table on ``device`` from {name: numpy array or list}; ``dtypes``
    optionally maps names to DataType."""
    return Table.from_dict(columns, dtypes=dtypes, device=device)


def sq8_sidecar_from_numpy(x8: np.ndarray, sides: np.ndarray, device):
    """(x8 (n_pad, d) int8, sides (4, n_pad) f32) numpy arrays -> tensors
    on ``device``, after checking the sidecar layout."""
    x8 = np.asarray(x8)
    sides = np.asarray(sides)
    if x8.dtype != np.int8 or x8.ndim != 2:
        raise ValueError(f"x8 must be (n_pad, d) int8, got {x8.dtype} "
                         f"{x8.shape}")
    if x8.shape[0] % SEG != 0:
        raise ValueError(f"x8 has {x8.shape[0]} rows, not a multiple of "
                         f"{SEG}")
    if sides.dtype != np.float32 or sides.shape != (4, x8.shape[0]):
        raise ValueError(f"sides must be (4, {x8.shape[0]}) float32, got "
                         f"{sides.dtype} {sides.shape}")
    # copies: arrays from the JAX package are read-only
    return (torch.from_numpy(np.array(x8, order="C")).to(device),
            torch.from_numpy(np.array(sides, order="C")).to(device))
