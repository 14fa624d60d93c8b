"""myscaledb_tpu_torch: the PyTorch/CUDA port of myscaledb_tpu.

Same module layout as the JAX package; columns are torch tensors on the
session's device (the CUDA card by default), and the TPU kernels on the
ported paths are CUDA kernels written for Hopper (``csrc/``).  This package
never imports jax or myscaledb_tpu.  It runs everything the JAX package
runs on one device, distribution included (``parallel/``: a table's rows
split over a mesh of logical shards); ``NotPortedError`` remains for a
mesh over several cards and for one statement kept out on purpose
(ROADMAP.md, section 3).
"""

from myscaledb_tpu_torch.core.types import DataType
from myscaledb_tpu_torch.core.table import Table, Column
from myscaledb_tpu_torch.errors import ExecError, NotPortedError
from myscaledb_tpu_torch.session import Session, connect

__version__ = "0.1.0"

__all__ = ["DataType", "Table", "Column", "ExecError", "NotPortedError",
           "__version__",
           "Session", "connect"]
