"""Copy of myscaledb_tpu/core/types.py (JAX-free; imports renamed to this package).

Logical column types and their physical (device) representations.

The reference models types as IDataType objects with per-type serializations
(reference: src/DataTypes/).  On TPU we keep the menu small and fixed-width:
every column that crosses into HBM is a dense numeric array.  Strings are
dictionary-encoded to int32 ids on the host (the reference's LowCardinality,
src/Columns/ColumnLowCardinality.h) so only fixed-width data reaches the chip.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np


class DataType(enum.Enum):
    INT8 = "Int8"
    INT16 = "Int16"
    INT32 = "Int32"
    INT64 = "Int64"
    UINT8 = "UInt8"
    UINT16 = "UInt16"
    UINT32 = "UInt32"
    UINT64 = "UInt64"
    FLOAT32 = "Float32"
    FLOAT64 = "Float64"        # stored f64 on host, computed as f32 on TPU
    BOOL = "Bool"
    STRING = "String"          # dictionary-encoded -> int32 ids
    DATE = "Date"              # days since epoch, uint16 like the reference
    DATETIME = "DateTime"      # seconds since epoch, uint32
    # Fixed-dimension embedding column: Array(Float32) with constant size,
    # the only array shape the vector-search path needs
    # (reference: vector columns are Array(Float32) checked for fixed dim).
    FLOAT32_VECTOR = "Array(Float32)"
    # Variable-length array column: flat element array + row offsets — the
    # reference's ColumnArray layout (src/Columns/ColumnArray.h: nested
    # column + offsets), which is exactly the TPU-friendly shape (segment
    # ops over the flat data).
    ARRAY = "Array"

    @property
    def is_string(self) -> bool:
        return self is DataType.STRING

    @property
    def is_vector(self) -> bool:
        return self is DataType.FLOAT32_VECTOR

    @property
    def is_array(self) -> bool:
        return self is DataType.ARRAY

    @property
    def is_numeric(self) -> bool:
        return self not in (DataType.STRING, DataType.FLOAT32_VECTOR,
                            DataType.ARRAY)

    @property
    def is_float(self) -> bool:
        return self in (DataType.FLOAT32, DataType.FLOAT64)

    @property
    def is_integer(self) -> bool:
        return self.is_numeric and not self.is_float and self is not DataType.BOOL


# logical -> numpy/device dtype of the physical column array
_PHYSICAL = {
    DataType.INT8: np.int8,
    DataType.INT16: np.int16,
    DataType.INT32: np.int32,
    DataType.INT64: np.int64,
    DataType.UINT8: np.uint8,
    DataType.UINT16: np.uint16,
    DataType.UINT32: np.uint32,
    DataType.UINT64: np.uint64,
    DataType.FLOAT32: np.float32,
    DataType.FLOAT64: np.float64,
    DataType.BOOL: np.bool_,
    DataType.STRING: np.int32,          # dictionary ids
    DataType.DATE: np.int32,
    DataType.DATETIME: np.int64,
    DataType.FLOAT32_VECTOR: np.float32,
}

_FROM_NAME = {t.value: t for t in DataType}
# ClickHouse-compatible aliases (incl. the case-insensitive SQL-standard
# names ClickHouse registers: src/DataTypes/DataTypesNumber.cpp aliases)
_FROM_NAME.update({
    "Float": DataType.FLOAT32,
    "Double": DataType.FLOAT64,
    "Boolean": DataType.BOOL,
})
_SQL_ALIASES = {
    "int": DataType.INT32, "integer": DataType.INT32,
    "tinyint": DataType.INT8, "smallint": DataType.INT16,
    "bigint": DataType.INT64, "float": DataType.FLOAT32,
    "real": DataType.FLOAT32, "double": DataType.FLOAT64,
    "varchar": DataType.STRING, "char": DataType.STRING,
    "text": DataType.STRING, "blob": DataType.STRING,
    "bool": DataType.BOOL, "boolean": DataType.BOOL,
}


def physical_dtype(t: DataType) -> np.dtype:
    return np.dtype(_PHYSICAL[t])


def type_from_name(name: str) -> DataType:
    name = name.strip()
    if name in _FROM_NAME:
        return _FROM_NAME[name]
    if name.lower() in _SQL_ALIASES:
        return _SQL_ALIASES[name.lower()]
    raise ValueError(f"unknown type name: {name!r}")


def infer_type(arr: np.ndarray) -> DataType:
    """Infer a logical type from a numpy array (host-side ingest)."""
    if arr.ndim == 2 and np.issubdtype(arr.dtype, np.floating):
        return DataType.FLOAT32_VECTOR
    if arr.dtype.kind in ("U", "S", "O"):
        return DataType.STRING
    for t, d in _PHYSICAL.items():
        if t in (DataType.STRING, DataType.DATE, DataType.DATETIME,
                 DataType.FLOAT32_VECTOR):
            continue
        if arr.dtype == np.dtype(d):
            return t
    raise ValueError(f"cannot infer column type for dtype {arr.dtype}")


@dataclass(frozen=True)
class Field:
    """One column of a table schema."""
    name: str
    dtype: DataType
    nullable: bool = False
    vector_dim: int = 0   # for FLOAT32_VECTOR
    elem: "Optional[DataType]" = None   # element type for ARRAY
    # FixedString(N) byte width (0 = not fixed).  A FixedString column is
    # the reference's BINARY VECTOR carrier: distance()/batch_distance()
    # over it dispatches to Hamming/Jaccard XOR+popcount scans
    # (src/VectorIndex/Utils/VIUtils.cpp:666 — BinaryVector requires
    # FixedString; dim = 8 * N bits).
    fixed_len: int = 0

    def __str__(self) -> str:
        base = self.dtype.value
        if self.dtype.is_vector:
            base = f"Array(Float32, {self.vector_dim})"
        elif self.dtype is DataType.ARRAY:
            base = f"Array({self.elem.value if self.elem else '?'})"
        elif self.fixed_len:
            base = f"FixedString({self.fixed_len})"
        return f"{self.name} {'Nullable(' + base + ')' if self.nullable else base}"


# -- torch storage (the port's addition to the copied module) ---------------

import torch  # noqa: E402

# numpy dtype -> torch dtype, for the dtypes torch computes on everywhere
NUMPY_TO_TORCH = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}
TORCH_TO_NUMPY = {v: k for k, v in NUMPY_TO_TORCH.items()}

# torch has no comparison or arithmetic on uint16/uint32/uint64 tensors
# (ROADMAP queue 1 item 1), so those logical types are stored widened to
# the next signed type; UINT64 values must fit int64.  Column.to_numpy
# casts back to physical_dtype(), so values and formatting are unchanged.
_WIDENED = {np.dtype(np.uint16): np.dtype(np.int32),
            np.dtype(np.uint32): np.dtype(np.int64),
            np.dtype(np.uint64): np.dtype(np.int64)}


def storage_numpy_dtype(np_dtype) -> np.dtype:
    """The numpy dtype a host array is converted to before it becomes a
    tensor (identity except for the widened unsigned types)."""
    d = np.dtype(np_dtype)
    return _WIDENED.get(d, d)


def torch_dtype(np_dtype) -> torch.dtype:
    """Torch dtype that stores values of the given numpy dtype."""
    return NUMPY_TO_TORCH[storage_numpy_dtype(np_dtype)]
