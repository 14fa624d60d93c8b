"""Table parity: the same host data through myscaledb_tpu.core.table and
myscaledb_tpu_torch.core.table (on the CPU) decodes to the same rows."""

import numpy as np
import pytest
import torch

from myscaledb_tpu.core.table import Table as JTable
from myscaledb_tpu.core.types import DataType as JDataType
from myscaledb_tpu_torch.core.table import Table as PTable, Column
from myscaledb_tpu_torch.core.types import DataType as PDataType
from myscaledb_tpu_torch.interop import table_from_numpy

torch.set_num_threads(1)


def _columns(rng, n=37):
    return {
        "i8": rng.integers(-128, 128, n).astype(np.int8),
        "i16": rng.integers(-2 ** 15, 2 ** 15, n).astype(np.int16),
        "i32": rng.integers(-2 ** 31, 2 ** 31, n).astype(np.int32),
        "i64": rng.integers(-2 ** 62, 2 ** 62, n).astype(np.int64),
        "u8": rng.integers(0, 256, n).astype(np.uint8),
        "u16": rng.integers(0, 2 ** 16, n).astype(np.uint16),
        "u32": rng.integers(0, 2 ** 32, n).astype(np.uint32),
        "u64": rng.integers(0, 2 ** 62, n).astype(np.uint64),
        "f32": rng.standard_normal(n).astype(np.float32),
        "f64": rng.standard_normal(n),
        "b": rng.random(n) < 0.5,
        "s": [f"w{int(v)}" for v in rng.integers(0, 5, n)],
        "ns": [None if v == 0 else f"n{int(v)}"
               for v in rng.integers(0, 4, n)],
        "day": (np.datetime64("2024-01-01")
                + rng.integers(0, 900, n).astype("timedelta64[D]")),
        "ts": (np.datetime64("2024-01-01T00:00:00")
               + rng.integers(0, 10 ** 8, n).astype("timedelta64[s]")),
        "emb": rng.standard_normal((n, 5)).astype(np.float32),
        "arr": [list(range(int(v))) for v in rng.integers(0, 4, n)],
    }


def test_from_dict_to_rows_parity(rng):
    data = _columns(rng)
    jt = JTable.from_dict(data)
    pt = PTable.from_dict(data, device="cpu")
    assert [str(f) for f in pt.schema()] == [str(f) for f in jt.schema()]
    assert pt.to_rows() == jt.to_rows()
    assert table_from_numpy(data, "cpu").to_rows() == jt.to_rows()


def test_widened_unsigned_storage_round_trips(rng):
    data = _columns(rng)
    pt = PTable.from_dict(data, device="cpu")
    assert pt["u32"].data.dtype == torch.int64
    assert pt["u16"].data.dtype == torch.int32
    for name in ("u16", "u32", "u64"):
        np.testing.assert_array_equal(pt[name].to_numpy(), data[name])
        assert pt[name].to_numpy().dtype == data[name].dtype


@pytest.mark.parametrize("idx", [[3, 0, 7, 7], [], [36]])
def test_take_head_select_parity(rng, idx):
    data = _columns(rng)
    jt = JTable.from_dict(data)
    pt = PTable.from_dict(data, device="cpu")
    import jax.numpy as jnp
    j_idx = jnp.asarray(np.asarray(idx, dtype=np.int32))
    assert pt.take(torch.as_tensor(idx, dtype=torch.int64)).to_rows() == \
        jt.take(j_idx).to_rows()
    assert pt.head(5).to_rows() == jt.head(5).to_rows()
    assert pt.select(["s", "emb"]).to_rows() == \
        jt.select(["s", "emb"]).to_rows()


def test_explicit_dtypes_and_with_column(rng):
    data = {"a": np.arange(6, dtype=np.int64), "v": rng.standard_normal(6)}
    dtypes_p = {"a": PDataType.INT32}
    dtypes_j = {"a": JDataType.INT32}
    jt = JTable.from_dict(data, dtypes=dtypes_j)
    pt = PTable.from_dict(data, dtypes=dtypes_p, device="cpu")
    assert pt["a"].data.dtype == torch.int32
    assert pt.to_rows() == jt.to_rows()
    extra = Column.from_numpy("c", ["x", "y", "x", None, "z", "y"],
                              device="cpu")
    assert pt.with_column(extra).to_pydict()["c"] == \
        ["x", "y", "x", None, "z", "y"]


def test_host_resident_column_stays_numpy(rng):
    data = {"id": np.arange(8, dtype=np.int64),
            "emb": rng.standard_normal((8, 4)).astype(np.float32)}
    pt = PTable.from_dict(data, hbm_budget_bytes=100, device="cpu")
    assert pt["emb"].is_host and not pt["id"].is_host
    got = pt.take(torch.tensor([2, 5]))
    assert not got["emb"].is_host
    np.testing.assert_array_equal(got["emb"].to_numpy(), data["emb"][[2, 5]])
