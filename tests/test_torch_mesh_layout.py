"""The storage layout of a distributed table and the mesh over several
devices (parallel/mesh.py, parallel/dist_table.py).

Every distributed column holds one tensor per shard on ``mesh.device(p)``,
whether or not two shards share a device; no global tensor stays behind
the parts.  The CPU box has one device that holds tensors, so these tests
show the placement and the storage on it; the copies between distinct
cards run only on a machine with two or more (``tests/test_torch_cuda.py``
``-k multi_card``)."""

import numpy as np
import pytest
import torch

import myscaledb_tpu_torch
from myscaledb_tpu_torch.core.table import Table
from myscaledb_tpu_torch.parallel.dist_table import (ROW_VALID,
                                                     distribute_table,
                                                     gather_table,
                                                     take_rows)
from myscaledb_tpu_torch.parallel.mesh import (Mesh, RowSplit, all_to_all,
                                               make_mesh, ppermute,
                                               row_slices, shard_rows)

torch.set_num_threads(1)


def _table(n=37, seed=0):
    rng = np.random.default_rng(seed)
    return {"id": np.arange(n, dtype=np.int64),
            "v": rng.integers(-9, 9, n).astype(np.int32),
            "s": rng.choice(["a", "bb", "c"], n),
            "emb": rng.standard_normal((n, 8)).astype(np.float32)}


def _storages(table) -> list:
    out = []
    for c in table.columns.values():
        for part in (c.data.parts + ([] if c.valid is None
                                     else c.valid.parts)):
            out.append(part.untyped_storage().data_ptr())
    return out


@pytest.mark.parametrize("nsh", [1, 4, 8])
def test_every_column_is_one_tensor_per_shard(nsh):
    s = myscaledb_tpu_torch.connect(device="cpu")
    s.create_table("t", _table())
    s.sql("CREATE TABLE u (id Int64, x Nullable(Int32)) "
          "ENGINE = MergeTree ORDER BY id")
    s.sql("INSERT INTO u VALUES (1, NULL), (2, 5), (3, 7)")
    mesh = make_mesh(nsh, device="cpu")
    src = [c.data.untyped_storage().data_ptr()
           for c in s.tables["t"].columns.values()]
    for name in ("t", "u"):
        t = s.distribute(name, mesh)
        n_loc = t.n_rows // nsh
        assert t.n_rows % nsh == 0 and ROW_VALID in t
        for c in t.columns.values():
            for split in (c.data, c.valid):
                if split is None:
                    continue
                assert isinstance(split, RowSplit)
                assert len(split.parts) == nsh
                for p, part in enumerate(split.parts):
                    assert part.device == mesh.device(p)
                    assert part.shape[0] == n_loc
                    assert part.is_contiguous()
        # no part shares storage with another part or with the source
        st = _storages(t)
        assert len(set(st)) == len(st)
        if name == "t":
            assert not set(st) & set(src)
    # an INSERT grows each shard's part where it is
    s.sql("INSERT INTO u VALUES (4, 1), (5, NULL)")
    t = s.tables["u"]
    st = _storages(t)
    assert len(set(st)) == len(st)
    assert all(part.device == mesh.device(p)
               for c in t.columns.values()
               for p, part in enumerate(c.data.parts))
    assert s.sql("SELECT id, x FROM u ORDER BY id").to_rows() == \
        [(1, None), (2, 5), (3, 7), (4, 1), (5, None)]


def test_gather_and_take_rows_follow_the_global_order():
    mesh = make_mesh(4, device="cpu")
    plain = Table.from_dict(_table(), device="cpu")
    t = distribute_table(plain, mesh)
    g = gather_table(t)
    assert ROW_VALID not in g
    for name in ("id", "v", "s", "emb"):
        assert g[name].to_python() == plain[name].to_python()
    masks = [p.remainder(2) == 0 for p in t["id"].data.parts]
    assert g.n_rows == 37
    assert gather_table(t, masks, names={"id"})["id"].to_python() == \
        list(range(0, 37, 2))
    assert take_rows(t, [30, 2, 17])["id"].to_python() == [30, 2, 17]


def test_mesh_over_distinct_devices_is_taken():
    """A mesh over two distinct devices no longer raises ``NotPortedError``.
    The CPU box has no second card: "meta" stands for one, which shows the
    placement the mesh records; the copies between two real cards run on
    the card machine only (``test_torch_cuda.py -k multi_card``)."""
    m = Mesh(["cpu", "meta", "cpu"])
    assert m.size == 3 and m.n_cards == 2
    assert [str(d) for d in m.devices] == ["cpu", "meta", "cpu"]
    assert make_mesh(5, device="cpu").n_cards == 1
    # the collectives move each shard's tensor to its own device
    xs = [torch.arange(6) + 10 * p for p in range(3)]
    got = all_to_all(xs)
    assert torch.equal(got[1], torch.tensor([2, 3, 12, 13, 22, 23]))
    assert torch.equal(ppermute(xs, [(0, 2)])[2], xs[0])
    split = shard_rows(make_mesh(3, device="cpu"), torch.arange(9))
    assert row_slices(make_mesh(3, device="cpu"), split) == split.parts
    assert np.asarray(split).tolist() == list(range(9))


def test_mesh_over_a_missing_card_raises():
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="no device"):
        Mesh([f"cuda:{n}"])


def test_row_split_from_jax_shards():
    """A JAX row-sharded array's per-device shards become the port's
    parts, and the port's sharded top-k over them gives the JAX ids."""
    import jax.numpy as jnp
    from myscaledb_tpu.parallel.mesh import make_mesh as j_mesh, \
        shard_rows as j_shard
    from myscaledb_tpu.parallel.ops import sharded_distance_topk as j_topk
    from myscaledb_tpu_torch.interop import row_split_from_numpy
    from myscaledb_tpu_torch.parallel.ops import sharded_distance_topk
    rng = np.random.default_rng(4)
    x = rng.standard_normal((8 * 64, 16)).astype(np.float32)
    q = rng.standard_normal((3, 16)).astype(np.float32)
    jm = j_mesh(8)
    jx = j_shard(jm, jnp.asarray(x))
    shards = sorted(jx.addressable_shards, key=lambda sh: sh.index[0].start)
    mesh = make_mesh(8, device="cpu")
    xs = row_split_from_numpy([np.asarray(sh.data) for sh in shards], mesh)
    assert [p.shape[0] for p in xs.parts] == [64] * 8
    np.testing.assert_array_equal(np.asarray(xs), x)
    _jd, ji = j_topk(jm, jx, jnp.asarray(q), "L2", 7)
    _pd, pi = sharded_distance_topk(mesh, xs, torch.as_tensor(q), "L2", 7)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))


@pytest.mark.parametrize("stmt,check,jax_dist", [
    ("DELETE FROM t WHERE id < 5", "SELECT count(), sum(v) FROM t",
     [(32, 1312)]),
    ("ALTER TABLE t UPDATE v = v * 10 WHERE id % 3 = 0",
     "SELECT count(), sum(v), sum(id) FROM t", [(40, 5544, 666)]),
    ("ALTER TABLE t ADD COLUMN w Int32 DEFAULT 7",
     "SELECT sum(w), count() FROM t", [(280, 40)]),
    ("ALTER TABLE t DROP COLUMN v", "SELECT count(), sum(id) FROM t",
     [(40, 666)]),
    ("TRUNCATE TABLE t", "SELECT count() FROM t", [(0,)]),
])
def test_rewrites_keep_a_table_distributed(stmt, check, jax_dist):
    """DELETE, ALTER UPDATE/ADD/DROP COLUMN and TRUNCATE on a table
    distributed over 8 shards (37 rows, 3 of padding).  The port runs
    them on the gathered real rows and leaves the table distributed over
    its mesh, with the undistributed table's answers, which are the JAX
    package's.  The JAX package, on its 8 virtual devices, leaves the
    table undistributed with ``__row_valid__`` as a plain column and its
    padding rows counted as real ones (``jax_dist``: 40 rows where 37
    are), a fault of the reference that the port repairs (ROADMAP
    section 3)."""
    import myscaledb_tpu
    from myscaledb_tpu.parallel.dist_table import is_distributed as j_dist
    from myscaledb_tpu.parallel.mesh import make_mesh as j_mesh
    out, jout = [], []
    for mesh in (None, make_mesh(8, device="cpu")):
        s = myscaledb_tpu_torch.connect(device="cpu")
        j = myscaledb_tpu.connect()
        for x in (s, j):
            x.sql("CREATE TABLE t (id Int64, v Int64) "
                  "ENGINE = MergeTree ORDER BY id")
            x.sql("INSERT INTO t SELECT number, number * 2 FROM numbers(37)")
        if mesh is not None:
            s.distribute("t", mesh)
            j.distribute("t", j_mesh(8))
        s.sql(stmt)
        j.sql(stmt)
        if mesh is not None:
            t = s.tables["t"]
            assert t.mesh is mesh
            assert all(isinstance(c.data, RowSplit)
                       for c in t.columns.values())
            assert not j_dist(j.tables["t"])
            assert ROW_VALID in j.tables["t"].column_names
        out.append(s.sql(check).to_rows())
        jout.append(j.sql(check).to_rows())
    assert out[0] == out[1] == jout[0]
    assert jout[1] == jax_dist
