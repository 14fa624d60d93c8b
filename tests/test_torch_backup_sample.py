"""SAMPLE and backup/restore on the CPU, the port against the JAX package:
the SAMPLE half of tests/test_fill_sample.py (the rows kept are the JAX
package's, the row-id hash compared in int64 so nothing wraps) and
tests/test_storage.py::test_session_backup_restore (a backup either
package writes restores in the other, with table settings and
vector-index registrations, and a restored vector table answers a top-k
as before)."""

import numpy as np
import pytest
import torch

import myscaledb_tpu
import myscaledb_tpu_torch
from myscaledb_tpu.config import TableSettings as JTS
from myscaledb_tpu_torch.config import TableSettings as PTS


def _both():
    return (myscaledb_tpu.connect(),
            myscaledb_tpu_torch.connect(device="cpu"))


@pytest.fixture(scope="module")
def sampled():
    out = []
    for s in _both():
        s.create_table("big", {"x": np.arange(100000, dtype=np.int64),
                               "g": np.arange(100000, dtype=np.int64) % 7})
        s.create_table("m", {"t": np.array([1, 3, 4, 7], dtype=np.int64)})
        s.sql("CREATE TABLE e (a Int64) ENGINE = Memory")
        out.append(s)
    return out


@pytest.mark.parametrize("sql", [
    "SELECT count() FROM big SAMPLE 0.1",
    "SELECT x FROM big SAMPLE 0.001 ORDER BY x",
    "SELECT count() FROM big SAMPLE 5000",
    "SELECT count() FROM big SAMPLE 1",
    "SELECT count() FROM big SAMPLE 0",
    "SELECT g, count(), sum(x) FROM big SAMPLE 0.25 WHERE x % 3 = 1 "
    "GROUP BY g ORDER BY g",
    "SELECT x FROM big SAMPLE 0.5 LIMIT 5",
    "SELECT count() FROM m FINAL SAMPLE 1",
    "SELECT t FROM m SAMPLE 0.5",
    "SELECT count() FROM e SAMPLE 0.5",
])
def test_sample_rows_are_the_jax_packages(sampled, sql):
    j, p = sampled
    assert p.sql(sql).to_rows() == j.sql(sql).to_rows()


def test_sample_is_deterministic_and_near_its_fraction(sampled):
    _, p = sampled
    n = p.sql("SELECT count() FROM big SAMPLE 0.1").to_rows()[0][0]
    assert 8000 < n < 12000
    assert p.sql("SELECT count() FROM big SAMPLE 0.1").to_rows()[0][0] == n


def test_sample_mask_compares_in_int64():
    """The threshold int(f x (2^32 - 1)) is compared with the uint32 hash
    held in int64: at f = 1 every row but one whose hash is 2^32 - 1 is
    kept, and nothing wraps negative."""
    from myscaledb_tpu_torch.ops.hash import hash32
    from myscaledb_tpu_torch.sql.executor import sample_mask
    n = 1 << 16
    h = hash32(torch.arange(n, dtype=torch.int64))
    assert int(h.min()) >= 0 and int(h.max()) <= 0xFFFFFFFF
    assert torch.equal(sample_mask(n, 1.0, "cpu"), h < 0xFFFFFFFF)
    assert torch.equal(sample_mask(n, 0.5, "cpu"),
                       h < int(0.5 * 0xFFFFFFFF))


def _fill(s, ts_cls, rng_seed=0):
    rng = np.random.default_rng(rng_seed)
    s.create_table("a", {"x": np.arange(50, dtype=np.int64),
                         "s": [f"v{i % 5}" for i in range(50)]})
    s.create_table("b", {"emb": rng.standard_normal((20, 4))
                         .astype(np.float32),
                         "id": np.arange(20, dtype=np.int64)},
                   settings=ts_cls(float_vector_search_metric_type="IP"))
    s.sql("ALTER TABLE b ADD VECTOR INDEX v1 emb TYPE MSTG")


CHECKS = ["SELECT s, sum(x) FROM a GROUP BY s ORDER BY s",
          "SELECT count(*) FROM system.vector_indices",
          "SELECT name, status FROM system.vector_indices",
          "SELECT id, distance(emb, [0.5, -1.0, 0.25, 2.0]) AS d FROM b "
          "ORDER BY d DESC LIMIT 5"]


@pytest.mark.parametrize("writer,reader", [("j", "p"), ("p", "j"),
                                           ("p", "p")])
def test_backup_restores_across_packages(writer, reader, tmp_path):
    """test_session_backup_restore, with the backup written by one package
    and restored by the other: rows, the table setting, the index
    registration and a vector top-k (IP) as before the backup."""
    mk = {"j": (myscaledb_tpu.connect, JTS),
          "p": (lambda: myscaledb_tpu_torch.connect(device="cpu"), PTS)}
    src = mk[writer][0]()
    _fill(src, mk[writer][1])
    want = [src.sql_tsv(q) for q in CHECKS]
    manifest = src.backup(str(tmp_path / "bkp"))
    assert [t["name"] for t in manifest["tables"]] == ["a", "b"]
    dst = mk[reader][0]()
    assert sorted(dst.restore(str(tmp_path / "bkp"))) == ["a", "b"]
    assert dst.table_settings["b"].float_vector_search_metric_type == "IP"
    assert [dst.sql_tsv(q) for q in CHECKS] == want


def test_backup_bytes_are_the_jax_packages(tmp_path):
    """The same tables back up to the same manifest and part files (the
    part directories' random-free names and codecs)."""
    import os
    trees = []
    for tag, (s, ts) in zip("jp", ((myscaledb_tpu.connect(), JTS),
                                   (myscaledb_tpu_torch.connect(
                                       device="cpu"), PTS))):
        _fill(s, ts)
        s.backup(str(tmp_path / tag), ["a", "b"])
        files = {}
        for root, _, names in os.walk(tmp_path / tag):
            for n in names:
                full = os.path.join(root, n)
                rel = os.path.relpath(full, tmp_path / tag)
                if rel != "manifest.json":
                    files[rel] = open(full, "rb").read()
        trees.append(files)
    assert trees[0] == trees[1]


def test_backup_of_some_tables_and_restore_into_a_live_session(tmp_path):
    out = []
    for s in _both():
        _fill(s, JTS if isinstance(s, myscaledb_tpu.session.Session)
              else PTS)
        s.backup(str(tmp_path / type(s).__module__), ["a"])
        s.sql("INSERT INTO a VALUES (100, 'new')")
        s.restore(str(tmp_path / type(s).__module__))
        out.append([s.sql_tsv("SELECT count(), sum(x) FROM a"),
                    s.sql_tsv("SELECT count() FROM b")])
    assert out[0] == out[1]
