"""Distributed text and hybrid search, the port against the JAX package,
after tests/test_distributed_hybrid.py and the distributed case of
tests/test_text_search.py: per-shard BM25 under global statistics
(text/distributed.py) and per-shard vector top-k, merged at the
initiator.  Rows and BM25 scores bit-identical to the JAX package's and
to the same table undistributed; BM25 indexes with ``doc_valid`` and
scores under ``global_stats`` bit-equal to the JAX package's."""

import numpy as np
import pytest
import torch

import myscaledb_tpu
import myscaledb_tpu_torch
from myscaledb_tpu.parallel.mesh import make_mesh as j_mesh
from myscaledb_tpu.text import bm25 as jbm25
from myscaledb_tpu.text import distributed as jdist

from myscaledb_tpu_torch.parallel.mesh import make_mesh
from myscaledb_tpu_torch.text import bm25 as pbm25
from myscaledb_tpu_torch.text import distributed as pdist

torch.set_num_threads(1)

TEXT_Q = ("SELECT id, TextSearch(doc, 'quick fox jumps') AS sc FROM t "
          "ORDER BY sc DESC LIMIT 7")
HYB_RSF = ("SELECT id, HybridSearch('fusion_type=RSF')"
           "(v, doc, [0.1,0.2,0.3,0.4,0.5,0.6,0.7,0.8], 'lazy dog') AS sc "
           "FROM t ORDER BY sc DESC LIMIT 7")
HYB_RRF = ("SELECT id, HybridSearch('fusion_type=RRF')"
           "(v, doc, [0.1,0.2,0.3,0.4,0.5,0.6,0.7,0.8], 'lazy dog') AS sc "
           "FROM t ORDER BY sc DESC LIMIT 7")
FILTERED = ("SELECT id, TextSearch(doc, 'quick fox') AS sc FROM t "
            "WHERE id % 2 = 0 ORDER BY sc DESC LIMIT 5")
AND_Q = ("SELECT id, TextSearch('operator=AND')(doc, 'quick fox') AS sc "
         "FROM t ORDER BY sc DESC LIMIT 5")
SCORES = ("SELECT id, TextSearch(doc, 'lazy brown dog') AS sc FROM t "
          "ORDER BY id LIMIT 30")


def _data():
    rng = np.random.default_rng(7)
    n = 100
    words = ["fox", "dog", "cat", "jumps", "sleeps", "runs", "quick",
             "lazy", "brown", "spotted"]
    docs = [" ".join(rng.choice(words, size=rng.integers(3, 9)))
            for _ in range(n)]
    return {"id": np.arange(n, dtype=np.int64), "doc": np.array(docs),
            "v": rng.normal(size=(n, 8)).astype(np.float32)}


@pytest.fixture(scope="module")
def sessions():
    """(JAX undistributed, JAX distributed over 8 shards, port
    undistributed, port distributed over 8 shards)."""
    data = _data()
    out = []
    for pkg, mesh in ((myscaledb_tpu, None), (myscaledb_tpu, j_mesh(8)),
                      (myscaledb_tpu_torch, None),
                      (myscaledb_tpu_torch, make_mesh(8, device="cpu"))):
        s = pkg.connect() if pkg is myscaledb_tpu else \
            pkg.connect(device="cpu")
        s.create_table("t", {k: v.copy() for k, v in data.items()})
        if mesh is not None:
            s.distribute("t", mesh)
        out.append(s)
    return out


@pytest.mark.parametrize("sql", [TEXT_Q, HYB_RSF, HYB_RRF, FILTERED, AND_Q,
                                 SCORES],
                         ids=["text", "hybrid-rsf", "hybrid-rrf", "filter",
                              "and", "score-column"])
def test_distributed_matches_bitexact(sessions, sql):
    jl, jd, pl, pd = sessions
    got = pd.sql(sql).to_rows()
    assert got == pl.sql(sql).to_rows()
    assert got == jl.sql(sql).to_rows()
    if sql is not SCORES:    # a score column: the JAX package's distributed
        assert got == jd.sql(sql).to_rows()   # top-n drops it and fails


def test_text_search_parity_203_rows():
    """The distributed case of tests/test_text_search.py: 203 rows (not a
    multiple of 8): padding rows must not skew the statistics."""
    rng = np.random.default_rng(0)
    n = 203
    words = ["alpha", "beta", "gamma", "delta", "fox", "wine"]
    docs = [" ".join(rng.choice(words, rng.integers(2, 6)))
            for _ in range(n)]
    data = {"id": np.arange(n, dtype=np.int64), "body": np.array(docs),
            "emb": rng.standard_normal((n, 8)).astype(np.float32)}
    jl = myscaledb_tpu.connect()
    jl.create_table("t", {k: v.copy() for k, v in data.items()})
    pd = myscaledb_tpu_torch.connect(device="cpu")
    pd.create_table("t", {k: v.copy() for k, v in data.items()})
    pd.distribute("t", make_mesh(8, device="cpu"))
    qv = ", ".join(["0.2"] * 8)
    for q in ["SELECT id, TextSearch(body, 'fox wine') AS s FROM t "
              "ORDER BY s DESC LIMIT 7",
              "SELECT id, TextSearch(body, 'alpha') AS s FROM t "
              "WHERE id % 2 = 0 ORDER BY s DESC LIMIT 5",
              f"SELECT id, HybridSearch('fusion_type=rsf')(emb, body, "
              f"[{qv}], 'fox wine') AS s FROM t ORDER BY s DESC LIMIT 6",
              f"SELECT id, HybridSearch('fusion_type=rrf')(emb, body, "
              f"[{qv}], 'beta gamma') AS s FROM t ORDER BY s DESC LIMIT 6",
              "SELECT term, doc_freq, total_term_freq, total_docs "
              "FROM ftsIndex(t, body, 'fox beta') ORDER BY term"]:
        assert pd.sql_tsv(q) == jl.sql_tsv(q), q


def test_shard_indexes_cached_and_stats_merged(sessions):
    _jl, jd, _pl, pd = sessions
    t = pd.tables["t"]
    shards = pdist._shard_indexes(pd, "t", t, "doc")
    assert len(shards) == 8
    assert pdist._shard_indexes(pd, "t", t, "doc") is shards
    stats = pdist.global_stats(shards, "quick fox")
    jstats = jdist.global_stats(jdist._shard_indexes(jd, jd.tables["t"],
                                                     "doc"), "quick fox")
    assert stats == jstats
    whole = pbm25.BM25Index(list(_data()["doc"]), device="cpu")
    assert stats["n_docs"] == 100
    assert stats["total_tokens"] == whole.total_tokens
    for term in ("quick", "fox"):
        assert stats["df"][term] == whole.term_df(term)
    # a change to the table: the next search builds the shards anew
    pd.sql("INSERT INTO t VALUES (100, 'quick quick fox', "
           "[0,0,0,0,0,0,0,0])")
    t2 = pd.tables["t"]
    assert pdist._shard_indexes(pd, "t", t2, "doc") is not shards


def test_bm25_doc_valid_and_global_stats_bit_equal():
    rng = np.random.default_rng(3)
    words = ["red", "fox", "wine", "sky", "blue", "jumps"]
    docs = [" ".join(rng.choice(words, rng.integers(0, 7)))
            for _ in range(64)]
    docs[5] = None
    valid = rng.random(64) < 0.8
    jix = [jbm25.BM25Index(docs[i:i + 16], doc_valid=valid[i:i + 16])
           for i in range(0, 64, 16)]
    pix = [pbm25.BM25Index(docs[i:i + 16], doc_valid=valid[i:i + 16],
                           device="cpu") for i in range(0, 64, 16)]
    for a, b in zip(pix, jix):
        assert (a.stat_docs, a.total_tokens) == (b.stat_docs, b.total_tokens)
        assert a.avg_len == b.avg_len
    for query, op in (("red fox", "OR"), ("wine sky blue", "OR"),
                      ("red fox", "AND"), ("nothing", "OR")):
        stats = jdist.global_stats(jix, query)
        assert pdist.global_stats(pix, query) == stats
        for a, b in zip(pix, jix):
            np.testing.assert_array_equal(
                a.scores(query, op, global_stats=stats).numpy(),
                np.asarray(b.scores(query, op, global_stats=stats)))
            np.testing.assert_array_equal(
                a.scores(query, op).numpy(), np.asarray(b.scores(query, op)))
