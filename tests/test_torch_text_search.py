"""Text and hybrid search on the CPU, against the JAX package: BM25
scores and top-k over seeded corpora (bit-equal), the RSF/RRF fusion
(bit-equal), the SQL cases of test_text_search.py but the distributed one,
ftsIndex(), and the divergences the port keeps (ROADMAP section 3)."""

import numpy as np
import pytest
import torch

import myscaledb_tpu
import myscaledb_tpu_torch
from myscaledb_tpu.text import bm25 as JB
from myscaledb_tpu.text import fusion as JF
from myscaledb_tpu_torch import interop
from myscaledb_tpu_torch.text import bm25 as PB
from myscaledb_tpu_torch.text import fusion as PF

torch.set_num_threads(1)

WORDS = ["alpha", "Beta", "gamma", "delta", "fox", "wine", "x1", "42",
         "red", "dog"]


def _corpus(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(n):
        w = rng.choice(WORDS, rng.integers(0, 12))
        docs.append(" ,".join(w) if i % 3 else "-".join(w) + "!")
    docs[1] = None
    docs[2] = ""
    docs[5] = docs[4]                       # equal docs: equal scores
    docs[6] = docs[4]
    return docs


def _bits(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32).view(np.int32)


QUERIES = ["fox wine", "fox fox FOX", "unknown words", "", "Beta, gamma 42",
           "x1 red dog alpha delta zzz", "dog"]


@pytest.fixture(scope="module")
def indexes():
    docs = _corpus(3, 400)
    return docs, JB.BM25Index(docs), PB.BM25Index(docs, device="cpu")


@pytest.mark.parametrize("operator", ["OR", "AND", "and"])
@pytest.mark.parametrize("query", QUERIES)
def test_bm25_scores_bit_equal(indexes, query, operator):
    _docs, j, p = indexes
    want = np.asarray(j.scores(query, operator))
    got = p.scores(query, operator).numpy()
    assert np.array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("k", [1, 7, 400, 1000])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("query,operator", [("fox wine", "OR"),
                                            ("dog red", "AND"),
                                            ("nothing", "OR")])
def test_bm25_search_equal(indexes, query, operator, k, masked):
    docs, j, p = indexes
    mask = None
    if masked:
        mask = np.random.default_rng(k).random(len(docs)) < 0.6
        mask[4] = mask[5] = True             # tied docs stay in
    js, ji = j.search(query, k, mask=mask, operator=operator)
    ps, pi = p.search(query, k, mask=mask, operator=operator)
    assert np.array_equal(pi.numpy(), np.asarray(ji))
    assert np.array_equal(_bits(ps.numpy()), _bits(js))


def test_bm25_ties_go_to_the_lower_doc_id():
    docs = ["fox"] * 5 + ["fox fox"] + ["fox"] * 3
    s, i = PB.BM25Index(docs, device="cpu").search("fox", 4)
    js, ji = JB.BM25Index(docs).search("fox", 4)
    assert i.tolist() == np.asarray(ji).tolist() == [5, 0, 1, 2]
    assert np.array_equal(_bits(s.numpy()), _bits(js))


def test_bm25_statistics_equal(indexes):
    docs, j, p = indexes
    assert p.stats() == j.stats()
    assert p.avg_len == j.avg_len
    assert np.array_equal(p.doc_len.numpy(), np.asarray(j.doc_len))
    for t in ["fox", "beta", "42", "zzz"]:
        assert p.term_df(t) == j.term_df(t)


def test_bm25_from_column_equals_from_list():
    """The index over a table's String column (values tokenized once,
    rows expanded by id; the dictionary holds a value no row uses) scores
    as the index over the decoded rows."""
    from myscaledb_tpu_torch.core.table import Column, Table
    docs = _corpus(8, 300)
    col = Column.from_numpy("body", np.array(["unused words"] + docs,
                                             dtype=object), device="cpu")
    t = Table([col]).take(torch.arange(1, 301))
    p = PB.BM25Index.from_column(t["body"], "cpu")
    j = JB.BM25Index(docs)
    for q in QUERIES:
        assert np.array_equal(_bits(p.scores(q).numpy()),
                              _bits(j.scores(q)))


def test_bm25_from_jax_state():
    docs = _corpus(11, 200)
    j = JB.BM25Index(docs)
    p = interop.bm25_index_from_jax_state(
        j.vocab, j._post_docs, j._post_tfs, j.df, np.asarray(j.doc_len),
        j.avg_len, j.stat_docs, j.total_tokens, device="cpu")
    for q in QUERIES:
        for op in ("OR", "AND"):
            assert np.array_equal(_bits(p.scores(q, op).numpy()),
                                  _bits(j.scores(q, op)))
    with pytest.raises(ValueError, match="df does not match"):
        interop.bm25_index_from_jax_state(
            j.vocab, j._post_docs, j._post_tfs, j.df + 1,
            np.asarray(j.doc_len), j.avg_len, j.stat_docs, j.total_tokens,
            device="cpu")


def test_bm25_distribution_is_not_ported():
    """(Named when the port refused these parameters.)  The distributed
    parameters score as the JAX package's: ``doc_valid`` keeps invalid
    docs out of the statistics and ``global_stats`` overrides them, bit for
    bit (tests/test_torch_distributed_hybrid.py holds them at full
    size)."""
    docs = ["a b", "b c", "c c a"]
    valid = [True, False, True]
    p = PB.BM25Index(docs, doc_valid=valid, device="cpu")
    j = JB.BM25Index(docs, doc_valid=valid)
    assert (p.stat_docs, p.total_tokens, p.avg_len) == \
        (j.stat_docs, j.total_tokens, j.avg_len)
    stats = {"n_docs": 7, "total_tokens": 20, "df": {"b": 3}}
    for q in ("b", "a c", "b c"):
        assert np.array_equal(_bits(p.scores(q).numpy()),
                              _bits(j.scores(q)))
        assert np.array_equal(
            _bits(p.scores(q, global_stats=stats).numpy()),
            _bits(j.scores(q, global_stats=stats)))



def test_bm25_mean_doc_len_past_2_24_tokens():
    """2^24 + 11 tokens (two docs of 8388609, one of 9): the port's index
    takes the exact token total over the doc count, rounded once
    (5592409.0); the JAX package's index takes numpy's f32 mean of the
    lengths, whose sum rounds (5592409.5), so its scores of the two long
    docs differ in the last bit.  The port scores as the JAX package's
    merged statistics do (``global_stats`` with the exact total), so a
    distributed table scores as the undistributed one (ROADMAP section
    3)."""
    long = 8388609
    docs = ["a" + " x" * (long - 1), "b" + " x" * (long - 1),
            "a b c d e f g h i"]
    total = 2 * long + 9
    p = PB.BM25Index(docs, device="cpu")
    j = JB.BM25Index(docs)
    assert p.total_tokens == total
    assert p.avg_len == float(np.float32(total / 3)) == 5592409.0
    assert j.avg_len == 5592409.5
    merged = {"n_docs": 3, "total_tokens": total, "df": {}}
    for q in ("a", "b c"):
        ps = _bits(p.scores(q).numpy())
        assert np.array_equal(ps, _bits(j.scores(q, global_stats=merged)))
        assert np.array_equal(
            ps, _bits(p.scores(q, global_stats=merged).numpy()))
        differ = ps != _bits(j.scores(q))
        assert differ.tolist() == [q == "a", q == "b c", False]

def test_tokenize_equals():
    for s in ["The Quick, brown-fox!", "", None, "ÄbC déf 12x", "a_b"]:
        assert PB.tokenize(s) == JB.tokenize(s)
    assert (PB.K1, PB.B) == (JB.K1, JB.B)


# -- fusion ------------------------------------------------------------------

def _lists(seed: int, n: int, quantized: bool):
    rng = np.random.default_rng(seed)
    vids = rng.choice(3 * n, n, replace=False)
    tids = rng.choice(3 * n, n, replace=False)
    vd = rng.random(n).astype(np.float32)
    ts = (rng.random(n) * 9).astype(np.float32)
    if quantized:                   # many ties, and sums equal in f32 only
        vd = np.round(vd * 4) / 4
        ts = np.round(ts)
    return vids, np.sort(vd), tids, -np.sort(-ts)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("weight", [0.5, 0.3, 0.0, 1.0])
@pytest.mark.parametrize("descending", [False, True])
def test_rsf_bit_equal(seed, weight, descending):
    vids, vd, tids, ts = _lists(seed, 30, quantized=seed % 2 == 0)
    if seed == 4:
        vd[:] = vd[0]                            # min == max on one side
    want = JF.relative_score_fusion(vids, vd, tids, ts, weight=weight,
                                    vector_descending=descending)
    got = PF.relative_score_fusion(vids, vd, tids, ts, weight=weight,
                                   vector_descending=descending)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(_bits(got[1]), _bits(want[1]))


def test_rsf_orders_by_the_float64_sum():
    """Ids whose float64 sums differ in the last bits but round to one
    float32 keep the float64 order: id 7's sum is 0.5 + 2^-31, ids 3 and
    5 have 0.5, and all three print as 0.5 (sorting after the cast would
    put 7 last)."""
    a = 2.0 ** -10
    vids, vd = np.array([5, 7, 8]), np.array([0.0, a, 1.0], np.float32)
    tids = np.array([3, 7, 9])
    ts = np.array([1.0, a + 2.0 ** -30, 0.0], np.float32)
    want = JF.relative_score_fusion(vids, vd, tids, ts, weight=0.5)
    got = PF.relative_score_fusion(vids, vd, tids, ts, weight=0.5)
    assert got[0][:3].tolist() == [7, 3, 5]
    assert got[1][:3].tolist() == [0.5, 0.5, 0.5]
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(_bits(got[1]), _bits(want[1]))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("fusion_k", [60, 1])
def test_rrf_bit_equal(seed, fusion_k):
    vids, _vd, tids, _ts = _lists(seed, 25, quantized=False)
    lists = [vids, tids, vids[::-1][:7]] if seed == 3 else [vids, tids]
    want = JF.reciprocal_rank_fusion(lists, fusion_k)
    got = PF.reciprocal_rank_fusion(lists, fusion_k)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(_bits(got[1]), _bits(want[1]))


def test_fusion_of_empty_lists():
    for f in (JF, PF):
        ids, sc = f.relative_score_fusion([], [], [], [])
        assert len(ids) == len(sc) == 0
        ids, sc = f.reciprocal_rank_fusion([[], []])
        assert len(ids) == len(sc) == 0


# -- SQL through both connect()s --------------------------------------------

DOCS = [
    "the quick brown fox jumps over the lazy dog",
    "a quick brown cat",
    "the lazy dog sleeps",
    "foxes are quick and clever animals",
    "dogs and cats are pets",
    "",
]


@pytest.fixture(scope="module")
def sessions():
    rng = np.random.default_rng(0)
    n = len(DOCS)
    emb = np.eye(n, 4, dtype=np.float32) + \
        rng.standard_normal((n, 4)).astype(np.float32) * 0.01
    out = []
    for s in (myscaledb_tpu.connect(),
              myscaledb_tpu_torch.connect(device="cpu")):
        s.create_table("articles", {"id": np.arange(n, dtype=np.int64),
                                    "body": DOCS, "emb": emb.copy()})
        s.create_table("docs", {
            "id": np.arange(4, dtype=np.int64),
            "body": np.array(["red fox jumps", "red red wine", "blue sky",
                              "fox and fox again"])})
        crng = np.random.default_rng(12)
        m = 500
        s.create_table("c", {
            "id": np.arange(m, dtype=np.int64),
            "body": _corpus(12, m),
            "p": crng.integers(0, 100, m).astype(np.int32),
            "emb": crng.standard_normal((m, 8)).astype(np.float32)})
        s.sql("CREATE TABLE cip (id UInt32, body String, emb Array(Float32))"
              " ENGINE = MergeTree ORDER BY id SETTINGS "
              "float_vector_search_metric_type = 'IP'")
        s.sql("INSERT INTO cip SELECT id, body, emb FROM c")
        out.append(s)
    return tuple(out)


def _rows(s, sql):
    try:
        return repr(s.sql(sql).to_rows())
    except Exception as e:                  # noqa: BLE001 - texts compared
        return f"{type(e).__name__}: {e}"


QV = "[" + ", ".join(["0.25"] * 8) + "]"


@pytest.mark.parametrize("sql", [
    # the cases of test_text_search.py
    "SELECT id, TextSearch(body, 'quick dog') AS score FROM articles "
    "ORDER BY score DESC LIMIT 3",
    "SELECT id, TextSearch(body, 'quick') AS s FROM articles "
    "WHERE id > 1 ORDER BY s DESC LIMIT 5",
    "SELECT id, TextSearch(body, 'quick') AS s FROM articles ORDER BY id",
    "SELECT id, HybridSearch('fusion_type=rsf')(emb, body, [1., 0, 0, 0], "
    "'quick dog') AS score FROM articles ORDER BY score DESC LIMIT 4",
    "SELECT id, HybridSearch('fusion_type=rrf')(emb, body, [0., 1, 0, 0], "
    "'lazy dog') AS score FROM articles ORDER BY score DESC LIMIT 3",
    "SELECT HybridSearch('fusion_type=rsf')(emb, body, [1., 0, 0, 0], 'x') "
    "AS s FROM articles",
    "SELECT term, doc_freq, total_term_freq, total_docs FROM "
    "ftsIndex(docs, body, 'red fox green') ORDER BY term",
    # operator, offsets, post-search filters, larger tables
    "SELECT id, TextSearch('operator=AND')(body, 'quick dog') AS s "
    "FROM articles ORDER BY s DESC LIMIT 3",
    "SELECT id, TextSearch(body, 'fox wine alpha') AS s FROM c "
    "WHERE p < 50 ORDER BY s DESC LIMIT 8 OFFSET 2",
    "SELECT id, body, TextSearch(body, 'fox wine') AS s FROM c "
    "WHERE s > 1.5 ORDER BY s DESC LIMIT 10",
    "SELECT id, TextSearch('operator=AND')(body, 'dog red') FROM c "
    "ORDER BY TextSearch('operator=AND')(body, 'dog red') DESC LIMIT 6",
    f"SELECT id, HybridSearch('fusion_type=rsf')(emb, body, {QV}, "
    "'fox wine') AS s FROM c WHERE p < 50 ORDER BY s DESC LIMIT 6",
    f"SELECT id, HybridSearch('fusion_type=rrf')(emb, body, {QV}, "
    "'beta gamma') AS s FROM c ORDER BY s DESC LIMIT 7",
    f"SELECT id, HybridSearch('fusion_type=rsf, operator=AND')(emb, body, "
    f"{QV}, 'beta gamma') AS s FROM c ORDER BY s DESC LIMIT 5",
    f"SELECT id, HybridSearch('fusion_type=rsf')(emb, body, {QV}, "
    "'fox dog') AS s FROM cip ORDER BY s DESC LIMIT 6",
    "SELECT id, TextSearch(body, 'x1 42') AS s FROM c WHERE id < 40 "
    "AND p > 10 ORDER BY s DESC, id LIMIT 50",
    "SELECT term, doc_freq, total_term_freq, total_docs, total_tokens "
    "FROM ftsIndex(c, body, 'fox FOX wine nothing') ORDER BY term",
    "SELECT id, TextSearch(body, 'gamma') AS s FROM c "
    "WHERE id IN (1, 2, 3, 4, 5, 6) ORDER BY s DESC, id LIMIT 6",
    # errors
    "SELECT id, TextSearch(body) AS s FROM c ORDER BY s DESC LIMIT 3",
    "SELECT id, TextSearch(p, 'x') AS s FROM c ORDER BY s DESC LIMIT 3",
    "SELECT term FROM ftsIndex(nosuch, body, 'x')",
    "SELECT term FROM ftsIndex(c, nosuch, 'x')",
])
def test_sql_equal(sessions, sql):
    j, p = sessions
    assert _rows(p, sql) == _rows(j, sql)


def test_stale_index_after_delete_and_insert(sessions):
    """A fault of the reference, pinned (ROADMAP section 3): the JAX
    package keys its text index by the row count, so after a DELETE and
    an INSERT that keep it, TextSearch reads the old rows; the port's
    index follows the mutation epoch."""
    got = []
    for s in sessions:
        s.sql("CREATE TABLE d (id Int64, body String) ENGINE = MergeTree "
              "ORDER BY id")
        s.sql("INSERT INTO d VALUES (0, 'red fox'), (1, 'blue sky'), "
              "(2, 'green tree')")
        s.sql("SELECT id, TextSearch(body, 'red') AS s FROM d "
              "ORDER BY s DESC LIMIT 3")
        s.sql("ALTER TABLE d DELETE WHERE id = 0")
        s.sql("INSERT INTO d VALUES (3, 'purple rain')")
        got.append([[r[0] for r in s.sql(
            f"SELECT id, TextSearch(body, '{w}') AS s FROM d "
            "ORDER BY s DESC LIMIT 3").to_rows()] for w in ("red", "purple")])
        s.sql("DROP TABLE d")
    jax_rows, port_rows = got
    assert jax_rows == [[1], []]
    assert port_rows == [[], [3]]


def test_non_fused_text_score_under_a_filter(sessions):
    """Faults of the reference, pinned (ROADMAP section 3): the JAX
    package loses a non-fused TextSearch column when a WHERE compacts the
    rows (and fails on the call), and drops WHERE terms on the score; the
    port carries the column and applies the terms."""
    j, p = sessions
    sql = ("SELECT id, TextSearch(body, 'quick') AS s FROM articles "
           "WHERE id > 1 ORDER BY id")
    assert "unknown function 'TextSearch'" in _rows(j, sql)
    full = dict(p.sql("SELECT id, TextSearch(body, 'quick') AS s "
                      "FROM articles ORDER BY id").to_rows())
    assert p.sql(sql).to_rows() == [(i, full[i]) for i in range(2, 6)]
    sql = ("SELECT id, TextSearch(body, 'quick') AS s FROM articles "
           "WHERE s > 0.6 ORDER BY id")
    assert j.sql(sql).to_rows() == sorted(full.items())
    assert p.sql(sql).to_rows() == [(i, v) for i, v in sorted(full.items())
                                    if v > 0.6]


def test_text_search_statistics_cover_the_whole_table():
    """A fault of the reference, pinned (ROADMAP section 3): the JAX
    package zone-map prunes a TextSearch's scan and builds its BM25 index
    over the blocks it kept, so the statistics depend on the WHERE; the
    port keeps every row and masks."""
    n = 65536 + 40
    docs = ["fox wine" if i % 7 == 0 else "fox" for i in range(n)]
    data = {"id": np.arange(n, dtype=np.int64), "body": docs}
    sql = ("SELECT id, TextSearch(body, 'wine') AS s FROM t "
           "WHERE id >= 65536 ORDER BY s DESC LIMIT 3")
    j = myscaledb_tpu.connect()
    j.create_table("t", data)
    p = myscaledb_tpu_torch.connect(device="cpu")
    p.create_table("t", data)
    mask = np.arange(n) >= 65536
    whole_s, whole_i = JB.BM25Index(docs).search("wine", 3, mask=mask)
    kept_s, kept_i = JB.BM25Index(docs[65536:]).search("wine", 3)
    assert p.sql(sql).to_rows() == [(int(i), float(s)) for i, s in
                                    zip(np.asarray(whole_i),
                                        np.asarray(whole_s))]
    assert j.sql(sql).to_rows() == [(int(i) + 65536, float(s)) for i, s in
                                    zip(np.asarray(kept_i),
                                        np.asarray(kept_s))]


def test_hybrid_search_over_a_host_resident_vector_column():
    """A vector column past max_hbm_bytes_per_column stays in host RAM:
    HybridSearch's vector half streams it through the device, and the
    rows equal the JAX package's."""
    rng = np.random.default_rng(1)
    n = 300
    data = {"id": np.arange(n, dtype=np.int64),
            "body": [" ".join(rng.choice(WORDS, 4)) for _ in range(n)],
            "emb": rng.standard_normal((n, 8)).astype(np.float32)}
    sql = ("SELECT id, HybridSearch('fusion_type=rsf')(emb, body, "
           "[0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8], 'fox dog') AS s "
           "FROM t WHERE id > 10 ORDER BY s DESC LIMIT 5")
    rows = []
    for s in (myscaledb_tpu.connect(),
              myscaledb_tpu_torch.connect(device="cpu")):
        s.settings.max_hbm_bytes_per_column = 1000
        s.create_table("t", data)
        rows.append(s.sql(sql).to_rows())
    assert isinstance(s.tables["t"]["emb"].data, np.ndarray)
    assert rows[1] == rows[0]


def test_derived_state_is_built_once_and_dies_with_its_table(monkeypatch):
    """HybridSearch reads the vector column's squared norms from the
    session's derived state (the JAX package computes them on every
    query) and gives the JAX package's rows; the BM25 index the statements
    read is the one ``text_index`` returns; both are keyed by kind, and
    DROP TABLE forgets them."""
    from myscaledb_tpu_torch.sql import executor as PE
    builds, real = [], PE.precompute_sqnorm

    def counting_sqnorm(x):
        builds.append(1)
        return real(x)

    monkeypatch.setattr(PE, "precompute_sqnorm", counting_sqnorm)
    rng = np.random.default_rng(4)
    n = 200
    data = {"id": np.arange(n, dtype=np.int64),
            "body": [" ".join(rng.choice(WORDS, 5)) for _ in range(n)],
            "emb": rng.standard_normal((n, 8)).astype(np.float32)}
    j = myscaledb_tpu.connect()
    p = myscaledb_tpu_torch.connect(device="cpu")
    for s in (j, p):
        s.create_table("t", data)
    for fusion in ("rsf", "rrf", "rsf"):
        sql = (f"SELECT id, HybridSearch('fusion_type={fusion}')(emb, body, "
               "[0.3, -0.2, 0.1, 0.4, 0.5, -0.6, 0.7, 0.8], 'fox red') AS s "
               "FROM t WHERE id % 3 != 0 ORDER BY s DESC LIMIT 6")
        assert p.sql(sql).to_rows() == j.sql(sql).to_rows()
    assert len(builds) == 1
    assert sorted(k[0] for k in p._derived) == ["bm25", "sqnorm"]
    idx = p.text_index("t", "body")
    assert p._derived[("bm25", "t", "body", p._mutation_epoch)][0] is idx
    p.sql("DROP TABLE t")
    assert p._derived == {}
