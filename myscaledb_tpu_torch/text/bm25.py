"""BM25 full-text scoring (the TextSearch() backend): the port of
myscaledb_tpu/text/bm25.py (``tokenize``, ``K1``, ``B``, ``BM25Index``).

The reference delegates BM25 to the Rust tantivy crate through a cxxbridge
FFI (src/Storages/MergeTree/TantivyIndexStore.h: bm25Search/
bm25SearchWithFilter).  Here the index lives on the device in CSR form:

  ``starts`` (vocab + 1,) int64   each term's first posting
  ``post_docs`` (P,) int32        posting doc ids, ascending within a term
  ``post_tfs`` (P,) float32       term frequency in that doc
  ``df`` (vocab,) int64           postings per term
  ``doc_len`` (n,) float32        tokens per doc (NULL and '' have 0)
  ``avg_len``, ``stat_docs``, ``total_tokens``

It is built from a String column without decoding its rows: the native
host library tokenizes each dictionary value once
(``native.tokenize_corpus``), the device expands the values' tokens to
rows by the column's ids (``repeat_interleave`` of the token counts),
sorts the (term, doc) int64 keys, and takes the run lengths as ``tf`` and
a ``bincount`` of the terms as ``df``.  The vocabulary and a host copy of
``starts`` stay on the host, so a query slices its terms' postings on the
device with no upload.

Scoring keeps the JAX package's arithmetic step for step (tantivy/Lucene
BM25, k1 = 1.2, b = 0.75):
    idf(t)  = ln(1 + (N - df + 0.5) / (df + 0.5))     (a Python float)
    tf_norm = tf*(k1+1) / (tf + k1*(1 - b + b*len/avg_len))   (float32)
added term by term in query order, one ``index_add_`` per term over
distinct docs, so the sums are deterministic and in the JAX order.  The
divisions divide by tensors, never by a Python scalar: PyTorch's CUDA
division by a scalar multiplies by its reciprocal, which rounds
differently.

Distributed scoring: ``doc_valid`` marks the rows that count (a
distributed table's padding rows keep their doc slot but hold no tokens
and stay out of ``stat_docs`` and ``avg_len``), and ``scores(...,
global_stats=...)`` scores a shard's docs with the statistics merged over
every shard (text/distributed.py), so each score is the undistributed
table's, bit for bit.
"""

from __future__ import annotations

import re
import time
from typing import Optional

import numpy as np
import torch

_TOKEN_RE = re.compile(r"[a-z0-9]+")

K1 = 1.2
B = 0.75

# the score and position packed into one int64 key for a selection whose
# ties go to the lower doc id (ops/sort.py::_smallest_k)
_NO_SCORE = 2 ** 31 - 1


def mean_doc_len(total_tokens: int, n_docs: int) -> float:
    """The mean doc length as the scores read it (float32): the exact
    quotient rounded once, for one index and for the statistics merged
    over shards alike, so a distributed table scores as the undistributed
    one.  The JAX package's index takes numpy's float32 mean, the same
    value while the float32 sum of the lengths is exact (below 2^24
    tokens); its merged statistics divide exactly, as here (ROADMAP
    section 3)."""
    return float(np.float32(total_tokens / n_docs)) if n_docs else 0.0


def tokenize(text: str) -> list[str]:
    if text is None:
        return []
    return _TOKEN_RE.findall(text.lower())


class BM25Index:
    """Inverted index over a list of documents (``BM25Index(docs,
    device=...)``) or a String column (``BM25Index.from_column``)."""

    def __init__(self, docs: list[Optional[str]], doc_valid=None, *,
                 device):
        from myscaledb_tpu_torch.core.dictionary import StringDictionary
        d = StringDictionary()
        ids = d.encode(list(docs))
        dev = torch.device(device)
        self._build(d.values, torch.as_tensor(ids, device=dev),
                    self._valid_of(doc_valid, dev), dev)
        self._count_valid(doc_valid)

    @staticmethod
    def _valid_of(doc_valid, dev):
        return None if doc_valid is None else \
            torch.as_tensor(doc_valid, device=dev).bool()

    def _count_valid(self, doc_valid) -> None:
        """With ``doc_valid``: the statistics of the valid docs alone."""
        if doc_valid is None:
            return
        self.stat_docs = int(torch.as_tensor(doc_valid).sum())
        self.avg_len = mean_doc_len(self.total_tokens, self.stat_docs)

    @classmethod
    def from_column(cls, col, device, doc_valid=None,
                    tokens=None) -> "BM25Index":
        """Index over a String column's rows: its dictionary's values are
        tokenized once and its ids expanded to rows on ``device``;
        ``doc_valid`` as in the constructor.  ``tokens``: the dictionary's
        ``native.tokenize_corpus`` output, where the caller has it (the
        shards of one column share it)."""
        self = cls.__new__(cls)
        data = col.data
        if not isinstance(data, torch.Tensor):
            data = torch.as_tensor(np.asarray(data))
        valid = col.valid
        if valid is not None and not isinstance(valid, torch.Tensor):
            valid = torch.as_tensor(np.asarray(valid))
        device = torch.device(device)
        valid = None if valid is None else valid.to(device).bool()
        dv = cls._valid_of(doc_valid, device)
        if dv is not None:
            valid = dv if valid is None else valid & dv
        self._build(col.dictionary.values, data.to(device), valid, device,
                    tokens)
        self._count_valid(doc_valid)
        return self

    @classmethod
    def from_state(cls, vocab: dict, starts: np.ndarray, post_docs, post_tfs,
                   doc_len: np.ndarray, avg_len: float, stat_docs: int,
                   total_tokens: int, *, device) -> "BM25Index":
        """Index from its CSR state given as host arrays."""
        self = cls.__new__(cls)
        dev = torch.device(device)
        self.device = dev
        self.vocab = dict(vocab)
        self._starts_host = np.asarray(starts, dtype=np.int64)
        self.starts = torch.as_tensor(self._starts_host, device=dev)
        self.post_docs = torch.as_tensor(
            np.asarray(post_docs, dtype=np.int32), device=dev)
        self.post_tfs = torch.as_tensor(
            np.asarray(post_tfs, dtype=np.float32), device=dev)
        self.df = self.starts[1:] - self.starts[:-1]
        self.doc_len = torch.as_tensor(np.array(doc_len, np.float32),
                                       device=dev)
        self.n_docs = int(self.doc_len.shape[0])
        self.avg_len = float(avg_len)
        self.stat_docs = int(stat_docs)
        self.total_tokens = int(total_tokens)
        self._norm_denom = None
        return self

    def _build(self, values: list, ids: torch.Tensor, valid, dev,
               tokens=None) -> None:
        from myscaledb_tpu_torch import native
        t0 = time.perf_counter()
        self.device = dev
        n = int(ids.shape[0])
        self.n_docs = n
        term_ids, val_ids, vocab_list = tokens if tokens is not None \
            else native.tokenize_corpus(values)
        self.vocab = {t: i for i, t in enumerate(vocab_list)}
        t1 = time.perf_counter()
        nv = len(vocab_list)
        # each value's tokens are contiguous (the tokenizer walks the
        # values in order): CSR by value
        vcount = np.bincount(val_ids, minlength=len(values)).astype(np.int64)
        vstart = np.zeros(len(values) + 1, dtype=np.int64)
        np.cumsum(vcount, out=vstart[1:])
        ids = ids.to(torch.int64)
        ok = ids >= 0
        if valid is not None:
            ok = ok & valid.bool()
        safe = torch.where(ok, ids, 0)
        if len(values):
            row_cnt = torch.where(
                ok, torch.as_tensor(vcount, device=dev)[safe], 0)
        else:
            row_cnt = torch.zeros(n, dtype=torch.int64, device=dev)
        self.doc_len = row_cnt.to(torch.float32)
        total = int(row_cnt.sum())                 # one sync
        self.total_tokens = total
        rows = torch.repeat_interleave(
            torch.arange(n, device=dev), row_cnt, output_size=total)
        row_first = torch.cumsum(row_cnt, 0) - row_cnt
        within = torch.arange(total, device=dev) - row_first[rows]
        tok = torch.as_tensor(vstart, device=dev)[safe[rows]] + within
        term = torch.as_tensor(term_ids, device=dev).to(torch.int64)[tok]
        del within, tok, row_first
        key = torch.sort(term * max(n, 1) + rows).values
        del term, rows
        uk, tf = torch.unique_consecutive(key, return_counts=True)
        del key
        ut = torch.div(uk, max(n, 1), rounding_mode="floor")
        self.post_docs = (uk - ut * max(n, 1)).to(torch.int32)
        self.post_tfs = tf.to(torch.float32)
        self.df = torch.bincount(ut, minlength=nv)
        self.starts = torch.zeros(nv + 1, dtype=torch.int64, device=dev)
        self.starts[1:] = torch.cumsum(self.df, 0)
        self._starts_host = self.starts.cpu().numpy()
        self.stat_docs = n
        self.avg_len = mean_doc_len(total, n)
        self._norm_denom = None
        # host seconds of the tokenizer and the vocabulary; seconds of the
        # rest, which ends in copies to the host (so the device is done)
        self.build_seconds = {"tokenize": t1 - t0,
                              "device": time.perf_counter() - t1}

    # -- statistics (the BM25InfoInDataParts surface) ------------------------

    def stats(self) -> dict:
        return {"n_docs": self.stat_docs, "total_tokens": self.total_tokens,
                "vocab_size": len(self.vocab)}

    def term_df(self, term: str) -> int:
        tid = self.vocab.get(term)
        if tid is None:
            return 0
        return int(self._starts_host[tid + 1] - self._starts_host[tid])

    def term_postings(self, term: str):
        """(doc ids int32, tf float32) device slices of a term's postings
        (empty for an unknown term)."""
        tid = self.vocab.get(term)
        s, e = (0, 0) if tid is None else \
            (int(self._starts_host[tid]), int(self._starts_host[tid + 1]))
        return self.post_docs[s:e], self.post_tfs[s:e]

    def postings_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in
                   (self.starts, self.post_docs, self.post_tfs, self.df,
                    self.doc_len))

    # -- scoring ------------------------------------------------------------

    def _denominator(self, avg_len: Optional[float] = None
                     ) -> torch.Tensor:
        """k1 * (1 - b + b * len / avg_len) per doc, float32, in the JAX
        package's order of operations; ``avg_len`` overrides the index's
        own (kept once made)."""
        if avg_len is not None:
            avg = torch.full_like(self.doc_len, np.float32(max(avg_len,
                                                               1e-9)))
            return K1 * ((1.0 - B) + (B * self.doc_len) / avg)
        if self._norm_denom is None:
            self._norm_denom = self._denominator(self.avg_len)
        return self._norm_denom

    def scores(self, query: str, operator: str = "OR",
               global_stats: Optional[dict] = None) -> torch.Tensor:
        """Dense (n_docs,) float32 BM25 score vector for the query.

        operator='AND' zeroes docs that miss any query term (the reference's
        text_operator, VSDescription.h:80-84).  ``global_stats``
        (``text.distributed.global_stats``) supplies the doc count, token
        total and per-term df merged over every shard."""
        terms = tokenize(query)
        gs = global_stats
        n = gs["n_docs"] if gs else self.stat_docs
        out = torch.zeros(self.n_docs, dtype=torch.float32,
                          device=self.device)
        if not terms or self.n_docs == 0:
            return out
        is_and = operator.upper() == "AND"
        hits = torch.zeros(self.n_docs, dtype=torch.int32,
                           device=self.device) if is_and else None
        denom = self._denominator(
            mean_doc_len(gs["total_tokens"], n)
            if gs and "total_tokens" in gs else None)
        seen = set()
        for t in terms:
            if t in seen:
                continue   # repeated query terms count once (tantivy)
            seen.add(t)
            tid = self.vocab.get(t)
            if tid is None:
                continue
            df = int(self._starts_host[tid + 1] - self._starts_host[tid])
            if gs:
                df = gs["df"].get(t, df)
            idf = float(np.log(1.0 + (n - df + 0.5) / (df + 0.5)))
            docs, tfs = self.term_postings(t)
            tf_norm = (tfs * (K1 + 1.0)) / (tfs + denom[docs])
            out.index_add_(0, docs, idf * tf_norm)
            if is_and:
                hits.index_add_(0, docs, torch.ones_like(docs))
        if is_and:
            out = torch.where(hits == len(seen), out, 0.0)
        return out

    def search(self, query: str, k: int, mask=None, operator: str = "OR"):
        """Top-k (scores desc, ties by doc id asc).  Returns (scores f32,
        ids int32), ``min(k, n_docs)`` long; docs with zero score and
        masked docs are excluded (id = INVALID_ID, score 0)."""
        from myscaledb_tpu_torch.ops.sort import _smallest_k
        from myscaledb_tpu_torch.ops.vector import INVALID_ID
        s = self.scores(query, operator)
        if mask is not None:
            s = torch.where(torch.as_tensor(mask, device=s.device).bool(),
                            s, 0.0)
        k = min(k, self.n_docs)
        # a positive float's bits order as the float: negated, the best
        # score is the smallest key
        key = torch.where(s > 0, -s.view(torch.int32), _NO_SCORE)
        pos = _smallest_k(key, k)
        vals = s[pos]
        hit = vals > 0
        scores = torch.where(hit, vals, 0.0)
        ids = torch.where(hit, pos, INVALID_ID).to(torch.int32)
        return scores, ids
