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

Distributed scoring (``doc_valid``, ``global_stats``) belongs to the
distribution slice and raises ``NotPortedError``.
"""

from __future__ import annotations

import re
import time
from typing import Optional

import numpy as np
import torch

from myscaledb_tpu_torch.errors import NotPortedError

_TOKEN_RE = re.compile(r"[a-z0-9]+")

K1 = 1.2
B = 0.75

# the score and position packed into one int64 key for a selection whose
# ties go to the lower doc id (ops/sort.py::_smallest_k)
_NO_SCORE = 2 ** 31 - 1


def tokenize(text: str) -> list[str]:
    if text is None:
        return []
    return _TOKEN_RE.findall(text.lower())


def _distribution(what: str):
    return NotPortedError(what, "distribution")


class BM25Index:
    """Inverted index over a list of documents (``BM25Index(docs,
    device=...)``) or a String column (``BM25Index.from_column``)."""

    def __init__(self, docs: list[Optional[str]], doc_valid=None, *,
                 device):
        if doc_valid is not None:
            raise _distribution("BM25 over a distributed table's valid rows")
        from myscaledb_tpu_torch.core.dictionary import StringDictionary
        d = StringDictionary()
        ids = d.encode(list(docs))
        self._build(d.values, torch.as_tensor(ids, device=device), None,
                    torch.device(device))

    @classmethod
    def from_column(cls, col, device) -> "BM25Index":
        """Index over a String column's rows: its dictionary's values are
        tokenized once and its ids expanded to rows on ``device``."""
        self = cls.__new__(cls)
        data = col.data
        if not isinstance(data, torch.Tensor):
            data = torch.as_tensor(np.asarray(data))
        valid = col.valid
        if valid is not None and not isinstance(valid, torch.Tensor):
            valid = torch.as_tensor(np.asarray(valid))
        device = torch.device(device)
        self._build(col.dictionary.values, data.to(device),
                    None if valid is None else valid.to(device), device)
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

    def _build(self, values: list, ids: torch.Tensor, valid, dev) -> None:
        from myscaledb_tpu_torch import native
        t0 = time.perf_counter()
        self.device = dev
        n = int(ids.shape[0])
        self.n_docs = n
        term_ids, val_ids, vocab_list = native.tokenize_corpus(values)
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
        # numpy's float32 mean, as the JAX package takes it
        self.avg_len = float(self.doc_len.cpu().numpy().mean()) if n else 0.0
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

    def _denominator(self) -> torch.Tensor:
        """k1 * (1 - b + b * len / avg_len) per doc, float32, in the JAX
        package's order of operations."""
        if self._norm_denom is None:
            avg = torch.full_like(self.doc_len,
                                  np.float32(max(self.avg_len, 1e-9)))
            self._norm_denom = K1 * ((1.0 - B) + (B * self.doc_len) / avg)
        return self._norm_denom

    def scores(self, query: str, operator: str = "OR",
               global_stats: Optional[dict] = None) -> torch.Tensor:
        """Dense (n_docs,) float32 BM25 score vector for the query.

        operator='AND' zeroes docs that miss any query term (the reference's
        text_operator, VSDescription.h:80-84)."""
        if global_stats is not None:
            raise _distribution("BM25 with global statistics")
        terms = tokenize(query)
        n = self.stat_docs
        out = torch.zeros(self.n_docs, dtype=torch.float32,
                          device=self.device)
        if not terms or self.n_docs == 0:
            return out
        is_and = operator.upper() == "AND"
        hits = torch.zeros(self.n_docs, dtype=torch.int32,
                           device=self.device) if is_and else None
        denom = self._denominator()
        seen = set()
        for t in terms:
            if t in seen:
                continue   # repeated query terms count once (tantivy)
            seen.add(t)
            tid = self.vocab.get(t)
            if tid is None:
                continue
            df = int(self._starts_host[tid + 1] - self._starts_host[tid])
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
