"""The port's native host library (csrc/host/msdb_host.cpp, built at first
use by ops/kernels/build.py::host_library): against the JAX package's
native.py and its tokenize(), against a plain Python encoder, and a
failed build."""

import numpy as np
import pytest

from myscaledb_tpu import native as JN
from myscaledb_tpu.core.dictionary import StringDictionary as JDict
from myscaledb_tpu.text.bm25 import tokenize as jax_tokenize
from myscaledb_tpu_torch import native as PN
from myscaledb_tpu_torch.core.dictionary import StringDictionary as PDict
from myscaledb_tpu_torch.ops.kernels import build


def test_the_port_builds_its_own_library():
    path = build.host_library()
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("libmsdb_host-")
    assert PN.load()._name == str(path)


def _plain_dict_encode(strings, seed_values):
    index = {v: i for i, v in enumerate(seed_values or [])}
    values = list(seed_values or [])
    ids = np.empty(len(strings), dtype=np.int32)
    for i, s in enumerate(strings):
        ids[i] = index.setdefault(s, len(values))
        if ids[i] == len(values):
            values.append(s)
    return ids, values


@pytest.mark.parametrize("seed", [None, ["s3", "pre", ""]])
def test_dict_encode_equals_its_plain_version(seed):
    rng = np.random.default_rng(1)
    strings = [f"s{i}" if i % 11 else "" for i in rng.integers(0, 97, 9000)]
    strings[5] = "ünï¢ødé"
    ids, values = PN.dict_encode(strings, seed_values=seed)
    pids, pvalues = _plain_dict_encode(strings, seed)
    assert values == pvalues
    assert np.array_equal(ids, pids)


def test_dict_encode_native_equals_jax():
    rng = np.random.default_rng(2)
    strings = [f"v{i}\x00x" for i in rng.integers(0, 300, 5000)]
    for seed in (None, ["v7\x00x", "zz"]):
        ids, values = PN.dict_encode(strings, seed_values=seed)
        jids, jvalues = JN.dict_encode(strings, seed_values=seed)
        assert values == jvalues
        assert np.array_equal(ids, jids)


@pytest.mark.parametrize("n", [100, 4096, 6000])
def test_string_dictionary_ids_equal(n):
    """The JAX package sends batches of 4096 or more with no NULL to its
    native encoder; the port encodes every batch in its Python loop."""
    strings = [f"w{(i * 7919) % 613}" for i in range(n)]
    for batch in (strings, strings[:-1] + [None]):
        pd, jd = PDict(["pre"]), JDict(["pre"])
        for _ in range(2):                  # the second batch reuses ids
            assert np.array_equal(pd.encode(batch), jd.encode(batch))
        assert pd.values == jd.values
        assert pd.index == jd.index
        assert np.array_equal(pd.ranks(), jd.ranks())


DOCS = ["The quick brown FOX!", "fox-trot 123", "", None, "tabs\tand spaces",
        "a1b2 C3PO__x", "naïve café", "x" * 300]


def test_tokenize_corpus_equals():
    got = PN.tokenize_corpus(DOCS)
    want = JN.tokenize_corpus(DOCS)
    for a, b in zip(got[:2], want[:2]):
        assert np.array_equal(a, b)
    assert got[2] == want[2]
    per_doc = [[] for _ in DOCS]
    for t, d in zip(*got[:2]):
        per_doc[d].append(got[2][t])
    for i, doc in enumerate(DOCS):
        assert per_doc[i] == jax_tokenize(doc), doc


WORDS = ["Fox", "fox", "a1", "Ünï", "x_y", "", "42", "été", "ZZZ", "q"]


@pytest.mark.parametrize("seed", range(4))
def test_tokenize_corpus_seeded_equals_jax(seed):
    """Seeded corpora of mixed-case, digit, non-ASCII and empty words: the
    same term ids, doc ids and vocabulary as the JAX library, and each
    doc's tokens as tokenize() finds them where the text is ASCII."""
    rng = np.random.default_rng(seed)
    docs = [" ".join(rng.choice(WORDS, int(rng.integers(0, 9))))
            for _ in range(200)] + [None]
    got, want = PN.tokenize_corpus(docs), JN.tokenize_corpus(docs)
    for a, b in zip(got[:2], want[:2]):
        assert np.array_equal(a, b)
    assert got[2] == want[2]
    per_doc = [[] for _ in docs]
    for t, d in zip(*got[:2]):
        per_doc[d].append(got[2][t])
    for doc, toks in zip(docs, per_doc):
        if doc is None:
            assert toks == []
        elif doc.isascii():
            assert toks == jax_tokenize(doc), doc


@pytest.mark.parametrize("text,native,python", [
    # 'İ'.lower() is 'i' + U+0307: Python finds the token 'i'; the C++
    # tokenizer lowers ASCII only and splits at the two UTF-8 bytes
    ("İx", ["x"], ["i", "x"]),
    # the Kelvin sign lowers to the ASCII 'k' in Python only
    ("Kelvin", ["elvin"], ["kelvin"]),
    # equal here: 'Ä' splits in C++, and 'ä' is not in [a-z] for Python
    ("ÄbC", ["bc"], ["bc"]),
])
def test_tokenizers_past_ascii(text, native, python):
    """Pinned: the index tokenizes in C++ (both packages), the query in
    Python, and the two lowerings differ past ASCII (ROADMAP section 3)."""
    term_ids, _docs, vocab = PN.tokenize_corpus([text])
    assert [vocab[t] for t in term_ids] == native
    assert jax_tokenize(text) == python
    assert JN.tokenize_corpus([text])[2] == vocab


def test_a_failed_host_build_raises(monkeypatch, tmp_path):
    bad = tmp_path / "msdb_host.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(build, "HOST_SOURCE", bad)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="failed on"):
        build.host_library()
    assert not list((tmp_path / "_build").glob("*.so"))
    # the bindings load through the build, so they raise too
    monkeypatch.setattr(PN, "_lib", None)
    with pytest.raises(RuntimeError, match="failed on"):
        PN.dict_encode(["a"] * 5000)
