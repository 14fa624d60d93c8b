"""Copy of myscaledb_tpu/testing.py (JAX-free; imports renamed to this
package).

Golden-test replay machinery (the clickhouse-test driver analog,
reference tests/clickhouse-test): tests/test_torch_goldens_vector.py and
chip_smoke.py replay the golden cases through it.

A golden case is a `.sql` file of `;`-separated statements plus a
`.reference` file of expected TSV lines.  Statement annotations:

  ``-- { serverError N }`` / ``-- { clientError N }``
      the statement MUST raise; no output.  Error CODES are not compared
      (they are ClickHouse-internal numbering); the erroring itself is the
      contract, mirroring how the reference driver accepts any listed code.

  ``-- {GOLDEN_EXPECT: {"grep": ["needle", "OK", "FAIL"]}}``
      the curated form of the suite's shell idiom
      ``clickhouse-client -q "SQL" 2>&1 | grep -q "needle" && echo OK ||
      echo FAIL``: run the statement, emit OK when it errors with a message
      containing the needle, else FAIL.
"""

from __future__ import annotations

import json
import re

_ERR_TAG = re.compile(r"--\s*\{\s*(?:serverError|clientError)[^}]*\}")
_EXPECT_TAG = re.compile(r"--\s*\{GOLDEN_EXPECT:\s*(\{.*?\})\s*\}")


def _scan(text: str) -> list:
    """Quote-aware scan: returns (statement_sql, comment_text) pairs where
    comment_text concatenates every ``--`` comment attached to the
    statement INCLUDING one on the same line after its closing ``;`` (the
    clickhouse-test convention for `-- { serverError N }` tags).  String
    literals ('', "" and ``) keep their content verbatim — a ``--`` inside
    a string is data, not a comment."""
    stmts = []
    cur: list = []
    comments: list = []
    i, n = 0, len(text)
    pending = None          # index into stmts whose same-line tag may follow
    while i < n:
        ch = text[i]
        if ch in "'\"`":
            quote = ch
            cur.append(ch)
            i += 1
            while i < n:
                c = text[i]
                cur.append(c)
                if c == "\\" and i + 1 < n:
                    cur.append(text[i + 1])
                    i += 2
                    continue
                i += 1
                if c == quote:
                    if i < n and text[i] == quote:   # '' escape
                        cur.append(quote)
                        i += 1
                        continue
                    break
            continue
        if ch == "-" and text.startswith("--", i):
            j = text.find("\n", i)
            j = n if j < 0 else j
            comment = text[i:j]
            if pending is not None and not "".join(cur).strip():
                # same-line comment after `;` belongs to the previous stmt
                stmts[pending] = (stmts[pending][0],
                                  stmts[pending][1] + " " + comment)
            else:
                comments.append(comment)
            i = j
            continue
        if ch == ";":
            if "".join(cur).strip():
                stmts.append(("".join(cur), " ".join(comments)))
                pending = len(stmts) - 1
            # empty statement (";;"): keep pending on the previous real
            # statement so a same-line tag still attaches to it
            cur, comments = [], []
            i += 1
            continue
        if ch == "\n" and pending is not None and not "".join(cur).strip():
            pending = None
        cur.append(ch)
        i += 1
    if "".join(cur).strip():
        stmts.append(("".join(cur), " ".join(comments)))
    return stmts


def split_statements(text: str) -> list:
    """Split on top-level semicolons (quote-aware); returns SQL strings or
    (sql, expectation) pairs from ``serverError``/GOLDEN_EXPECT tags."""
    out = []
    for sql, comment in _scan(text):
        if not sql.strip():
            continue
        expect = None
        if _ERR_TAG.search(comment) or _ERR_TAG.search(sql):
            expect = "error"
        m = _EXPECT_TAG.search(comment)
        if m is not None:
            spec = json.loads(m.group(1))
            if "grep" in spec:
                needle, ok_word, fail_word = spec["grep"]
                expect = ("grep", needle, ok_word, fail_word)
        out.append(sql if expect is None else (sql, expect))
    return out


def serialize_statements(entries: list) -> str:
    """Inverse of split_statements for writing curated golden .sql files."""
    lines = []
    for entry in entries:
        if isinstance(entry, tuple):
            sql, expect = entry
            sql = sql.strip().rstrip(";").strip()
            if expect == "error":
                lines.append(f"{sql}; -- {{ serverError }}")
            else:
                _g, needle, ok_word, fail_word = expect
                spec = json.dumps({"grep": [needle, ok_word, fail_word]})
                lines.append(f"{sql}; -- {{GOLDEN_EXPECT: {spec}}}")
        else:
            lines.append(entry.strip().rstrip(";").strip() + ";")
    return "\n".join(lines) + "\n"


def run_statements(session, entries: list) -> list:
    """Execute; returns the concatenated SELECT output lines (ClickHouse
    TSV cell encoding, runtime/formats.ch_tsv_lines)."""
    from myscaledb_tpu_torch.runtime.formats import ch_tsv_lines
    lines: list = []
    for entry in entries:
        sql, expect = entry if isinstance(entry, tuple) else (entry, None)
        s = sql.strip().rstrip(";").strip()
        if not s:
            continue
        if expect == "error":
            try:
                session.sql(s)
            except Exception:          # noqa: BLE001
                continue
            raise AssertionError(f"statement was expected to error: {s}")
        if isinstance(expect, tuple) and expect[0] == "grep":
            _g, needle, ok_word, fail_word = expect
            try:
                session.sql(s)
                lines.append(fail_word)
            except Exception as e:     # noqa: BLE001
                lines.append(ok_word if needle in str(e) else fail_word)
            continue
        t = session.sql(s)
        if s.upper().startswith(("SELECT", "WITH")) and t is not None:
            lines.extend(ch_tsv_lines(t))
    return lines


def run_golden_text(session, sql_text: str) -> list:
    return run_statements(session, split_statements(sql_text))
