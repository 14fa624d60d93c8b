"""Copy of myscaledb_tpu/sql/lexer.py (JAX-free; imports renamed to this package).

SQL tokenizer (reference analog: src/Parsers/Lexer.cpp)."""

from __future__ import annotations

import re
from dataclasses import dataclass

TOKEN_RE = re.compile(r"""
    (?P<ws>\s+|--[^\n]*|/\*.*?\*/)
  | (?P<number>(?:\d+\.\d*|\.\d+|\d+)(?:[eE][+-]?\d+)?)
  | (?P<string>'(?:[^'\\]|\\.|'')*')
  | (?P<qident>"(?:[^"]|"")*"|`(?:[^`]|``)*`)
  | (?P<ident>[A-Za-z_][A-Za-z_0-9]*)
  | (?P<punct><=|>=|!=|<>|==|\|\||->|[-+*/%(),.\[\]<>=])
""", re.VERBOSE | re.DOTALL)


@dataclass
class Token:
    kind: str      # 'number' | 'string' | 'ident' | 'punct' | 'eof'
    text: str
    pos: int

    @property
    def upper(self) -> str:
        return self.text.upper()


class LexError(ValueError):
    pass


def tokenize(sql: str) -> list[Token]:
    out = []
    pos = 0
    n = len(sql)
    while pos < n:
        m = TOKEN_RE.match(sql, pos)
        if not m:
            raise LexError(f"unexpected character {sql[pos]!r} at {pos}: "
                           f"...{sql[max(0, pos-20):pos+10]}...")
        pos = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        text = m.group()
        if kind == "qident":
            text = text[1:-1].replace('""', '"').replace("``", "`")
            kind = "ident_quoted"
        out.append(Token(kind, text, m.start()))
    out.append(Token("eof", "", n))
    return out


_ESCAPES = {"n": "\n", "t": "\t", "r": "\r", "0": "\0", "b": "\b",
            "f": "\f", "a": "\a", "v": "\v", "'": "'", '"': '"',
            "\\": "\\"}
_ESC_RE = re.compile(r"''|((?:\\x[0-9A-Fa-f]{2})+)|\\(.)", re.DOTALL)


def _raw_bytes(run: str) -> str:
    """A run of \\xHH escapes: raw bytes, as ClickHouse stores them.  A run
    that is UTF-8 reads as the text it encodes ('\\xC3\\xA9' is the
    literal 'é', the same bytes); any other byte is the engine's one-byte
    character for it, chr(0xHH), as char() and unhex() make it."""
    raw = bytes.fromhex(run.replace("\\x", ""))
    out, i = [], 0
    while i < len(raw):
        for j in range(min(len(raw), i + 4), i, -1):
            try:
                ch = raw[i:j].decode("utf-8")
            except UnicodeDecodeError:
                continue
            if len(ch) == 1:
                out.append(ch)
                i = j
                break
        else:
            out.append(chr(raw[i]))
            i += 1
    return "".join(out)


def _unescape_one(m) -> str:
    if m.group() == "''":
        return "'"
    if m.group(1) is not None:               # \xHH byte escapes
        return _raw_bytes(m.group(1))
    c = m.group(2)
    # unknown escapes KEEP the backslash (ClickHouse
    # parseComplexEscapeSequence) — '\%' must reach LIKE as backslash-%
    return _ESCAPES.get(c, "\\" + c)


def unquote_string(tok_text: str) -> str:
    """Single-pass unescape of a quoted SQL string literal: '' and the
    ClickHouse escape set incl. \\xHH bytes (the sequential str.replace
    chain double-decoded e.g. \\\\t into backslash+TAB)."""
    return _ESC_RE.sub(_unescape_one, tok_text[1:-1])
