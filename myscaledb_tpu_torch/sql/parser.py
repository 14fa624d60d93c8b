"""Copy of myscaledb_tpu/sql/parser.py (JAX-free; imports renamed to this package).

Recursive-descent SQL parser (reference analog: src/Parsers/ParserQuery.h,
ExpressionListParsers.cpp — reduced to the executed subset).

Grammar (case-insensitive keywords):

  SELECT item [, item ...]
  [ FROM table [AS alias] | FROM ( select ) ]
  [ [INNER|LEFT] [ANY|ALL] JOIN table [AS alias] (ON expr | USING (cols)) ]*
  [ PREWHERE expr ] [ WHERE expr ]
  [ GROUP BY expr [, ...] ] [ HAVING expr ]
  [ ORDER BY expr [ASC|DESC] [NULLS FIRST|LAST] [, ...] ]
  [ LIMIT n BY expr [, ...] ]
  [ LIMIT [offset,] n ] [ OFFSET n ]

Expressions: OR / AND / NOT / comparisons (= == != <> < <= > >=, [NOT] IN,
[NOT] BETWEEN, [NOT] LIKE) / + - / * / %% / unary - / function calls /
[vector, literals] / tuple literals / qualified identifiers.
"""

from __future__ import annotations

from typing import Optional

from myscaledb_tpu_torch.sql.lexer import tokenize, unquote_string, Token
from myscaledb_tpu_torch.sql.ast import (Expr, Literal, VectorLiteral, Ident, Star,
                                   BinOp, UnOp, FuncCall, InList, Between,
                                   InSubquery, ScalarSubquery, ExistsSubquery,
                                   WindowCall, SelectItem,
                                   OrderItem, JoinClause, SelectQuery,
                                   UnionQuery, Lambda)

KEYWORDS = {
    "SELECT", "FROM", "WHERE", "PREWHERE", "GROUP", "BY", "HAVING", "ORDER",
    "LIMIT", "OFFSET", "AS", "AND", "OR", "NOT", "IN", "BETWEEN", "LIKE",
    "ILIKE", "IS", "NULL", "ASC", "DESC", "NULLS", "FIRST", "LAST", "JOIN",
    "INNER", "LEFT", "RIGHT", "FULL", "ANY", "ALL", "ON", "USING", "DISTINCT",
    "CASE", "WHEN", "THEN", "ELSE", "END", "UNION", "WITH", "SETTINGS",
    "SEMI", "ANTI", "CROSS", "OUTER", "GLOBAL", "PREWHERE", "OVER", "PARTITION",
    "ARRAY", "FINAL", "SAMPLE", "INTERSECT", "EXCEPT", "EXISTS", "WINDOW",
    "ASOF", "ROWS", "RANGE", "UNBOUNDED", "PRECEDING", "FOLLOWING", "CURRENT",
    "ROW",
}


class ParseError(ValueError):
    pass


class Parser:
    def __init__(self, sql: str):
        self.toks = tokenize(sql)
        self.i = 0
        self.sql = sql

    # -- token helpers ------------------------------------------------------

    def peek(self, ahead: int = 0) -> Token:
        return self.toks[min(self.i + ahead, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.toks[self.i]
        self.i = min(self.i + 1, len(self.toks) - 1)
        return t

    def at_kw(self, *kws: str) -> bool:
        t = self.peek()
        return t.kind == "ident" and t.upper in kws

    def take_kw(self, *kws: str) -> bool:
        if self.at_kw(*kws):
            self.next()
            return True
        return False

    def expect_kw(self, kw: str):
        if not self.take_kw(kw):
            raise ParseError(f"expected {kw} at {self.peek().text!r} "
                             f"(pos {self.peek().pos})")

    def at_punct(self, *ps: str) -> bool:
        t = self.peek()
        return t.kind == "punct" and t.text in ps

    def take_punct(self, *ps: str) -> bool:
        if self.at_punct(*ps):
            self.next()
            return True
        return False

    def expect_punct(self, p: str):
        if not self.take_punct(p):
            raise ParseError(f"expected {p!r} at {self.peek().text!r} "
                             f"(pos {self.peek().pos})")

    # -- entry --------------------------------------------------------------

    def parse_query(self):
        q = self.parse_select_or_union()
        if self.peek().kind != "eof":
            raise ParseError(f"trailing input at {self.peek().text!r}")
        return q

    def parse_select_or_union(self):
        # UNION / EXCEPT are left-associative, INTERSECT binds tighter
        # (reference: ParserUnionQueryElement precedence)
        selects = [self.parse_intersect_chain()]
        ops = []
        while self.at_kw("UNION", "EXCEPT"):
            kw = self.next().upper
            mode = "ALL"
            if self.take_kw("DISTINCT"):
                mode = "DISTINCT"
            else:
                self.take_kw("ALL")
            ops.append(f"{kw} {mode}" if kw == "UNION"
                       else ("EXCEPT DISTINCT" if mode == "DISTINCT"
                             else "EXCEPT"))
            selects.append(self.parse_intersect_chain())
        if len(selects) == 1:
            return selects[0]
        return UnionQuery(selects, ops)

    def parse_intersect_chain(self):
        selects = [self.parse_select_atom()]
        ops = []
        while self.at_kw("INTERSECT"):
            self.next()
            mode = "DISTINCT" if self.take_kw("DISTINCT") else \
                ("ALL" if self.take_kw("ALL") else "ALL")
            ops.append("INTERSECT DISTINCT" if mode == "DISTINCT"
                       else "INTERSECT")
            selects.append(self.parse_select_atom())
        if len(selects) == 1:
            return selects[0]
        return UnionQuery(selects, ops)

    def parse_select_atom(self):
        # parenthesized sub-select inside a set-operation chain
        if self.at_punct("(") and self.peek(1).upper in ("SELECT", "WITH"):
            self.next()
            q = self.parse_select_or_union()
            self.expect_punct(")")
            return q
        return self.parse_select()

    def parse_select(self) -> SelectQuery:
        ctes = []
        with_aliases = []
        if self.take_kw("WITH"):
            while True:
                # two forms (reference grammar, ParserWithElement):
                #   WITH name AS (subquery)      -- CTE
                #   WITH expr AS name            -- scalar alias
                if self.peek().kind in ("ident", "ident_quoted") \
                        and self.peek(1).upper == "AS" \
                        and self.peek(2).text == "(" \
                        and self.peek(3).upper in ("SELECT", "WITH"):
                    name = self.next().text
                    self.expect_kw("AS")
                    self.expect_punct("(")
                    sub = self.parse_select_or_union()
                    self.expect_punct(")")
                    ctes.append((name, sub))
                else:
                    e = self.parse_expr()
                    self.expect_kw("AS")
                    with_aliases.append((self.next().text, e))
                if not self.take_punct(","):
                    break
        self.expect_kw("SELECT")
        distinct = self.take_kw("DISTINCT")
        items = [self.parse_select_item()]
        while self.take_punct(","):
            items.append(self.parse_select_item())
        q = SelectQuery(items=items, distinct=distinct, ctes=ctes,
                        with_aliases=with_aliases)

        if self.take_kw("FROM"):
            # table function: numbers(N) / ftsIndex(table, col, 'query')
            if self.peek().kind == "ident" and \
                    self.peek().text.lower() == "numbers" and \
                    self.peek(1).text == "(":
                self.next(); self.next()
                n0 = self.parse_int()
                n1 = None
                if self.take_punct(","):
                    n1 = self.parse_int()
                self.expect_punct(")")
                q.table_function = ("numbers", (n0, n1))
            elif self.peek().kind == "ident" and \
                    self.peek().text.lower() == "ftsindex" and \
                    self.peek(1).text == "(":
                # reference: ftsIndex(db, table, column|index, query)
                # exposes the FTS statistics a distributed initiator merges
                # (TableFunctionFtsIndex.h:23, StorageFtsIndex.h)
                self.next(); self.next()
                tname = self.parse_table_name()
                self.expect_punct(",")
                cname = self.next().text
                self.expect_punct(",")
                qtok = self.next()
                if qtok.kind != "string":
                    raise ParseError("ftsIndex() query must be a string")
                self.expect_punct(")")
                q.table_function = ("ftsindex", (tname, cname, qtok.text))
            elif self.peek().kind == "ident" and \
                    self.peek().text.lower() in ("file", "url", "s3") and \
                    self.peek(1).text == "(":
                # file('path'[, 'Format'[, 'a Int64, b String']]),
                # url('http://...'[, Format[, schema]]) and
                # s3('url'[, key, secret][, Format[, schema]]) table
                # functions (reference: src/TableFunctions/
                # TableFunctionFile.cpp, TableFunctionURL.cpp,
                # TableFunctionS3.cpp)
                from myscaledb_tpu_torch.sql.lexer import unquote_string

                def _unq(tok):
                    return unquote_string(tok.text) if tok.kind == "string" \
                        else tok.text
                kind = self.next().text.lower()
                self.next()
                src = _unq(self.next())
                args = []
                while self.take_punct(","):
                    args.append(_unq(self.next()))
                self.expect_punct(")")
                if kind == "s3":
                    # s3(url[, key, secret][, fmt[, structure]]) — creds
                    # present iff the first extra arg is NOT a known format
                    # (TableFunctionS3 disambiguates the same way)
                    def _is_fmt(a):
                        # the format registry (runtime/formats.py) is not
                        # ported yet
                        from myscaledb_tpu_torch.errors import \
                            NotPortedError
                        raise NotPortedError("s3() table function",
                                             "storage, formats")
                    key = secret = ""
                    if len(args) >= 2 and not _is_fmt(args[0]):
                        key, secret, args = args[0], args[1], args[2:]
                    fmt = args[0] if args else None
                    schema = args[1] if len(args) > 1 else None
                    q.table_function = (kind, (src, fmt, schema,
                                               key, secret))
                else:
                    fmt = args[0] if args else None
                    schema = args[1] if len(args) > 1 else None
                    q.table_function = (kind, (src, fmt, schema))
            elif self.take_punct("("):
                q.subquery = self.parse_select()
                self.expect_punct(")")
                if self.take_kw("AS"):
                    q.table_alias = self.next().text
                elif self.peek().kind in ("ident", "ident_quoted") \
                        and self.peek().upper not in KEYWORDS:
                    q.table_alias = self.next().text
            else:
                q.table = self.parse_table_name()
                if self.take_kw("AS"):
                    q.table_alias = self.next().text
                elif self.peek().kind in ("ident", "ident_quoted") \
                        and self.peek().upper not in KEYWORDS:
                    q.table_alias = self.next().text
            # FINAL: no-op here (no merging table engines — parts are always
            # fully merged); SAMPLE f: deterministic pseudo-random subset
            if self.take_kw("FINAL"):
                q.final = True
            if self.take_kw("SAMPLE"):
                t = self.next()
                if t.kind != "number":
                    raise ParseError("SAMPLE expects a number")
                q.sample = float(t.text)
            # comma-separated FROM list == CROSS JOIN chain
            while self.take_punct(","):
                tbl = self.parse_table_name()
                alias = None
                if self.take_kw("AS"):
                    alias = self.next().text
                elif self.peek().kind in ("ident", "ident_quoted") \
                        and self.peek().upper not in KEYWORDS:
                    alias = self.next().text
                q.joins.append(JoinClause(tbl, alias, "CROSS", "ALL", None))

        while True:
            if self.at_kw("ARRAY") and self.peek(1).upper == "JOIN":
                self.next(); self.next()
                self._parse_array_join_items(q, left=False)
            elif self.at_kw("LEFT") and self.peek(1).upper == "ARRAY":
                self.next(); self.next()
                self.expect_kw("JOIN")
                self._parse_array_join_items(q, left=True)
            elif self.at_kw("INNER", "LEFT", "RIGHT", "FULL", "CROSS",
                            "JOIN", "ANY", "ALL", "SEMI", "ANTI", "GLOBAL"):
                q.joins.append(self.parse_join())
            else:
                break

        if self.take_kw("PREWHERE"):
            q.prewhere = self.parse_expr()
        if self.take_kw("WHERE"):
            q.where = self.parse_expr()
        if self.at_kw("GROUP"):
            self.next(); self.expect_kw("BY")
            # GROUP BY GROUPING SETS ((a,b),(a),())
            if self.at_kw("GROUPING") and self.peek(1).upper == "SETS":
                self.next(); self.next()
                self.expect_punct("(")
                sets = []
                while True:
                    self.expect_punct("(")
                    exprs = []
                    if not self.at_punct(")"):
                        exprs.append(self.parse_expr())
                        while self.take_punct(","):
                            exprs.append(self.parse_expr())
                    self.expect_punct(")")
                    sets.append(exprs)
                    if not self.take_punct(","):
                        break
                self.expect_punct(")")
                q.grouping_sets = sets
                # group_by = union of all keys, in first-appearance order
                seen = []
                for st in sets:
                    for e in st:
                        if all(repr(e) != repr(s) for s in seen):
                            seen.append(e)
                q.group_by.extend(seen)
            # GROUP BY ROLLUP(a, b) / CUBE(a, b) function-style
            elif self.at_kw("ROLLUP", "CUBE") and self.peek(1).kind == "punct" \
                    and self.peek(1).text == "(":
                q.group_modifier = self.peek().upper
                self.next(); self.next()
                q.group_by.append(self.parse_expr())
                while self.take_punct(","):
                    q.group_by.append(self.parse_expr())
                self.expect_punct(")")
            else:
                q.group_by.append(self.parse_expr())
                while self.take_punct(","):
                    q.group_by.append(self.parse_expr())
            while self.take_kw("WITH"):
                if self.take_kw("ROLLUP"):
                    q.group_modifier = "ROLLUP"
                elif self.take_kw("CUBE"):
                    q.group_modifier = "CUBE"
                elif self.take_kw("TOTALS"):
                    q.with_totals = True
                else:
                    raise ParseError(
                        "expected ROLLUP, CUBE or TOTALS after WITH")
        if self.take_kw("HAVING"):
            q.having = self.parse_expr()
        if self.take_kw("WINDOW"):
            # WINDOW w AS (PARTITION BY ... ORDER BY ... [frame]) [, ...]
            while True:
                wname = self.next().text
                self.expect_kw("AS")
                self.expect_punct("(")
                spec = self.parse_window_spec()
                self.expect_punct(")")
                q.windows[wname] = spec
                if not self.take_punct(","):
                    break
        if self.at_kw("ORDER"):
            self.next(); self.expect_kw("BY")
            q.order_by.append(self.parse_order_item())
            while self.take_punct(","):
                q.order_by.append(self.parse_order_item())
        if self.take_kw("LIMIT"):
            n1 = self.parse_int()
            if self.take_kw("BY"):
                exprs = [self.parse_expr()]
                while self.take_punct(","):
                    exprs.append(self.parse_expr())
                q.limit_by = (n1, exprs)
                if self.take_kw("LIMIT"):
                    n1 = self.parse_int()
                    if self.take_punct(","):
                        q.offset = n1
                        q.limit = self.parse_int()
                    else:
                        q.limit = n1
            elif self.take_punct(","):
                q.offset = n1
                q.limit = self.parse_int()
            else:
                q.limit = n1
        if self.take_kw("OFFSET"):
            q.offset = self.parse_int()
        if self.take_kw("SETTINGS"):
            while True:
                name = self.next().text
                self.expect_punct("=")
                t = self.next()
                if t.kind == "number":
                    val = float(t.text) if "." in t.text else int(t.text)
                elif t.kind == "string":
                    from myscaledb_tpu_torch.sql.lexer import unquote_string
                    val = unquote_string(t.text)
                else:
                    val = t.text
                q.settings[name] = val
                if not self.take_punct(","):
                    break
        return q

    def parse_table_name(self) -> str:
        t = self.next()
        if t.kind not in ("ident", "ident_quoted"):
            raise ParseError(f"expected table name, got {t.text!r}")
        name = t.text
        while self.at_punct(".") and self.peek(1).kind in ("ident", "ident_quoted"):
            self.next()
            name += "." + self.next().text
        return name

    def parse_join(self) -> JoinClause:
        how, strictness = "INNER", "ALL"
        self.take_kw("GLOBAL")   # GLOBAL JOIN == broadcast; we always broadcast
        # strictness may come before or after the direction (CH grammar)
        def take_strictness():
            nonlocal strictness
            if self.take_kw("ANY"):
                strictness = "ANY"
            elif self.take_kw("ALL"):
                strictness = "ALL"
            elif self.take_kw("SEMI"):
                strictness = "SEMI"
            elif self.take_kw("ANTI"):
                strictness = "ANTI"
            elif self.take_kw("ASOF"):
                strictness = "ASOF"
        take_strictness()
        if self.take_kw("LEFT"):
            how = "LEFT"
        elif self.take_kw("RIGHT"):
            how = "RIGHT"
        elif self.take_kw("FULL"):
            how = "FULL"
        elif self.take_kw("INNER"):
            how = "INNER"
        elif self.take_kw("CROSS"):
            how = "CROSS"
        self.take_kw("OUTER")
        take_strictness()
        self.expect_kw("JOIN")
        table, sub = None, None
        if self.at_punct("(") and self.peek(1).upper in ("SELECT", "WITH"):
            self.next()
            sub = self.parse_select_or_union()
            self.expect_punct(")")
        else:
            table = self.parse_table_name()
        alias = None
        if self.take_kw("AS"):
            alias = self.next().text
        elif self.peek().kind in ("ident", "ident_quoted") \
                and self.peek().upper not in KEYWORDS:
            alias = self.next().text
        cond, using = None, None
        if self.take_kw("ON"):
            cond = self.parse_expr()
        elif self.take_kw("USING"):
            paren = self.take_punct("(")
            using = [self.next().text]
            while self.take_punct(","):
                using.append(self.next().text)
            if paren:
                self.expect_punct(")")
        elif how != "CROSS":
            raise ParseError("JOIN requires ON or USING (except CROSS JOIN)")
        return JoinClause(table, alias, how, strictness, cond, using,
                          subquery=sub)

    def parse_select_item(self) -> SelectItem:
        if self.at_punct("*"):
            self.next()
            return SelectItem(Star())
        e = self.parse_expr()
        alias = None
        if self.take_kw("AS"):
            t = self.next()
            alias = t.text
        elif self.peek().kind in ("ident", "ident_quoted") \
                and self.peek().upper not in KEYWORDS:
            alias = self.next().text
        return SelectItem(e, alias)

    def parse_order_item(self) -> OrderItem:
        e = self.parse_expr()
        asc = True
        if self.take_kw("DESC"):
            asc = False
        else:
            self.take_kw("ASC")
        nulls_last = None
        if self.take_kw("NULLS"):
            if self.take_kw("FIRST"):
                nulls_last = False
            else:
                self.expect_kw("LAST")
                nulls_last = True
        fill = None
        if self.take_kw("WITH"):
            # WITH FILL [FROM lit] [TO lit] [STEP lit]
            # (reference: FillingTransform, src/Processors/Transforms/)
            self.expect_kw("FILL")
            fill = {}
            if self.take_kw("FROM"):
                fill["from"] = self._fill_literal()
            if self.take_kw("TO"):
                fill["to"] = self._fill_literal()
            if self.take_kw("STEP"):
                fill["step"] = self._fill_literal()
        return OrderItem(e, asc, nulls_last, fill)

    def _fill_literal(self) -> float:
        from myscaledb_tpu_torch.sql.ast import Literal, UnOp
        e = self.parse_expr()
        if isinstance(e, UnOp) and e.op == "-" and \
                isinstance(e.operand, Literal):
            return -e.operand.value
        if isinstance(e, Literal) and isinstance(e.value, (int, float)):
            return e.value
        raise ParseError("WITH FILL bounds must be numeric literals")

    def parse_int(self) -> int:
        t = self.next()
        if t.kind != "number":
            raise ParseError(f"expected integer, got {t.text!r}")
        return int(float(t.text))

    # -- expressions (precedence climbing) ----------------------------------

    def _parse_array_join_items(self, q, left: bool):
        while True:
            e = self.parse_expr()
            alias = None
            if self.take_kw("AS"):
                alias = self.next().text
            q.array_joins.append((e, alias, left))
            if not self.take_punct(","):
                break

    def parse_expr(self) -> Expr:
        e = self.parse_or()
        if self.at_punct("->"):
            # lambda: x -> body  |  (x, y) -> body
            self.next()
            if isinstance(e, Ident) and e.table is None:
                params = [e.name]
            elif isinstance(e, FuncCall) and e.name == "tuple" and \
                    all(isinstance(a, Ident) and a.table is None
                        for a in e.args):
                params = [a.name for a in e.args]
            else:
                raise ParseError("lambda parameters must be identifiers")
            return Lambda(params, self.parse_expr())
        return e

    def parse_or(self) -> Expr:
        e = self.parse_and()
        while self.take_kw("OR"):
            e = BinOp("OR", e, self.parse_and())
        return e

    def parse_and(self) -> Expr:
        e = self.parse_not()
        while self.take_kw("AND"):
            e = BinOp("AND", e, self.parse_not())
        return e

    def parse_not(self) -> Expr:
        if self.take_kw("NOT"):
            return UnOp("NOT", self.parse_not())
        return self.parse_comparison()

    def parse_comparison(self) -> Expr:
        e = self.parse_additive()
        while True:
            neg = False
            if self.at_kw("NOT") and self.peek(1).upper in ("IN", "BETWEEN", "LIKE", "ILIKE"):
                self.next()
                neg = True
            if self.take_kw("IN"):
                if not self.at_punct("("):
                    # x IN table_name — the Set/Join-engine membership form
                    # (reference: StorageSet; the right side is a table
                    # whose rows form the set)
                    name = self.next().text
                    if self.take_punct("."):
                        name = name + "." + self.next().text
                    sub = Parser(f"SELECT * FROM {name}") \
                        .parse_select_or_union()
                    e = InSubquery(e, sub, neg)
                    continue
                self.expect_punct("(")
                if self.at_kw("SELECT", "WITH"):
                    sub = self.parse_select_or_union()
                    self.expect_punct(")")
                    e = InSubquery(e, sub, neg)
                    continue
                items = [self.parse_expr()]
                while self.take_punct(","):
                    items.append(self.parse_expr())
                self.expect_punct(")")
                e = InList(e, items, neg)
            elif self.take_kw("BETWEEN"):
                lo = self.parse_additive()
                self.expect_kw("AND")
                hi = self.parse_additive()
                e = Between(e, lo, hi, neg)
            elif self.take_kw("LIKE"):
                pat = self.parse_additive()
                e = FuncCall("notLike" if neg else "like", [e, pat])
            elif self.take_kw("ILIKE"):
                pat = self.parse_additive()
                e = FuncCall("notILike" if neg else "ilike", [e, pat])
            elif self.at_kw("IS"):
                self.next()
                n = self.take_kw("NOT")
                self.expect_kw("NULL")
                e = FuncCall("isNotNull" if n else "isNull", [e])
            elif self.at_punct("=", "==", "!=", "<>", "<", "<=", ">", ">="):
                op = self.next().text
                op = {"==": "=", "<>": "!="}.get(op, op)
                e = BinOp(op, e, self.parse_additive())
            else:
                return e

    _INTERVAL_UNITS = ("SECOND", "MINUTE", "HOUR", "DAY", "WEEK", "MONTH",
                       "QUARTER", "YEAR")

    def parse_additive(self) -> Expr:
        e = self.parse_multiplicative()
        while self.at_punct("+", "-"):
            op = self.next().text
            if self.at_kw("INTERVAL") and \
                    self.peek(2).upper.rstrip("S") in self._INTERVAL_UNITS:
                # x +/- INTERVAL n UNIT -> addUnits/subtractUnits(x, n):
                # calendar arithmetic, so a Date moves by days (the JAX
                # package adds the interval's seconds to the day count)
                self.next()
                num = self.parse_unary()
                unit = self.next().upper.rstrip("S").capitalize()
                e = FuncCall(("add" if op == "+" else "subtract") + unit
                             + "s", [e, num])
                continue
            e = BinOp(op, e, self.parse_multiplicative())
        return e

    def parse_multiplicative(self) -> Expr:
        e = self.parse_unary()
        while self.at_punct("*", "/", "%"):
            op = self.next().text
            e = BinOp(op, e, self.parse_unary())
        return e

    def parse_unary(self) -> Expr:
        if self.take_punct("-"):
            return UnOp("-", self.parse_unary())
        if self.take_punct("+"):
            return self.parse_unary()
        e = self.parse_primary()
        # postfix subscript a[i] -> arrayElement(a, i); only after a name,
        # call or bracketed expression (never after a literal number, where
        # '[' would start a fresh array literal)
        if isinstance(e, (Ident, FuncCall)):
            while self.at_punct("["):
                self.next()
                idx = self.parse_expr()
                self.expect_punct("]")
                e = FuncCall("arrayElement", [e, idx])
        # postfix tuple element access: (a, b).1, tuple(x, y).2 — the lexer
        # fuses ".1" into one number token
        while isinstance(e, FuncCall):
            nt = self.peek()
            if nt.kind == "number" and nt.text.startswith(".") \
                    and nt.text[1:].isdigit():
                self.next()
                idx = int(nt.text[1:])
                if e.name == "tuple" and 1 <= idx <= len(e.args):
                    e = e.args[idx - 1]     # resolve syntactic tuples inline
                else:
                    e = FuncCall("tupleElement", [e, Literal(idx)])
            else:
                break
        return e

    def parse_primary(self) -> Expr:
        t = self.peek()
        if t.upper == "INTERVAL":
            # INTERVAL n UNIT -> seconds literal (DateTime arithmetic; the
            # reference's IntervalKind tree, ParserCreateQuery TTL clauses).
            # Date columns count days, not seconds — use toIntervalDay-less
            # plain numbers there (documented limitation).
            self.next()
            num = self.parse_unary()
            unit = self.next().upper.rstrip("S")
            scale = {"SECOND": 1, "MINUTE": 60, "HOUR": 3600, "DAY": 86400,
                     "WEEK": 604800, "MONTH": 2592000, "QUARTER": 7776000,
                     "YEAR": 31536000}.get(unit)
            if scale is None:
                raise ParseError(f"unknown INTERVAL unit {unit!r}")
            if isinstance(num, Literal):
                return Literal(num.value * scale)
            return BinOp("*", num, Literal(scale))
        if t.kind == "number":
            self.next()
            txt = t.text
            if "." in txt or "e" in txt or "E" in txt:
                return Literal(float(txt))
            return Literal(int(txt))
        if t.kind == "string":
            self.next()
            return Literal(unquote_string(t.text))
        if self.take_punct("["):
            return self.parse_vector_literal()
        if self.take_punct("("):
            if self.at_kw("SELECT", "WITH"):
                sub = self.parse_select_or_union()
                self.expect_punct(")")
                return ScalarSubquery(sub)
            e = self.parse_expr()
            if self.take_punct(","):
                # tuple literal -> treat as function tuple(...)
                args = [e, self.parse_expr()]
                while self.take_punct(","):
                    args.append(self.parse_expr())
                self.expect_punct(")")
                return FuncCall("tuple", args)
            self.expect_punct(")")
            return e
        if t.kind in ("ident", "ident_quoted"):
            up = t.upper
            if up == "NULL":
                self.next()
                return Literal(None)
            if up in ("TRUE", "FALSE"):
                self.next()
                return Literal(up == "TRUE")
            if up == "CASE":
                return self.parse_case()
            if up == "EXISTS" and self.peek(1).text == "(":
                self.next(); self.next()
                sub = self.parse_select_or_union()
                self.expect_punct(")")
                return ExistsSubquery(sub)
            self.next()
            # function call?
            if self.at_punct("("):
                self.next()
                distinct = self.take_kw("DISTINCT")
                args = []
                if not self.at_punct(")"):
                    if self.at_punct("*"):
                        self.next()
                        args.append(Star())
                    else:
                        args.append(self.parse_expr())
                        while self.take_punct(","):
                            args.append(self.parse_expr())
                self.expect_punct(")")
                call = FuncCall(t.text, args, distinct)
                # HybridSearch('fusion_type=rsf')(vec, text, [q], 'text')
                if self.at_punct("("):
                    self.next()
                    args2 = []
                    if not self.at_punct(")"):
                        args2.append(self.parse_expr())
                        while self.take_punct(","):
                            args2.append(self.parse_expr())
                    self.expect_punct(")")
                    # parameterized call F('params')(args...): params first
                    call = FuncCall(t.text, call.args + args2, distinct)
                if self.at_kw("OVER"):
                    self.next()
                    if self.take_punct("("):
                        partition, order, frame = self.parse_window_spec()
                        self.expect_punct(")")
                        return WindowCall(call, partition, order, frame=frame)
                    # OVER w — named window reference
                    wname = self.next().text
                    return WindowCall(call, window_name=wname)
                return call
            # tuple element access "dist.1": the lexer fuses ".1" into a
            # number token; detect by adjacency (no whitespace between)
            nt = self.peek()
            if (nt.kind == "number" and nt.text.startswith(".")
                    and nt.text[1:].isdigit()
                    and nt.pos == t.pos + len(t.text)):
                self.next()
                return Ident(nt.text[1:], table=t.text)
            # qualified identifier a.b / a.* / tuple element a.1
            if self.at_punct(".") :
                if self.peek(1).kind in ("ident", "ident_quoted"):
                    self.next()
                    col = self.next().text
                    return Ident(col, table=t.text)
                if self.peek(1).kind == "number":
                    self.next()
                    num = self.next().text
                    return Ident(num, table=t.text)   # dist.1 -> column "dist.1"
                if self.peek(1).text == "*":
                    self.next(); self.next()
                    return Star(table=t.text)
            return Ident(t.text)
        raise ParseError(f"unexpected token {t.text!r} at {t.pos}")

    def parse_vector_literal(self) -> Expr:
        # '[' already consumed; supports [1,2,3] and [[1,2],[3,4]].
        # Non-numeric elements fall back to a general array(...) expression.
        save = self.i
        try:
            return self._parse_numeric_vector()
        except ParseError:
            self.i = save
        items = []
        if not self.at_punct("]"):
            items.append(self.parse_expr())
            while self.take_punct(","):
                items.append(self.parse_expr())
        self.expect_punct("]")
        return FuncCall("array", items)

    def _parse_numeric_vector(self) -> Expr:
        vals = []
        nested = False
        if self.at_punct("]"):
            self.next()
            return VectorLiteral([])
        while True:
            if self.take_punct("["):
                nested = True
                inner = []
                while not self.at_punct("]"):
                    inner.append(self._number())
                    if not self.take_punct(","):
                        break
                self.expect_punct("]")
                vals.append(inner)
            else:
                vals.append(self._number())
            if not self.take_punct(","):
                break
        self.expect_punct("]")
        if nested and not all(isinstance(v, list) for v in vals):
            raise ParseError("mixed scalar/vector elements in array literal")
        return VectorLiteral(vals)

    def _number(self):
        sign = 1
        if self.take_punct("-"):
            sign = -1
        t = self.next()
        if t.kind != "number":
            raise ParseError(f"expected number in vector literal, got {t.text!r}")
        if "." not in t.text and "e" not in t.text.lower():
            return sign * int(t.text)
        return sign * float(t.text)

    def parse_window_spec(self):
        """Body of OVER (...) / WINDOW w AS (...): returns
        (partition_exprs, order_items, frame or None)."""
        partition, order = [], []
        if self.take_kw("PARTITION"):
            self.expect_kw("BY")
            partition.append(self.parse_expr())
            while self.take_punct(","):
                partition.append(self.parse_expr())
        if self.at_kw("ORDER"):
            self.next()
            self.expect_kw("BY")
            order.append(self.parse_order_item())
            while self.take_punct(","):
                order.append(self.parse_order_item())
        frame = None
        if self.at_kw("ROWS", "RANGE"):
            mode = self.next().upper
            def bound(first: bool):
                if self.take_kw("UNBOUNDED"):
                    if first:
                        self.expect_kw("PRECEDING")
                    else:
                        self.expect_kw("FOLLOWING")
                    return None
                if self.take_kw("CURRENT"):
                    self.expect_kw("ROW")
                    return 0
                n = self.parse_int()
                if self.take_kw("PRECEDING"):
                    return -n
                self.expect_kw("FOLLOWING")
                return n
            if self.take_kw("BETWEEN"):
                lo = bound(True)
                self.expect_kw("AND")
                hi = bound(False)
            else:
                lo = bound(True)
                hi = 0
            frame = (mode, lo, hi)
        return partition, order, frame

    def parse_case(self) -> Expr:
        self.expect_kw("CASE")
        whens = []
        while self.take_kw("WHEN"):
            c = self.parse_expr()
            self.expect_kw("THEN")
            v = self.parse_expr()
            whens.append((c, v))
        default = Literal(None)
        if self.take_kw("ELSE"):
            default = self.parse_expr()
        self.expect_kw("END")
        # lower to nested if(c, v, ...)
        e = default
        for c, v in reversed(whens):
            e = FuncCall("if", [c, v, e])
        return e


def parse_sql(sql: str) -> SelectQuery:
    return Parser(sql).parse_query()
