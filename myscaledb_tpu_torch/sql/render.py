"""Copy of myscaledb_tpu/sql/render.py (JAX-free; imports renamed to this package).

Canonical rendering of expressions — used for result column naming (the
reference names result columns by their expression text, IAST::getColumnName)
and for structural equality between, e.g., an ORDER BY key and a SELECT item.
"""

from __future__ import annotations

from myscaledb_tpu_torch.sql.ast import (Expr, Literal, VectorLiteral, Ident, Star,
                                   BinOp, UnOp, FuncCall, InList, Between,
                                   WindowCall, Lambda)


def _num(v) -> str:
    if isinstance(v, float) and v == int(v) and abs(v) < 1e16:
        # ClickHouse renders 8. as 8
        return str(int(v))
    return repr(v)


def render(e: Expr) -> str:
    if isinstance(e, Literal):
        if e.value is None:
            return "NULL"
        if isinstance(e.value, bool):
            return "true" if e.value else "false"
        if isinstance(e.value, str):
            return "'" + e.value.replace("'", "\\'") + "'"
        return _num(e.value)
    if isinstance(e, VectorLiteral):
        def rl(v):
            if isinstance(v, list):
                return "[" + ", ".join(_num(float(x)) for x in v) + "]"
            return _num(float(v))
        return "[" + ", ".join(rl(v) for v in e.values) + "]"
    if isinstance(e, Ident):
        return e.qualified
    if isinstance(e, Star):
        return f"{e.table}.*" if e.table else "*"
    if isinstance(e, BinOp):
        return f"{render(e.left)} {e.op} {render(e.right)}"
    if isinstance(e, UnOp):
        if e.op == "NOT":
            return f"NOT {render(e.operand)}"
        return f"-{render(e.operand)}"
    if isinstance(e, Lambda):
        head = e.params[0] if len(e.params) == 1 else \
            "(" + ", ".join(e.params) + ")"
        return f"{head} -> {render(e.body)}"
    if isinstance(e, FuncCall):
        # ClickHouse canonical name: count(*) -> count()
        if e.name.lower() == "count" and (not e.args or
                                          isinstance(e.args[0], Star)):
            return "count()"
        return f"{e.name}({', '.join(render(a) for a in e.args)})"
    if isinstance(e, InList):
        op = "NOT IN" if e.negated else "IN"
        return f"{render(e.expr)} {op} ({', '.join(render(i) for i in e.items)})"
    if isinstance(e, Between):
        op = "NOT BETWEEN" if e.negated else "BETWEEN"
        return f"{render(e.expr)} {op} {render(e.low)} AND {render(e.high)}"
    if isinstance(e, WindowCall):
        parts = []
        if e.partition_by:
            parts.append("PARTITION BY " + ", ".join(render(p)
                                                     for p in e.partition_by))
        if e.order_by:
            parts.append("ORDER BY " + ", ".join(
                render(o.expr) + ("" if o.ascending else " DESC")
                for o in e.order_by))
        return f"{render(e.func)} OVER ({' '.join(parts)})"
    return repr(e)


def substitute(e: Expr, mapping: dict) -> Expr:
    """Replace any subtree whose render() is in ``mapping`` with
    Ident(mapping[render]) — used to rewrite post-aggregation expressions
    against the aggregated table's columns."""
    r = render(e)
    if r in mapping:
        return Ident(mapping[r])
    if isinstance(e, BinOp):
        return BinOp(e.op, substitute(e.left, mapping),
                     substitute(e.right, mapping))
    if isinstance(e, UnOp):
        return UnOp(e.op, substitute(e.operand, mapping))
    if isinstance(e, Lambda):
        return Lambda(e.params, substitute(e.body, mapping))
    if isinstance(e, FuncCall):
        return FuncCall(e.name, [substitute(a, mapping) for a in e.args],
                        e.distinct)
    if isinstance(e, InList):
        return InList(substitute(e.expr, mapping),
                      [substitute(i, mapping) for i in e.items], e.negated)
    if isinstance(e, Between):
        return Between(substitute(e.expr, mapping),
                       substitute(e.low, mapping),
                       substitute(e.high, mapping), e.negated)
    if isinstance(e, WindowCall):
        from myscaledb_tpu_torch.sql.ast import OrderItem
        return WindowCall(
            FuncCall(e.func.name,
                     [substitute(a, mapping) for a in e.func.args],
                     e.func.distinct),
            [substitute(p, mapping) for p in e.partition_by],
            [OrderItem(substitute(o.expr, mapping), o.ascending,
                       o.nulls_last) for o in e.order_by])
    return e
