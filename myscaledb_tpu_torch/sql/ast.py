"""Copy of myscaledb_tpu/sql/ast.py (JAX-free; imports renamed to this package).

AST node definitions (reference analog: src/Parsers/IAST.h and the
ASTSelectQuery family — flattened to the subset the engine executes)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


class Expr:
    pass


@dataclass
class Literal(Expr):
    value: object            # python int/float/str/bool/None
    def __repr__(self):
        return f"Lit({self.value!r})"


@dataclass
class VectorLiteral(Expr):
    values: list             # list[float] or list[list[float]] (batch)
    def __repr__(self):
        return f"Vec({len(self.values)})"


@dataclass
class Lambda(Expr):
    """Higher-order function argument: x -> expr / (x, y) -> expr."""
    params: list             # list[str]
    body: "Expr"


@dataclass
class Ident(Expr):
    name: str
    table: Optional[str] = None
    def __repr__(self):
        return f"Id({self.table + '.' if self.table else ''}{self.name})"

    @property
    def qualified(self) -> str:
        return f"{self.table}.{self.name}" if self.table else self.name


@dataclass
class Star(Expr):
    table: Optional[str] = None


@dataclass
class BinOp(Expr):
    op: str
    left: Expr
    right: Expr
    def __repr__(self):
        return f"({self.left} {self.op} {self.right})"


@dataclass
class UnOp(Expr):
    op: str                  # 'NOT', '-'
    operand: Expr


@dataclass
class FuncCall(Expr):
    name: str
    args: list
    distinct: bool = False
    def __repr__(self):
        return f"{self.name}({', '.join(map(repr, self.args))})"


@dataclass
class WindowCall(Expr):
    func: "FuncCall"
    partition_by: list = field(default_factory=list)
    order_by: list = field(default_factory=list)   # list[OrderItem]
    window_name: str = None     # OVER w — resolved against SelectQuery.windows
    frame: tuple = None         # (mode, start, end): mode 'ROWS'|'RANGE',
                                # bounds int offsets (neg=preceding) or
                                # None=UNBOUNDED on that side; 0=CURRENT ROW
    def __repr__(self):
        return f"{self.func!r} OVER(...)"


@dataclass
class InList(Expr):
    expr: Expr
    items: list
    negated: bool = False


@dataclass
class InSubquery(Expr):
    expr: Expr
    query: object          # SelectQuery | UnionQuery
    negated: bool = False
    def __repr__(self):
        return f"{self.expr!r} IN (subquery)"


@dataclass
class ScalarSubquery(Expr):
    """(SELECT ...) used as a scalar value (reference: scalar subqueries are
    evaluated once and substituted as constants, ExecuteScalarSubqueriesVisitor,
    src/Interpreters/ExecuteScalarSubqueriesVisitor.cpp)."""
    query: object          # SelectQuery | UnionQuery
    def __repr__(self):
        return "(scalar subquery)"


@dataclass
class ExistsSubquery(Expr):
    """EXISTS (SELECT ...) — uncorrelated, evaluated once."""
    query: object
    def __repr__(self):
        return "EXISTS(subquery)"


@dataclass
class Between(Expr):
    expr: Expr
    low: Expr
    high: Expr
    negated: bool = False


@dataclass
class SelectItem:
    expr: Expr
    alias: Optional[str] = None


@dataclass
class OrderItem:
    expr: Expr
    ascending: bool = True
    nulls_last: Optional[bool] = None   # None -> default (last for ASC, first for DESC)
    fill: Optional[dict] = None         # WITH FILL {from,to,step} or {}


@dataclass
class JoinClause:
    table: str
    alias: Optional[str]
    how: str                  # 'INNER' | 'LEFT' | 'RIGHT' | 'FULL' | 'CROSS'
    strictness: str           # 'ANY' | 'ALL' | 'SEMI' | 'ANTI' | 'ASOF'
    condition: Optional[Expr] # ON expression (conjunction of equalities)
    using: Optional[list] = None  # USING (col, ...)
    subquery: object = None   # JOIN (SELECT ...) right side


@dataclass
class UnionQuery:
    selects: list             # list[SelectQuery]
    ops: list = None          # len(selects)-1 operators between them:
                              # 'UNION ALL'|'UNION DISTINCT'|'INTERSECT'|
                              # 'INTERSECT DISTINCT'|'EXCEPT'|'EXCEPT DISTINCT'
                              # None => all 'UNION ALL' (legacy)


@dataclass
class SelectQuery:
    items: list               # list[SelectItem]
    distinct: bool = False
    ctes: list = field(default_factory=list)   # [(name, SelectQuery), ...]
    with_aliases: list = field(default_factory=list)  # [(name, Expr), ...]
                              # WITH <expr> AS <name> scalar aliases
    table: Optional[str] = None
    table_alias: Optional[str] = None
    joins: list = field(default_factory=list)
    array_joins: list = field(default_factory=list)  # [(expr, alias, left)]
    where: Optional[Expr] = None
    prewhere: Optional[Expr] = None
    group_by: list = field(default_factory=list)
    grouping_sets: Optional[list] = None        # list[list[Expr]] (GROUPING SETS)
    group_modifier: Optional[str] = None        # "ROLLUP" | "CUBE"
    windows: dict = field(default_factory=dict) # named WINDOW clause specs:
                                                # name -> (partition, order, frame)
    with_totals: bool = False
    having: Optional[Expr] = None
    order_by: list = field(default_factory=list)
    limit: Optional[int] = None
    offset: int = 0
    limit_by: Optional[tuple] = None    # (n, [exprs])
    subquery: Optional["SelectQuery"] = None  # FROM (SELECT ...)
    table_function: Optional[tuple] = None    # ("numbers", (start?, n))
    settings: dict = field(default_factory=dict)   # SETTINGS k=v suffix
    final: bool = False                 # FROM t FINAL (no-op: no merging engines)
    sample: Optional[float] = None      # SAMPLE fraction (0..1) or row count


def walk(e: Expr):
    """Yield every node in an expression tree."""
    yield e
    if isinstance(e, BinOp):
        yield from walk(e.left)
        yield from walk(e.right)
    elif isinstance(e, UnOp):
        yield from walk(e.operand)
    elif isinstance(e, FuncCall):
        for a in e.args:
            yield from walk(a)
    elif isinstance(e, Lambda):
        yield from walk(e.body)
    elif isinstance(e, WindowCall):
        yield from walk(e.func)
        for p in e.partition_by:
            yield from walk(p)
        for o in e.order_by:
            yield from walk(o.expr)
    elif isinstance(e, InSubquery):
        yield from walk(e.expr)
    elif isinstance(e, InList):
        yield from walk(e.expr)
        for it in e.items:
            yield from walk(it)
    elif isinstance(e, Between):
        yield from walk(e.expr)
        yield from walk(e.low)
        yield from walk(e.high)
