"""Port of the JAX package's `query/ast.py`: a copy, with imports pointed at
this package (it imports nothing of the JAX package).

Untyped AST produced by the QL parser.

Mirrors the node taxonomy of the reference AST (library/query/base/ast.h):
literal / reference / function / unary / binary / in / between / transform /
case / like expressions, plus the query skeleton (select, source, joins,
where, group-by, having, order-by, offset, limit).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence, Union


class Expr:
    pass


@dataclass(frozen=True)
class Literal(Expr):
    value: object            # int, float, str, bool, or None
    is_uint: bool = False


@dataclass(frozen=True)
class Reference(Expr):
    name: str                # column name
    table: Optional[str] = None   # join alias qualifier


@dataclass(frozen=True)
class Placeholder(Expr):
    """A `?` parameter slot, numbered in appearance order.  Substituted
    with a literal from the `params` list before type checking (the
    NEAREST query-vector position and scalar binds both ride this)."""
    index: int


@dataclass(frozen=True)
class FunctionCall(Expr):
    name: str                # lower-cased
    args: tuple[Expr, ...]


@dataclass(frozen=True)
class UnaryOp(Expr):
    op: str                  # '-', '+', '~', 'not'
    operand: Expr


@dataclass(frozen=True)
class BinaryOp(Expr):
    op: str                  # arithmetic/comparison/logical/bitwise
    lhs: Expr
    rhs: Expr


@dataclass(frozen=True)
class InExpr(Expr):
    operands: tuple[Expr, ...]       # tuple being tested (1+ exprs)
    values: tuple[tuple, ...]        # literal tuples


@dataclass(frozen=True)
class BetweenExpr(Expr):
    operands: tuple[Expr, ...]
    ranges: tuple[tuple, ...]        # ((lower_tuple, upper_tuple), ...)
    negated: bool = False


@dataclass(frozen=True)
class TransformExpr(Expr):
    operands: tuple[Expr, ...]
    from_values: tuple[tuple, ...]
    to_values: tuple[object, ...]
    default: Optional[Expr] = None


@dataclass(frozen=True)
class CaseExpr(Expr):
    operand: Optional[Expr]                    # CASE x WHEN ... or CASE WHEN ...
    when_then: tuple[tuple[Expr, Expr], ...]
    default: Optional[Expr] = None


@dataclass(frozen=True)
class LikeExpr(Expr):
    text: Expr
    pattern: Expr
    negated: bool = False
    case_insensitive: bool = False   # ILIKE
    escape: Optional[Expr] = None


@dataclass(frozen=True)
class FrameBound:
    """One end of a ROWS frame."""
    kind: str                # unbounded_preceding | preceding | current_row
                             # | following | unbounded_following
    offset: Optional[int] = None   # literal row count for (preceding|following)


@dataclass(frozen=True)
class WindowSpec:
    partition_by: tuple[Expr, ...] = ()
    order_by: tuple["OrderItem", ...] = ()
    frame: Optional[tuple[FrameBound, FrameBound]] = None   # ROWS BETWEEN a AND b


@dataclass(frozen=True)
class WindowExpr(Expr):
    """fn(args) OVER (PARTITION BY ... ORDER BY ... [ROWS BETWEEN ...])."""
    function: str            # lower-cased window function name
    args: tuple[Expr, ...]
    spec: WindowSpec


@dataclass(frozen=True)
class SelectItem:
    expr: Expr
    alias: Optional[str] = None


@dataclass(frozen=True)
class Join:
    table: str                       # foreign table path
    alias: Optional[str]
    is_left: bool
    using: tuple[str, ...] = ()      # USING columns
    on: tuple[tuple[Expr, Expr], ...] = ()  # (self_expr, foreign_expr) pairs


@dataclass(frozen=True)
class OrderItem:
    expr: Expr
    descending: bool = False


@dataclass(frozen=True)
class QueryAst:
    select: Optional[tuple[SelectItem, ...]]   # None == SELECT *
    source: Optional[str]                      # table path (None for expression eval)
    source_alias: Optional[str] = None
    joins: tuple[Join, ...] = ()
    where: Optional[Expr] = None
    group_by: tuple[SelectItem, ...] = ()
    with_totals: bool = False
    having: Optional[Expr] = None
    order_by: tuple[OrderItem, ...] = ()
    offset: Optional[int] = None
    limit: Optional[int] = None
