"""Port of the JAX package's `query/builder.py`: a copy, with imports pointed at
this package (it imports nothing of the JAX package).

AST → typed plan IR: reference resolution, type inference, aggregate
extraction, CASE/LIKE desugaring.

Analog of the reference's expression builders + PreparePlanFragment
(library/query/base/expr_builder_v2.cpp, query_preparer.cpp).
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

from ytsaurus_tpu_torch.errors import EErrorCode, YtError
from ytsaurus_tpu_torch.query import ast
from ytsaurus_tpu_torch.query import ir
from ytsaurus_tpu_torch.query.functions import (
    AGGREGATE_FUNCTIONS,
    SCALAR_FUNCTIONS,
    TWO_ARG_AGGREGATES,
    WINDOW_FUNCTIONS,
    is_aggregate,
    is_numeric,
    promote_numeric,
    unify,
)
from ytsaurus_tpu_torch.query.parser import parse_query
from ytsaurus_tpu_torch.schema import EValueType, TableSchema, VectorType

_COMPARISONS = ("=", "!=", "<", "<=", ">", ">=")
_LOGICAL = ("and", "or")
_ARITH = ("+", "-", "*", "/", "%")
_BITWISE = ("|", "&", "^", "<<", ">>")


def render_expr(e: ast.Expr) -> str:
    """Stable source-ish rendering, used to name unaliased items (ref:
    InferName in base/query_preparer.cpp)."""
    if isinstance(e, ast.Literal):
        return repr(e.value)
    if isinstance(e, ast.Reference):
        return f"{e.table}.{e.name}" if e.table else e.name
    if isinstance(e, ast.FunctionCall):
        return f"{e.name}({', '.join(render_expr(a) for a in e.args)})"
    if isinstance(e, ast.UnaryOp):
        return f"{e.op}({render_expr(e.operand)})"
    if isinstance(e, ast.BinaryOp):
        return f"({render_expr(e.lhs)} {e.op} {render_expr(e.rhs)})"
    if isinstance(e, ast.InExpr):
        return f"({', '.join(render_expr(o) for o in e.operands)}) in {e.values!r}"
    if isinstance(e, ast.BetweenExpr):
        return f"({', '.join(render_expr(o) for o in e.operands)}) between {e.ranges!r}"
    if isinstance(e, ast.TransformExpr):
        return f"transform({', '.join(render_expr(o) for o in e.operands)})"
    if isinstance(e, ast.CaseExpr):
        return "case(...)"
    if isinstance(e, ast.LikeExpr):
        return f"{render_expr(e.text)} like {render_expr(e.pattern)}"
    if isinstance(e, ast.WindowExpr):
        return (f"{e.function}({', '.join(render_expr(a) for a in e.args)})"
                " over (...)")
    if isinstance(e, ast.Placeholder):
        return "?"
    return "expr"


def _literal_type(value, is_uint=False) -> "EValueType | VectorType":
    if value is None:
        return EValueType.null
    if isinstance(value, bool):
        return EValueType.boolean
    if isinstance(value, int):
        if is_uint:
            return EValueType.uint64
        return EValueType.int64 if -(2**63) <= value < 2**63 else EValueType.uint64
    if isinstance(value, float):
        return EValueType.double
    if isinstance(value, (str, bytes)):
        return EValueType.string
    if isinstance(value, (list, tuple)) and value and all(
            isinstance(x, (int, float)) and not isinstance(x, bool)
            for x in value):
        # A flat number sequence is a vector literal (the NEAREST query
        # vector arriving through a `?` param).
        return VectorType(len(value))
    raise YtError(f"Unsupported literal {value!r}", code=EErrorCode.QueryTypeError)


def _as_bytes(v):
    return v.encode("utf-8") if isinstance(v, str) else v


class _ExprBuilder:
    """Types expressions against a flat name→type namespace."""

    def __init__(self, namespace: Mapping[str, EValueType],
                 alias_map: Mapping[str, str] | None = None,
                 allow_aggregates: bool = False):
        # Shared (not copied): joins extend the namespace after this builder
        # is constructed and must stay visible.
        self.namespace = namespace if isinstance(namespace, dict) \
            else dict(namespace)
        self.alias_map = alias_map if isinstance(alias_map, dict) \
            else dict(alias_map or {})
        self.allow_aggregates = allow_aggregates

    def resolve_reference(self, ref: ast.Reference) -> str:
        if ref.table is not None:
            qualified = f"{ref.table}.{ref.name}"
            if qualified in self.alias_map:
                return self.alias_map[qualified]
            if qualified in self.namespace:
                return qualified
            raise YtError(f"Undefined reference {qualified!r}",
                          code=EErrorCode.QueryTypeError)
        if ref.name in self.namespace:
            return ref.name
        if ref.name in self.alias_map:
            return self.alias_map[ref.name]
        raise YtError(f"Undefined reference {ref.name!r}",
                      code=EErrorCode.QueryTypeError)

    def build(self, e: ast.Expr) -> ir.TExpr:
        if isinstance(e, ast.Literal):
            ty = _literal_type(e.value, e.is_uint)
            if isinstance(ty, VectorType):
                value = tuple(float(x) for x in e.value)
                if not all(v == v and abs(v) != float("inf") for v in value):
                    raise YtError("Non-finite component in vector literal",
                                  code=EErrorCode.QueryTypeError)
                return ir.TLiteral(type=ty, value=value)
            value = _as_bytes(e.value) if ty is EValueType.string else e.value
            return ir.TLiteral(type=ty, value=value)

        if isinstance(e, ast.Placeholder):
            raise YtError(
                f"Unbound placeholder ?{e.index}: pass `params` to "
                "select_rows/build_query", code=EErrorCode.QueryTypeError)

        if isinstance(e, ast.Reference):
            name = self.resolve_reference(e)
            return ir.TReference(type=self.namespace[name], name=name)

        if isinstance(e, ast.UnaryOp):
            operand = self.build(e.operand)
            if e.op == "not":
                if operand.type not in (EValueType.boolean, EValueType.null):
                    raise YtError("NOT requires a boolean operand",
                                  code=EErrorCode.QueryTypeError)
                return ir.TUnary(type=EValueType.boolean, op="not", operand=operand)
            if e.op == "-":
                if not is_numeric(operand.type) and operand.type is not EValueType.null:
                    raise YtError("Unary minus requires a numeric operand",
                                  code=EErrorCode.QueryTypeError)
                return ir.TUnary(type=operand.type, op="-", operand=operand)
            if e.op == "~":
                if operand.type not in (EValueType.int64, EValueType.uint64,
                                        EValueType.null):
                    raise YtError("Bitwise NOT requires an integer operand",
                                  code=EErrorCode.QueryTypeError)
                return ir.TUnary(type=operand.type, op="~", operand=operand)
            raise YtError(f"Unknown unary operator {e.op!r}")

        if isinstance(e, ast.BinaryOp):
            lhs, rhs = self.build(e.lhs), self.build(e.rhs)
            op = e.op
            if op in _LOGICAL:
                for side in (lhs, rhs):
                    if side.type not in (EValueType.boolean, EValueType.null):
                        raise YtError(f"{op.upper()} requires boolean operands",
                                      code=EErrorCode.QueryTypeError)
                return ir.TBinary(type=EValueType.boolean, op=op, lhs=lhs, rhs=rhs)
            if op in _COMPARISONS:
                if isinstance(lhs.type, VectorType) or \
                        isinstance(rhs.type, VectorType):
                    raise YtError(
                        f"Vectors are not comparable with {op!r}; use a "
                        "distance function (l2_distance/cosine_distance/"
                        "dot_product)", code=EErrorCode.QueryUnsupported)
                unify(lhs.type, rhs.type, f"comparison {op!r}")
                return ir.TBinary(type=EValueType.boolean, op=op, lhs=lhs, rhs=rhs)
            if op in _ARITH:
                ty = promote_numeric(lhs.type, rhs.type, f"operator {op!r}")
                return ir.TBinary(type=ty, op=op, lhs=lhs, rhs=rhs)
            if op in _BITWISE:
                for side in (lhs, rhs):
                    if side.type not in (EValueType.int64, EValueType.uint64,
                                        EValueType.null):
                        raise YtError(f"Operator {op!r} requires integer operands",
                                      code=EErrorCode.QueryTypeError)
                ty = promote_numeric(lhs.type, rhs.type, f"operator {op!r}")
                return ir.TBinary(type=ty, op=op, lhs=lhs, rhs=rhs)
            raise YtError(f"Unknown operator {op!r}")

        if isinstance(e, ast.FunctionCall):
            if is_aggregate(e.name):
                raise YtError(
                    f"Aggregate function {e.name!r} is not allowed here",
                    code=EErrorCode.QueryTypeError)
            return self.build_scalar_call(e)

        if isinstance(e, ast.InExpr):
            operands = tuple(self.build(o) for o in e.operands)
            self._check_tuples(operands, e.values, "IN")
            values = tuple(tuple(_as_bytes(v) for v in tup) for tup in e.values)
            return ir.TIn(type=EValueType.boolean, operands=operands, values=values)

        if isinstance(e, ast.BetweenExpr):
            operands = tuple(self.build(o) for o in e.operands)
            for lower, upper in e.ranges:
                self._check_tuples(operands, [lower, upper], "BETWEEN",
                                   allow_prefix=True)
            ranges = tuple(
                (tuple(_as_bytes(v) for v in lo), tuple(_as_bytes(v) for v in up))
                for lo, up in e.ranges)
            return ir.TBetween(type=EValueType.boolean, operands=operands,
                               ranges=ranges, negated=e.negated)

        if isinstance(e, ast.TransformExpr):
            operands = tuple(self.build(o) for o in e.operands)
            self._check_tuples(operands, e.from_values, "TRANSFORM")
            default = self.build(e.default) if e.default is not None else None
            to_types = {_literal_type(v) for v in e.to_values if v is not None}
            ty = EValueType.null
            for t in to_types:
                ty = unify(ty, t, "TRANSFORM values")
            if default is not None:
                ty = unify(ty, default.type, "TRANSFORM default")
            to_values = tuple(
                _as_bytes(v) if isinstance(v, (str, bytes)) else v
                for v in e.to_values)
            return ir.TTransform(
                type=ty, operands=operands,
                from_values=tuple(tuple(_as_bytes(v) for v in tup)
                                  for tup in e.from_values),
                to_values=to_values, default=default)

        if isinstance(e, ast.CaseExpr):
            return self.build(_desugar_case(e))

        if isinstance(e, ast.WindowExpr):
            raise YtError(
                "Window functions are only allowed in the SELECT list "
                "of a non-grouped query",
                code=EErrorCode.QueryTypeError)

        if isinstance(e, ast.LikeExpr):
            text = self.build(e.text)
            if text.type not in (EValueType.string, EValueType.null):
                raise YtError("LIKE requires a string operand",
                              code=EErrorCode.QueryTypeError)
            if not isinstance(e.pattern, ast.Literal) or \
                    _literal_type(e.pattern.value) is not EValueType.string:
                raise YtError("LIKE pattern must be a string literal",
                              code=EErrorCode.QueryUnsupported)
            pattern = _as_bytes(e.pattern.value)
            if e.escape is not None:
                raise YtError("LIKE ESCAPE is not supported yet",
                              code=EErrorCode.QueryUnsupported)
            return ir.TStringPredicate(
                type=EValueType.boolean, operand=text, kind="like",
                pattern=pattern, case_insensitive=e.case_insensitive,
                negated=e.negated)

        raise YtError(f"Cannot build expression from {type(e).__name__}")

    def build_scalar_call(self, e: ast.FunctionCall) -> ir.TExpr:
        # String predicates get vocabulary-level nodes.
        if e.name in ("is_prefix", "is_substr") and len(e.args) == 2 and \
                isinstance(e.args[0], ast.Literal):
            operand = self.build(e.args[1])
            if operand.type not in (EValueType.string, EValueType.null):
                raise YtError(f"{e.name} requires a string operand",
                              code=EErrorCode.QueryTypeError)
            kind = "prefix" if e.name == "is_prefix" else "substr"
            return ir.TStringPredicate(
                type=EValueType.boolean, operand=operand, kind=kind,
                pattern=_as_bytes(e.args[0].value))
        if e.name == "regex_full_match" and len(e.args) == 2 and \
                isinstance(e.args[0], ast.Literal):
            operand = self.build(e.args[1])
            return ir.TStringPredicate(
                type=EValueType.boolean, operand=operand, kind="regex",
                pattern=_as_bytes(e.args[0].value))
        fn = SCALAR_FUNCTIONS.get(e.name)
        if fn is None:
            raise YtError(f"Unknown function {e.name!r}",
                          code=EErrorCode.QueryTypeError)
        if not (fn.min_args <= len(e.args) <= fn.max_args):
            raise YtError(
                f"Function {e.name!r} expects {fn.min_args}"
                + (f"..{fn.max_args}" if fn.max_args != fn.min_args else "")
                + f" arguments, got {len(e.args)}",
                code=EErrorCode.QueryTypeError)
        args = tuple(self.build(a) for a in e.args)
        result = fn.infer(tuple(a.type for a in args))
        return ir.TFunction(type=result, name=e.name, args=args)

    def _check_tuples(self, operands, tuples, context, allow_prefix=False):
        for operand in operands:
            if isinstance(operand.type, VectorType):
                raise YtError(f"{context} does not accept vector operands",
                              code=EErrorCode.QueryUnsupported)
        for tup in tuples:
            if allow_prefix:
                if len(tup) > len(operands):
                    raise YtError(f"{context} tuple wider than operand list",
                                  code=EErrorCode.QueryTypeError)
            elif len(tup) != len(operands):
                raise YtError(f"{context} tuple arity mismatch",
                              code=EErrorCode.QueryTypeError)
            for operand, v in zip(operands, tup):
                unify(operand.type, _literal_type(v), context)


def _desugar_case(e: ast.CaseExpr) -> ast.Expr:
    """CASE → nested if(); ref does the same in expr builders."""
    result: ast.Expr = e.default if e.default is not None else ast.Literal(None)
    for cond, value in reversed(e.when_then):
        if e.operand is not None:
            cond = ast.BinaryOp("=", e.operand, cond)
        result = ast.FunctionCall("if", (cond, value, result))
    return result


class _AggregatingBuilder(_ExprBuilder):
    """Builds post-GROUP-BY expressions: group-item subtrees become references,
    aggregate calls become AggregateItem slots (evaluated in the base
    namespace), everything else must type-check in the post-group namespace."""

    def __init__(self, base_builder: _ExprBuilder,
                 group_exprs: dict[ast.Expr, str],
                 group_namespace: Mapping[str, EValueType]):
        super().__init__(group_namespace, alias_map={})
        self.base_builder = base_builder
        self.group_exprs = group_exprs  # AST expr -> group item name
        self.aggregates: list[ir.AggregateItem] = []
        self._agg_cache: dict[tuple, str] = {}

    def build(self, e: ast.Expr) -> ir.TExpr:
        name = self.group_exprs.get(e)
        if name is not None:
            return ir.TReference(type=self.namespace[name], name=name)
        if isinstance(e, ast.FunctionCall) and is_aggregate(e.name):
            return self.build_aggregate(e)
        if isinstance(e, ast.Reference):
            # A bare column must be a group key (possibly under its alias).
            resolved = self.namespace.get(e.name)
            if resolved is None:
                raise YtError(
                    f"Column {render_expr(e)!r} is neither aggregated nor in "
                    f"GROUP BY", code=EErrorCode.QueryTypeError)
            return ir.TReference(type=resolved, name=e.name)
        if isinstance(e, ast.CaseExpr):
            return self.build(_desugar_case(e))
        if isinstance(e, (ast.Literal,)):
            return super().build(e)
        if isinstance(e, ast.UnaryOp):
            return super().build(e)
        if isinstance(e, ast.BinaryOp):
            return super().build(e)
        if isinstance(e, ast.FunctionCall):
            return super().build(e)
        if isinstance(e, (ast.InExpr, ast.BetweenExpr, ast.TransformExpr,
                          ast.LikeExpr)):
            return super().build(e)
        raise YtError(f"Cannot build post-group expression {render_expr(e)!r}")

    def build_aggregate(self, e: ast.FunctionCall) -> ir.TExpr:
        fn = AGGREGATE_FUNCTIONS[e.name]
        two_arg = e.name in TWO_ARG_AGGREGATES
        expected = 2 if two_arg else 1
        if len(e.args) != expected:
            raise YtError(
                f"Aggregate {e.name!r} expects exactly {expected} argument(s)",
                code=EErrorCode.QueryTypeError)
        argument = self.base_builder.build(e.args[0])
        by_argument = None
        if two_arg:
            by_argument = self.base_builder.build(e.args[1])
            if not by_argument.type.is_comparable:
                raise YtError(f"{e.name} comparison key must be comparable",
                              code=EErrorCode.QueryTypeError)
        key = (e.name, ir._repr_expr(argument),
               ir._repr_expr(by_argument) if by_argument else "")
        slot = self._agg_cache.get(key)
        if slot is None:
            slot = f"_agg{len(self.aggregates)}"
            self.aggregates.append(ir.AggregateItem(
                name=slot, function=e.name, argument=argument,
                type=fn.infer_result(argument.type),
                state_type=fn.infer_state(argument.type),
                by_argument=by_argument))
            self._agg_cache[key] = slot
            self.namespace[slot] = self.aggregates[-1].type
        return ir.TReference(type=self.namespace[slot], name=slot)


def _normalize_frame(frame: "tuple[ast.FrameBound, ast.FrameBound]"
                     ) -> ir.Frame:
    """ROWS BETWEEN bounds → the signed-offset Frame tuple."""
    lower, upper = frame

    def conv(bound: ast.FrameBound, is_start: bool) -> tuple[str, int]:
        if bound.kind == "unbounded_preceding":
            if not is_start:
                raise YtError("Frame end cannot be UNBOUNDED PRECEDING",
                              code=EErrorCode.QueryParseError)
            return ("unbounded", 0)
        if bound.kind == "unbounded_following":
            if is_start:
                raise YtError("Frame start cannot be UNBOUNDED FOLLOWING",
                              code=EErrorCode.QueryParseError)
            return ("unbounded", 0)
        if bound.kind == "current_row":
            return ("offset", 0)
        if bound.kind == "preceding":
            return ("offset", -int(bound.offset))
        if bound.kind == "following":
            return ("offset", int(bound.offset))
        raise YtError(f"Unknown frame bound {bound.kind!r}")

    lo_kind, lo_off = conv(lower, True)
    hi_kind, hi_off = conv(upper, False)
    if lo_kind == "offset" and hi_kind == "offset" and lo_off > hi_off:
        raise YtError("Frame start must not follow frame end",
                      code=EErrorCode.QueryParseError)
    return (lo_kind, lo_off, hi_kind, hi_off)


class _WindowBuilder(_ExprBuilder):
    """Builds SELECT/ORDER expressions of a non-grouped query, turning
    window calls into WindowItem slots (the analog of how
    _AggregatingBuilder extracts AggregateItems).  All window calls in a
    query must share one (PARTITION BY, ORDER BY) spec — one sort serves
    every item; per-item ROWS frames may differ."""

    def __init__(self, base_builder: _ExprBuilder):
        super().__init__(base_builder.namespace, base_builder.alias_map)
        self.base_builder = base_builder
        self.partition: "Optional[tuple[ast.Expr, ...]]" = None
        self.order: "Optional[tuple[ast.OrderItem, ...]]" = None
        self.items: list[ir.WindowItem] = []
        self._cache: dict[tuple, str] = {}

    def build(self, e: ast.Expr) -> ir.TExpr:
        if isinstance(e, ast.WindowExpr):
            return self.build_window(e)
        if isinstance(e, ast.CaseExpr):
            return self.build(_desugar_case(e))
        return super().build(e)

    def build_window(self, e: ast.WindowExpr) -> ir.TExpr:
        fn = WINDOW_FUNCTIONS.get(e.function)
        if fn is None:
            raise YtError(f"Unknown window function {e.function!r}",
                          code=EErrorCode.QueryTypeError)
        if not (fn.min_args <= len(e.args) <= fn.max_args):
            raise YtError(
                f"Window function {e.function!r} expects "
                f"{fn.min_args}..{fn.max_args} arguments, got {len(e.args)}",
                code=EErrorCode.QueryTypeError)
        # One shared partition spec per query; ONE common ORDER BY among
        # the items that order at all (an order-less item has a whole-
        # partition frame, so the shared sort cannot change its result).
        if self.partition is None:
            self.partition = e.spec.partition_by
        elif self.partition != e.spec.partition_by:
            raise YtError(
                "All window functions in one query must share the same "
                "PARTITION BY spec", code=EErrorCode.QueryUnsupported)
        if e.spec.order_by:
            if self.order is None:
                self.order = e.spec.order_by
            elif self.order != e.spec.order_by:
                raise YtError(
                    "All ordered window functions in one query must share "
                    "the same ORDER BY spec",
                    code=EErrorCode.QueryUnsupported)
        if fn.needs_order and not e.spec.order_by:
            raise YtError(f"{e.function} requires ORDER BY in OVER (...)",
                          code=EErrorCode.QueryTypeError)
        if e.spec.frame is not None and not fn.is_aggregate:
            raise YtError(
                f"{e.function} does not accept a ROWS frame",
                code=EErrorCode.QueryTypeError)
        if e.spec.frame is not None and not e.spec.order_by:
            raise YtError("A ROWS frame requires ORDER BY in OVER (...)",
                          code=EErrorCode.QueryTypeError)

        argument = None
        offset = 1
        default = None
        if e.function in ("lag", "lead"):
            argument = self.base_builder.build(e.args[0])
            if len(e.args) > 1:
                if not isinstance(e.args[1], ast.Literal) or \
                        not isinstance(e.args[1].value, int) or \
                        isinstance(e.args[1].value, bool) or \
                        e.args[1].value < 0:
                    raise YtError(
                        f"{e.function} offset must be a non-negative "
                        "integer literal", code=EErrorCode.QueryTypeError)
                offset = int(e.args[1].value)
            if len(e.args) > 2:
                default = self.base_builder.build(e.args[2])
                unify(argument.type, default.type, f"{e.function} default")
            result_type = argument.type if argument.type is not \
                EValueType.null else \
                (default.type if default is not None else argument.type)
        elif fn.min_args > 0 or e.args:
            argument = self.base_builder.build(e.args[0]) if e.args else None
            result_type = fn.infer_result(
                argument.type if argument is not None else None)
        else:
            result_type = fn.infer_result(None)

        if fn.is_aggregate:
            # Implicit default with ORDER BY = the standard RANGE
            # UNBOUNDED PRECEDING..CURRENT ROW: the frame extends to the
            # end of the current PEER group, so tied order keys share
            # one value.  An explicit ROWS frame stays row-exact.
            frame = _normalize_frame(e.spec.frame) \
                if e.spec.frame is not None else \
                (ir.PEERS_FRAME if e.spec.order_by
                 else ir.WHOLE_PARTITION_FRAME)
        else:
            frame = ir.WHOLE_PARTITION_FRAME

        key = (e.function,
               ir._repr_expr(argument) if argument is not None else "",
               frame, offset,
               ir._repr_expr(default) if default is not None else "")
        slot = self._cache.get(key)
        if slot is None:
            slot = f"_win{len(self.items)}"
            self.items.append(ir.WindowItem(
                name=slot, function=e.function, argument=argument,
                type=result_type, frame=frame, offset=offset,
                default=default))
            self._cache[key] = slot
            self.namespace[slot] = result_type
        return ir.TReference(type=self.namespace[slot], name=slot)

    def window_clause(self) -> "Optional[ir.WindowClause]":
        if not self.items:
            return None
        partition_items = tuple(
            ir.NamedExpr(name=f"_winp{i}", expr=self.base_builder.build(p))
            for i, p in enumerate(self.partition or ()))
        order_items = tuple(
            ir.OrderItem(expr=self.base_builder.build(oi.expr),
                         descending=oi.descending)
            for oi in (self.order or ()))
        return ir.WindowClause(partition_items=partition_items,
                               order_items=order_items,
                               items=tuple(self.items))


def _walk_placeholders(node, visit):
    """Generic AST walk: calls `visit` on every Placeholder; returns the
    (possibly rebuilt) node when visit returns a replacement, else the
    original object (identity-preserving so untouched trees stay shared)."""
    import dataclasses as _dc
    if isinstance(node, ast.Placeholder):
        return visit(node)
    if _dc.is_dataclass(node) and not isinstance(node, type):
        changes = {}
        for f in _dc.fields(node):
            old = getattr(node, f.name)
            new = _walk_placeholders(old, visit)
            if new is not old:
                changes[f.name] = new
        return _dc.replace(node, **changes) if changes else node
    if isinstance(node, tuple):
        rebuilt = tuple(_walk_placeholders(x, visit) for x in node)
        return rebuilt if any(a is not b for a, b in zip(rebuilt, node)) \
            else node
    return node


def substitute_params(q: ast.QueryAst,
                      params: "Optional[Sequence]") -> ast.QueryAst:
    """Replace `?` placeholders with literals from `params` (positional).
    A flat number sequence becomes a vector literal; scalars keep their
    natural literal type.  Loud on arity mismatch either way."""
    seen: set[int] = set()

    def visit(p: ast.Placeholder):
        seen.add(p.index)
        if params is None or p.index >= len(params):
            raise YtError(
                f"Query has placeholder ?{p.index} but only "
                f"{0 if params is None else len(params)} params were given",
                code=EErrorCode.QueryTypeError)
        value = params[p.index]
        if isinstance(value, (list, tuple)):
            return ast.Literal(tuple(float(x) for x in value))
        return ast.Literal(value)

    out = _walk_placeholders(q, visit)
    if params is not None and len(params) > len(seen):
        raise YtError(
            f"Got {len(params)} params for {len(seen)} placeholders",
            code=EErrorCode.QueryTypeError)
    return out


def build_query(source: str | ast.QueryAst,
                schemas: Mapping[str, TableSchema],
                params: "Optional[Sequence]" = None) -> ir.Query:
    """Parse + build a typed plan.

    `schemas` maps table path → schema; the FROM table plus every JOIN table
    must be present.  `params` binds `?` placeholders positionally (the
    NEAREST query vector rides here as a list of floats).
    """
    q = parse_query(source) if isinstance(source, str) else source
    if params is not None:
        q = substitute_params(q, params)
    if q.source is None:
        raise YtError("Query has no FROM clause", code=EErrorCode.QueryParseError)
    if q.source not in schemas:
        raise YtError(f"Unknown table {q.source!r}", code=EErrorCode.ResolveError)
    self_schema = schemas[q.source]

    # Flat combined namespace: self columns + qualified foreign columns.
    namespace: dict[str, EValueType] = {
        c.name: c.type for c in self_schema}
    alias_map: dict[str, str] = {}
    join_clauses: list[ir.JoinClause] = []
    base_builder = _ExprBuilder(namespace, alias_map)

    for join in q.joins:
        if join.table not in schemas:
            raise YtError(f"Unknown join table {join.table!r}",
                          code=EErrorCode.ResolveError)
        foreign_schema = schemas[join.table]
        alias = join.alias
        self_eqs: list[ir.TExpr] = []
        foreign_eqs: list[ir.TExpr] = []
        foreign_builder = _ExprBuilder(
            {c.name: c.type for c in foreign_schema},
            alias_map={f"{join.alias}.{c.name}": c.name
                       for c in foreign_schema} if join.alias else {})
        if join.using:
            skip_columns = set(join.using)
            for name in join.using:
                self_eqs.append(base_builder.build(ast.Reference(name=name)))
                foreign_eqs.append(foreign_builder.build(ast.Reference(name=name)))
        else:
            skip_columns = set()
            if not join.on:
                raise YtError("JOIN requires USING or ON",
                              code=EErrorCode.QueryParseError)
            for lhs, rhs in join.on:
                self_eqs.append(base_builder.build(lhs))
                foreign_eqs.append(foreign_builder.build(rhs))
        # Merge foreign columns into the flat namespace.
        foreign_columns = []
        for col in foreign_schema:
            if col.name in skip_columns:
                continue
            flat = f"{alias}.{col.name}" if alias else col.name
            if flat in namespace:
                raise YtError(f"Ambiguous column {flat!r} from join; use an alias",
                              code=EErrorCode.QueryTypeError)
            namespace[flat] = col.type
            foreign_columns.append(col.name)
            if alias:
                alias_map[f"{alias}.{col.name}"] = flat
                # Unqualified access allowed when unambiguous.
                if col.name not in namespace and col.name not in alias_map:
                    alias_map[col.name] = flat
        for eq in zip(self_eqs, foreign_eqs):
            unify(eq[0].type, eq[1].type, "JOIN equation")
        join_clauses.append(ir.JoinClause(
            foreign_table=join.table, foreign_schema=foreign_schema,
            alias=alias, self_equations=tuple(self_eqs),
            foreign_equations=tuple(foreign_eqs),
            foreign_columns=tuple(foreign_columns), is_left=join.is_left))

    combined_schema = TableSchema.make(
        [(name, ty.value) for name, ty in namespace.items()])

    where = base_builder.build(q.where) if q.where is not None else None
    if where is not None and where.type not in (EValueType.boolean, EValueType.null):
        raise YtError("WHERE predicate must be boolean",
                      code=EErrorCode.QueryTypeError)

    group_clause = None
    having = None
    final_builder: _ExprBuilder
    if q.group_by:
        group_items = []
        group_exprs: dict[ast.Expr, str] = {}
        group_namespace: dict[str, EValueType] = {}
        for i, item in enumerate(q.group_by):
            name = item.alias or render_expr(item.expr)
            expr = base_builder.build(item.expr)
            if isinstance(expr.type, VectorType):
                raise YtError("GROUP BY does not accept vector expressions",
                              code=EErrorCode.QueryUnsupported)
            group_items.append(ir.NamedExpr(name=name, expr=expr))
            group_exprs[item.expr] = name
            # An aliased group item is also addressable by its alias.
            if item.alias is not None:
                group_exprs[ast.Reference(name=item.alias)] = name
            group_namespace[name] = expr.type
        agg_builder = _AggregatingBuilder(base_builder, group_exprs,
                                          group_namespace)
        if q.having is not None:
            having = agg_builder.build(q.having)
            if having.type not in (EValueType.boolean, EValueType.null):
                raise YtError("HAVING predicate must be boolean",
                              code=EErrorCode.QueryTypeError)
        final_builder = agg_builder
    else:
        if q.having is not None:
            raise YtError("HAVING requires GROUP BY",
                          code=EErrorCode.QueryParseError)
        # Non-grouped queries may carry window calls in the SELECT list.
        final_builder = _WindowBuilder(base_builder)

    project = None
    if q.select is not None:
        items = []
        for item in q.select:
            expr = final_builder.build(item.expr)
            if isinstance(expr.type, VectorType) and \
                    not isinstance(expr, ir.TReference):
                raise YtError(
                    "Vector expressions in SELECT must be plain column "
                    "references", code=EErrorCode.QueryUnsupported)
            name = item.alias or render_expr(item.expr)
            items.append(ir.NamedExpr(name=name, expr=expr))
        project = ir.ProjectClause(items=tuple(items))

    order = None
    if q.order_by:
        order_items = []
        for oi in q.order_by:
            expr = final_builder.build(oi.expr)
            if isinstance(expr.type, VectorType):
                raise YtError(
                    "ORDER BY does not accept a raw vector (no total "
                    "order); order by a distance function instead",
                    code=EErrorCode.QueryUnsupported)
            order_items.append(ir.OrderItem(expr=expr, descending=oi.descending))
        order = ir.OrderClause(items=tuple(order_items))

    if q.group_by:
        agg_builder = final_builder  # type: ignore[assignment]
        group_clause = ir.GroupClause(
            group_items=tuple(group_items),
            aggregate_items=tuple(agg_builder.aggregates),  # type: ignore[attr-defined]
            totals=q.with_totals)

    if q.order_by and q.limit is None:
        raise YtError("ORDER BY requires LIMIT (ref QL semantics)",
                      code=EErrorCode.QueryParseError)

    window_clause = None
    if isinstance(final_builder, _WindowBuilder):
        window_clause = final_builder.window_clause()

    return ir.Query(
        schema=combined_schema,
        source=q.source,
        joins=tuple(join_clauses),
        where=where,
        group=group_clause,
        window=window_clause,
        having=having,
        order=order,
        project=project,
        offset=q.offset or 0,
        limit=q.limit)
