"""Port of the JAX package's `query/parser.py`: a copy, with imports pointed at
this package (it imports nothing of the JAX package).

QL parser: token stream → QueryAst.

Hand-written Pratt parser over the same grammar surface as the reference
(library/query/base/parser.ypp): optional SELECT list, FROM source, LEFT/inner
JOIN ... USING/ON, WHERE, GROUP BY [WITH TOTALS], HAVING, ORDER BY ASC/DESC,
OFFSET, LIMIT; the full expression language incl. IN / BETWEEN / TRANSFORM /
CASE / LIKE and tuple forms.
"""

from __future__ import annotations

from typing import Optional

from ytsaurus_tpu_torch.errors import EErrorCode, YtError
from ytsaurus_tpu_torch.query import ast
from ytsaurus_tpu_torch.query.lexer import Token, TokenKind, tokenize

# Binary operator precedence (higher binds tighter).
_PRECEDENCE = {
    "or": 1,
    "and": 2,
    # NOT handled as prefix at level 3
    "=": 4, "!=": 4, "<>": 4, "<": 4, "<=": 4, ">": 4, ">=": 4,
    "|": 5,
    "^": 6,
    "&": 7,
    "<<": 8, ">>": 8,
    "+": 9, "-": 9,
    "*": 10, "/": 10, "%": 10,
}

_COMPARISON_LEVEL = 4

# NEAREST(col, q, k [, metric]) desugars to ORDER BY <fn>(col, q) LIMIT k.
# Similarity metrics (dot) sort descending; distances ascending.
_NEAREST_METRICS = {
    "l2": ("l2_distance", False),
    "euclidean": ("l2_distance", False),
    "cosine": ("cosine_distance", False),
    "dot": ("dot_product", True),
    "inner": ("dot_product", True),
}


class _Parser:
    def __init__(self, source: str):
        self.source = source
        self.tokens = tokenize(source)
        self.pos = 0
        self._placeholders = 0

    # --- token helpers --------------------------------------------------------

    @property
    def cur(self) -> Token:
        return self.tokens[self.pos]

    def advance(self) -> Token:
        tok = self.cur
        self.pos += 1
        return tok

    def error(self, message: str) -> YtError:
        tok = self.cur
        return YtError(f"{message} (near position {tok.pos} in {self.source!r})",
                       code=EErrorCode.QueryParseError)

    def expect_op(self, op: str) -> None:
        if not self.cur.is_op(op):
            raise self.error(f"Expected {op!r}")
        self.advance()

    def expect_keyword(self, kw: str) -> None:
        if not self.cur.is_keyword(kw):
            raise self.error(f"Expected {kw.upper()}")
        self.advance()

    def accept_op(self, op: str) -> bool:
        if self.cur.is_op(op):
            self.advance()
            return True
        return False

    def accept_keyword(self, *kws: str) -> Optional[str]:
        if self.cur.is_keyword(*kws):
            return self.advance().value
        return None

    # OVER / PARTITION / ROWS / UNBOUNDED / PRECEDING / FOLLOWING / CURRENT /
    # ROW are contextual words (matched case-insensitively where the window
    # grammar expects them) rather than reserved keywords, so existing
    # queries may keep using them as column names.

    def _at_word(self, *names: str) -> bool:
        tok = self.cur
        return tok.kind in (TokenKind.IDENT, TokenKind.KEYWORD) and \
            isinstance(tok.value, str) and tok.value.lower() in names

    def accept_word(self, *names: str) -> Optional[str]:
        if self._at_word(*names):
            return self.advance().value.lower()
        return None

    def expect_word(self, name: str) -> None:
        if self.accept_word(name) is None:
            raise self.error(f"Expected {name.upper()}")

    # --- expressions ----------------------------------------------------------

    def parse_expression(self, min_prec: int = 0) -> ast.Expr:
        lhs = self.parse_prefix(min_prec)
        while True:
            tok = self.cur
            op = None
            if tok.kind is TokenKind.OP and tok.value in _PRECEDENCE:
                op = tok.value
            elif tok.is_keyword("and", "or"):
                op = tok.value
            elif tok.is_keyword("in", "between", "like", "ilike", "rlike",
                                "regexp", "not"):
                if _COMPARISON_LEVEL < min_prec:
                    break
                lhs = self.parse_predicate_suffix(lhs)
                continue   # let the main loop handle trailing AND/OR etc.
            if op is None:
                break
            prec = _PRECEDENCE[op]
            if prec < min_prec:
                break
            self.advance()
            if op in ("=", "!=", "<>", "<", "<=", ">", ">="):
                rhs = self.parse_expression(prec + 1)
                lhs = ast.BinaryOp("!=" if op == "<>" else op, lhs, rhs)
            else:
                rhs = self.parse_expression(prec + 1)
                lhs = ast.BinaryOp(op, lhs, rhs)
        return lhs

    def parse_predicate_suffix(self, lhs: ast.Expr) -> ast.Expr:
        negated = self.accept_keyword("not") is not None
        if self.accept_keyword("in"):
            values = self.parse_literal_tuple_list()
            operands = lhs.operands if isinstance(lhs, _TupleExpr) else (lhs,)
            expr: ast.Expr = ast.InExpr(operands=operands, values=values)
            if negated:
                expr = ast.UnaryOp("not", expr)
            return expr
        if self.accept_keyword("between"):
            operands = lhs.operands if isinstance(lhs, _TupleExpr) else (lhs,)
            if self.cur.is_op("(") and len(operands) > 1:
                # Tuple form: (a,b) BETWEEN ((l...) AND (u...), ...)
                ranges = self.parse_between_range_list()
            else:
                lower = self.parse_literal_tuple(single_ok=True)
                self.expect_keyword("and")
                upper = self.parse_literal_tuple(single_ok=True)
                ranges = ((lower, upper),)
            return ast.BetweenExpr(operands=operands, ranges=ranges,
                                   negated=negated)
        if self.cur.is_keyword("like", "ilike", "rlike", "regexp"):
            kind = self.advance().value
            pattern = self.parse_expression(_COMPARISON_LEVEL + 1)
            escape = None
            if self.accept_keyword("escape"):
                escape = self.parse_expression(_COMPARISON_LEVEL + 1)
            expr = ast.LikeExpr(text=lhs, pattern=pattern, negated=negated,
                                case_insensitive=(kind == "ilike"),
                                escape=escape)
            if kind in ("rlike", "regexp"):
                expr = ast.FunctionCall(
                    "regex_full_match", (pattern, lhs))
                if negated:
                    expr = ast.UnaryOp("not", expr)
            return expr
        raise self.error("Expected IN, BETWEEN or LIKE after NOT")

    def parse_prefix(self, min_prec: int = 0) -> ast.Expr:
        tok = self.cur
        if tok.is_op("-"):
            self.advance()
            operand = self.parse_expression(11)
            if isinstance(operand, ast.Literal) and isinstance(operand.value, (int, float)) \
                    and not isinstance(operand.value, bool):
                return ast.Literal(-operand.value, is_uint=False)
            return ast.UnaryOp("-", operand)
        if tok.is_op("+"):
            self.advance()
            return self.parse_expression(11)
        if tok.is_op("~"):
            self.advance()
            return ast.UnaryOp("~", self.parse_expression(11))
        if tok.is_keyword("not"):
            self.advance()
            return ast.UnaryOp("not", self.parse_expression(3))
        if tok.is_op("("):
            self.advance()
            exprs = [self.parse_expression()]
            while self.accept_op(","):
                exprs.append(self.parse_expression())
            self.expect_op(")")
            if len(exprs) == 1:
                return exprs[0]
            return _TupleExpr(tuple(exprs))
        if tok.kind is TokenKind.INT:
            self.advance()
            return ast.Literal(tok.value)
        if tok.kind is TokenKind.UINT:
            self.advance()
            return ast.Literal(tok.value, is_uint=True)
        if tok.kind is TokenKind.DOUBLE:
            self.advance()
            return ast.Literal(float(tok.value))
        if tok.kind is TokenKind.STRING:
            self.advance()
            return ast.Literal(tok.value)
        if tok.is_keyword("true"):
            self.advance()
            return ast.Literal(True)
        if tok.is_keyword("false"):
            self.advance()
            return ast.Literal(False)
        if tok.is_keyword("null"):
            self.advance()
            return ast.Literal(None)
        if tok.is_op("#"):
            self.advance()
            return ast.Literal(None)
        if tok.is_op("?"):
            self.advance()
            index = self._placeholders
            self._placeholders += 1
            return ast.Placeholder(index)
        if tok.is_keyword("case"):
            return self.parse_case()
        if tok.is_keyword("transform"):
            return self.parse_transform()
        if tok.is_keyword("if"):
            self.advance()
            self.expect_op("(")
            args = [self.parse_expression()]
            while self.accept_op(","):
                args.append(self.parse_expression())
            self.expect_op(")")
            return ast.FunctionCall("if", tuple(args))
        if tok.kind is TokenKind.IDENT:
            self.advance()
            name = tok.value
            # Function call.
            if self.cur.is_op("("):
                self.advance()
                args: list[ast.Expr] = []
                if not self.cur.is_op(")"):
                    # count(*) style
                    if self.cur.is_op("*"):
                        self.advance()
                        args.append(ast.Literal(1))
                    else:
                        args.append(self.parse_expression())
                        while self.accept_op(","):
                            args.append(self.parse_expression())
                self.expect_op(")")
                call = ast.FunctionCall(name.lower(), tuple(args))
                if self._at_word("over") and \
                        self.tokens[self.pos + 1].is_op("("):
                    return self.parse_over(call)
                return call
            # Qualified reference t.col.
            if self.cur.is_op("."):
                self.advance()
                col = self.advance()
                if col.kind is not TokenKind.IDENT:
                    raise self.error("Expected column name after '.'")
                return ast.Reference(name=col.value, table=name)
            return ast.Reference(name=name)
        raise self.error(f"Unexpected token {tok.value!r}")

    def parse_over(self, call: ast.FunctionCall) -> ast.Expr:
        """fn(args) OVER (PARTITION BY e, ... ORDER BY e [ASC|DESC], ...
        [ROWS BETWEEN bound AND bound])."""
        self.expect_word("over")
        self.expect_op("(")
        partition: list[ast.Expr] = []
        if self.accept_word("partition"):
            self.expect_keyword("by")
            partition.append(self.parse_expression())
            while self.accept_op(","):
                partition.append(self.parse_expression())
        order_items: list[ast.OrderItem] = []
        if self.accept_keyword("order"):
            self.expect_keyword("by")
            while True:
                expr = self.parse_expression()
                desc = False
                if self.accept_keyword("desc"):
                    desc = True
                elif self.accept_keyword("asc"):
                    pass
                order_items.append(ast.OrderItem(expr=expr, descending=desc))
                if not self.accept_op(","):
                    break
        frame = None
        if self.accept_word("rows"):
            self.expect_keyword("between")
            lower = self.parse_frame_bound()
            self.expect_keyword("and")
            upper = self.parse_frame_bound()
            frame = (lower, upper)
        self.expect_op(")")
        return ast.WindowExpr(
            function=call.name, args=call.args,
            spec=ast.WindowSpec(partition_by=tuple(partition),
                                order_by=tuple(order_items), frame=frame))

    def parse_frame_bound(self) -> ast.FrameBound:
        if self.accept_word("unbounded"):
            which = self.accept_word("preceding", "following")
            if which is None:
                raise self.error("Expected PRECEDING or FOLLOWING")
            return ast.FrameBound(kind=f"unbounded_{which}")
        if self.accept_word("current"):
            if self.accept_word("row") is None:
                raise self.error("Expected ROW after CURRENT")
            return ast.FrameBound(kind="current_row")
        tok = self.cur
        if tok.kind in (TokenKind.INT, TokenKind.UINT):
            self.advance()
            which = self.accept_word("preceding", "following")
            if which is None:
                raise self.error("Expected PRECEDING or FOLLOWING")
            return ast.FrameBound(kind=which, offset=int(tok.value))
        raise self.error("Expected ROWS frame bound")

    def parse_case(self) -> ast.Expr:
        self.expect_keyword("case")
        operand = None
        if not self.cur.is_keyword("when"):
            operand = self.parse_expression()
        when_then: list[tuple[ast.Expr, ast.Expr]] = []
        while self.accept_keyword("when"):
            cond = self.parse_expression()
            self.expect_keyword("then")
            result = self.parse_expression()
            when_then.append((cond, result))
        default = None
        if self.accept_keyword("else"):
            default = self.parse_expression()
        self.expect_keyword("end")
        if not when_then:
            raise self.error("CASE requires at least one WHEN")
        return ast.CaseExpr(operand=operand, when_then=tuple(when_then),
                            default=default)

    def parse_transform(self) -> ast.Expr:
        self.expect_keyword("transform")
        self.expect_op("(")
        first = self.parse_expression()
        operands = first.operands if isinstance(first, _TupleExpr) else (first,)
        self.expect_op(",")
        from_values = self.parse_literal_tuple_list()
        self.expect_op(",")
        to_list = self.parse_literal_list()
        default = None
        if self.accept_op(","):
            default = self.parse_expression()
        self.expect_op(")")
        return ast.TransformExpr(operands=operands, from_values=from_values,
                                 to_values=to_list, default=default)

    # --- literal tuples for IN/BETWEEN/TRANSFORM ------------------------------

    def parse_literal(self):
        expr = self.parse_expression(_COMPARISON_LEVEL + 1)
        if not isinstance(expr, ast.Literal):
            raise self.error("Expected literal value")
        return expr.value

    def parse_literal_tuple(self, single_ok: bool = False) -> tuple:
        if self.cur.is_op("("):
            self.advance()
            values = [self.parse_literal()]
            while self.accept_op(","):
                values.append(self.parse_literal())
            self.expect_op(")")
            return tuple(values)
        if single_ok:
            return (self.parse_literal(),)
        raise self.error("Expected tuple literal")

    def parse_literal_tuple_list(self) -> tuple[tuple, ...]:
        self.expect_op("(")
        tuples: list[tuple] = []
        first = True
        while not self.cur.is_op(")"):
            if not first:
                self.expect_op(",")
            if self.cur.is_op("("):
                tuples.append(self.parse_literal_tuple())
            else:
                tuples.append((self.parse_literal(),))
            first = False
        self.expect_op(")")
        return tuple(tuples)

    def parse_literal_list(self) -> tuple:
        self.expect_op("(")
        values = []
        first = True
        while not self.cur.is_op(")"):
            if not first:
                self.expect_op(",")
            values.append(self.parse_literal())
            first = False
        self.expect_op(")")
        return tuple(values)

    def parse_between_range_list(self) -> tuple[tuple, ...]:
        self.expect_op("(")
        ranges = []
        first = True
        while not self.cur.is_op(")"):
            if not first:
                self.expect_op(",")
            lower = self.parse_literal_tuple(single_ok=True)
            self.expect_keyword("and")
            upper = self.parse_literal_tuple(single_ok=True)
            ranges.append((lower, upper))
            first = False
        self.expect_op(")")
        return tuple(ranges)

    # --- query ----------------------------------------------------------------

    def parse_query(self) -> ast.QueryAst:
        self.accept_keyword("select")
        # Select list (or *).
        select: Optional[tuple[ast.SelectItem, ...]]
        if self.accept_op("*"):
            select = None
        else:
            items = [self.parse_select_item()]
            while self.accept_op(","):
                items.append(self.parse_select_item())
            select = tuple(items)
        source = None
        source_alias = None
        joins: list[ast.Join] = []
        if self.accept_keyword("from"):
            source = self.parse_table_ref()
            if self.accept_keyword("as"):
                source_alias = self.parse_ident()
        while self.cur.is_keyword("left", "join"):
            is_left = self.accept_keyword("left") is not None
            self.expect_keyword("join")
            table = self.parse_table_ref()
            alias = None
            if self.accept_keyword("as"):
                alias = self.parse_ident()
            elif self.cur.kind is TokenKind.IDENT:
                alias = self.parse_ident()
            using: tuple[str, ...] = ()
            on: tuple[tuple[ast.Expr, ast.Expr], ...] = ()
            if self.accept_keyword("using"):
                names = [self.parse_ident()]
                while self.accept_op(","):
                    names.append(self.parse_ident())
                using = tuple(names)
            elif self.accept_keyword("on"):
                on = self.parse_on_equations()
            joins.append(ast.Join(table=table, alias=alias, is_left=is_left,
                                  using=using, on=on))
        where = None
        if self.accept_keyword("where"):
            where = self.parse_expression()
        # NEAREST(col, q, k [, metric]) — contextual word (not a reserved
        # keyword) so `nearest` stays usable as a column name.  Pure
        # sugar over ORDER BY <metric_fn>(col, q) LIMIT k.
        nearest = None
        if self._at_word("nearest") and \
                self.tokens[self.pos + 1].is_op("("):
            self.advance()
            self.expect_op("(")
            near_col = self.parse_expression()
            self.expect_op(",")
            near_q = self.parse_expression()
            self.expect_op(",")
            ktok = self.advance()
            if ktok.kind not in (TokenKind.INT, TokenKind.UINT):
                raise self.error("NEAREST expects an integer literal k")
            near_k = int(ktok.value)
            metric = "l2"
            if self.accept_op(","):
                mtok = self.advance()
                if mtok.kind not in (TokenKind.IDENT, TokenKind.STRING):
                    raise self.error(
                        "NEAREST metric must be an identifier or string")
                metric = str(mtok.value).lower()
            self.expect_op(")")
            if metric not in _NEAREST_METRICS:
                raise self.error(
                    f"Unknown NEAREST metric {metric!r}; expected one of "
                    f"{sorted(set(_NEAREST_METRICS))}")
            if near_k <= 0:
                raise self.error("NEAREST expects k >= 1")
            nearest = (near_col, near_q, near_k, metric)
        group_by: tuple[ast.SelectItem, ...] = ()
        with_totals = False
        if self.accept_keyword("group"):
            self.expect_keyword("by")
            items = [self.parse_select_item()]
            while self.accept_op(","):
                items.append(self.parse_select_item())
            group_by = tuple(items)
            if self.accept_keyword("with"):
                self.expect_keyword("totals")
                with_totals = True
        having = None
        if self.accept_keyword("having"):
            having = self.parse_expression()
        order_by: list[ast.OrderItem] = []
        if self.accept_keyword("order"):
            self.expect_keyword("by")
            while True:
                expr = self.parse_expression()
                desc = False
                if self.accept_keyword("desc"):
                    desc = True
                elif self.accept_keyword("asc"):
                    pass
                order_by.append(ast.OrderItem(expr=expr, descending=desc))
                if not self.accept_op(","):
                    break
        offset = None
        if self.accept_keyword("offset"):
            tok = self.advance()
            if tok.kind not in (TokenKind.INT, TokenKind.UINT):
                raise self.error("OFFSET expects an integer literal")
            offset = int(tok.value)
        limit = None
        if self.accept_keyword("limit"):
            tok = self.advance()
            if tok.kind not in (TokenKind.INT, TokenKind.UINT):
                raise self.error("LIMIT expects an integer literal")
            limit = int(tok.value)
        if self.cur.kind is not TokenKind.EOF:
            raise self.error(f"Unexpected trailing token {self.cur.value!r}")
        if nearest is not None:
            if order_by or limit is not None or offset is not None:
                raise self.error(
                    "NEAREST cannot be combined with ORDER BY/OFFSET/LIMIT "
                    "(it IS an ORDER BY ... LIMIT)")
            near_col, near_q, near_k, metric = nearest
            fn, desc = _NEAREST_METRICS[metric]
            order_by = [ast.OrderItem(
                expr=ast.FunctionCall(fn, (near_col, near_q)),
                descending=desc)]
            limit = near_k
            # NULL vectors have no distance: NEAREST returns only rows
            # with a stored vector, so the sugar fuses the exclusion
            # into WHERE (where the predicate pass runs BEFORE the
            # distance matmul) rather than leaving NULL order keys to
            # the sort's NULLS-first convention.
            notnull = ast.UnaryOp(
                "not", ast.FunctionCall("is_null", (near_col,)))
            where = notnull if where is None \
                else ast.BinaryOp("and", where, notnull)
        return ast.QueryAst(
            select=select, source=source, source_alias=source_alias,
            joins=tuple(joins), where=where, group_by=group_by,
            with_totals=with_totals, having=having, order_by=tuple(order_by),
            offset=offset, limit=limit)

    def parse_select_item(self) -> ast.SelectItem:
        expr = self.parse_expression()
        alias = None
        if self.accept_keyword("as"):
            alias = self.parse_ident()
        return ast.SelectItem(expr=expr, alias=alias)

    def parse_table_ref(self) -> str:
        tok = self.advance()
        if tok.kind is not TokenKind.IDENT:
            raise self.error("Expected table reference")
        return tok.value

    def parse_ident(self) -> str:
        tok = self.advance()
        if tok.kind is not TokenKind.IDENT:
            raise self.error("Expected identifier")
        return tok.value

    def parse_on_equations(self) -> tuple[tuple[ast.Expr, ast.Expr], ...]:
        equations = []
        while True:
            lhs = self.parse_expression(_PRECEDENCE["and"] + 1)
            if not (isinstance(lhs, ast.BinaryOp) and lhs.op == "="):
                raise self.error("JOIN ON expects conjunctions of equalities")
            equations.append((lhs.lhs, lhs.rhs))
            if not self.accept_keyword("and"):
                break
        return tuple(equations)


class _TupleExpr(ast.Expr):
    """Internal: parenthesized tuple, only valid before IN/BETWEEN/TRANSFORM."""

    def __init__(self, operands: tuple[ast.Expr, ...]):
        self.operands = operands


def parse_query(source: str) -> ast.QueryAst:
    """Parse a full QL query string."""
    return _Parser(source).parse_query()


def parse_expression(source: str) -> ast.Expr:
    """Parse a standalone expression (used for computed columns etc.)."""
    parser = _Parser(source)
    expr = parser.parse_expression()
    if parser.cur.kind is not TokenKind.EOF:
        raise parser.error("Unexpected trailing token")
    return expr
