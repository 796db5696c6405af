"""Literal hoisting and the plan fingerprint.

Own copy of the JAX package's `query/parameterize.py`. Two passes share
ONE definition of "a hoistable literal" (int / uint / double / string):

  text level   `hoist_literals(query_text)` — the lexer pass behind the
               workload log's normalized text and fingerprint: every
               literal TOKEN becomes a `?` placeholder. true / false /
               null are keywords, never hoisted.
  plan level   `plan_fingerprint(plan)` — ir.fingerprint with
               omit_values=True: the same literal classes collapse to `?`,
               IN-list values to their pow2-bucketed count, LIMIT /
               OFFSET bucket pow2. The whole-plan rung's quota memo and
               the mesh observatory key one entry per query shape on it.
               `hoisted_parameters(plan)` lists the values it hoisted.

Two query texts that normalize identically therefore build plans with
identical shape fingerprints. The reference's `CompileConfig.parameterize`
switch has no counterpart: nothing is compiled, so the fingerprint is
always the parameterized one.
"""

from __future__ import annotations

import re

from ytsaurus_tpu_torch.query import ir
from ytsaurus_tpu_torch.query.lexer import TokenKind, tokenize

_PLAIN_IDENT = re.compile(r"[A-Za-z_$][A-Za-z0-9_$]*")

_LITERAL_KINDS = {TokenKind.INT: "int64", TokenKind.UINT: "uint64",
                  TokenKind.DOUBLE: "double", TokenKind.STRING: "string"}

# No space BEFORE these rendered tokens / AFTER these suffixes: purely
# cosmetic (the token stream is identical either way), but it keeps
# normalized text readable and fingerprint-stable.
_NO_SPACE_BEFORE = {",", ")", ".", "]"}
_NO_SPACE_AFTER = ("(", ".", "[")


def hoist_literals(query: str) -> tuple[str, list]:
    """Hoist literals out of a query text: `(normalized_text, literals)`.

    Literal tokens (int/uint/double/string) become `?` placeholders and
    land in `literals` as (kind, value) in appearance order — the
    binding shapes/dtypes of the record.  Keywords upper-case and
    identifiers re-bracket when exotic, so two queries differing only
    in constants normalize to ONE text (= one workload fingerprint and,
    via the matching plan-level pass, one evaluator fingerprint)."""
    parts: list[str] = []
    literals: list[tuple[str, object]] = []
    for tok in tokenize(query):
        if tok.kind is TokenKind.EOF:
            break
        kind = _LITERAL_KINDS.get(tok.kind)
        if kind is not None:
            literals.append((kind, tok.value))
            parts.append("?")
        elif tok.kind is TokenKind.KEYWORD:
            parts.append(str(tok.value).upper())
        elif tok.kind is TokenKind.IDENT:
            name = str(tok.value)
            plain = all(_PLAIN_IDENT.fullmatch(seg)
                        for seg in name.split(".")) if name else False
            parts.append(name if plain else f"[{name}]")
        else:
            parts.append(str(tok.value))
    text = ""
    for part in parts:
        if text and part not in _NO_SPACE_BEFORE \
                and not text.endswith(_NO_SPACE_AFTER):
            text += " "
        text += part
    return text, literals


def plan_fingerprint(plan: "ir.Query | ir.FrontQuery") -> str:
    """The parameterized (shape) fingerprint of a plan."""
    return ir.fingerprint(plan, omit_values=True)


def hoisted_parameters(plan: "ir.Query | ir.FrontQuery") -> list:
    """The literal values the parameterized fingerprint hoisted out of
    `plan`, in deterministic walk order — the plan-level counterpart of
    hoist_literals()' `literals` (observability/tests; execution reads
    values straight from the original plan at bind time)."""
    params: list = []

    def visit(expr) -> None:
        if expr is None:
            return
        if isinstance(expr, ir.TLiteral):
            if not isinstance(expr.type, ir.EValueType):
                # Vector literal (parametric type): hoisted as a runtime
                # binding like the scalar classes.
                params.append(("vector", expr.value))
            elif expr.type in ir.HOISTABLE_LITERAL_TYPES:
                params.append((expr.type.value, expr.value))
            return
        if isinstance(expr, ir.TIn):
            for o in expr.operands:
                visit(o)
            for tup in expr.values:
                for v in tup:
                    params.append(("in", v))
            return
        if isinstance(expr, ir.TBetween):
            for o in expr.operands:
                visit(o)
            for lo, hi in expr.ranges:
                for v in (*lo, *hi):
                    params.append(("between", v))
            return
        if isinstance(expr, ir.TTransform):
            for o in expr.operands:
                visit(o)
            for tup in expr.from_values:
                for v in tup:
                    params.append(("transform", v))
            for v in expr.to_values:
                params.append(("transform_to", v))
            visit(expr.default)
            return
        if isinstance(expr, ir.TStringPredicate):
            visit(expr.operand)
            params.append(("pattern", expr.pattern))
            return
        import dataclasses as _dc
        if not isinstance(expr, ir.TExpr):
            return
        for f in _dc.fields(expr):
            value = getattr(expr, f.name)
            if isinstance(value, ir.TExpr):
                visit(value)
            elif isinstance(value, (tuple, list)):
                for item in value:
                    if isinstance(item, ir.TExpr):
                        visit(item)

    def visit_named(items) -> None:
        for item in items:
            visit(item.expr)

    if isinstance(plan, ir.Query):
        for j in plan.joins:
            for e in (*j.self_equations, *j.foreign_equations):
                visit(e)
        visit(plan.where)
    if plan.group is not None:
        visit_named(plan.group.group_items)
        for agg in plan.group.aggregate_items:
            visit(agg.argument)
            visit(agg.by_argument)
    if plan.window is not None:
        visit_named(plan.window.partition_items)
        for oi in plan.window.order_items:
            visit(oi.expr)
        for w in plan.window.items:
            visit(w.argument)
            visit(w.default)
    visit(plan.having)
    if plan.order is not None:
        for oi in plan.order.items:
            visit(oi.expr)
    if plan.project is not None:
        visit_named(plan.project.items)
    return params
