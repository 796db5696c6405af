"""ANSI/ClickHouse-flavored SQL over YT tables — the CHYT analog.

Ref mapping (yt/chyt):
  CHYT accepts ClickHouse SQL over YT tables     → translate_sql rewrites
  (`SELECT ... FROM "//path"`), converting          the dialect onto the
  schemas/blocks into the CH engine                 native QL engine (the
  (chyt/server/conversion.h)                        columnar torch path
                                                    IS the vectorized
                                                    engine here, so no
                                                    second execution
                                                    engine is embedded)
  query dispatch via Query Tracker engines       → registered as engine
  (server/query_tracker/chyt_engine.cpp)           "chyt" / alias "sql"

Dialect deltas handled:
  SELECT * / SELECT cols FROM "//path" | `//path` | [//path]
  SELECT ... FROM (SELECT ...)   — subqueries: the inner SELECT runs
      first and the outer query evaluates over its materialized rowset
      (CHYT's subquery pushdown collapses to two engine passes here)
  SELECT DISTINCT a, b FROM t    → GROUP BY a, b
  ANSI double-quoted / backticked identifiers → bare identifiers
  <> / ==             → != / =
  CH aggregate names  → native (uniq/uniqExact → cardinality, any →
      first, countIf/sumIf/avgIf/minIf/maxIf → agg(CASE WHEN c THEN x
      END) — aggregates skip nulls, matching the -If combinators)
  CH casts            → native (toInt64 → int64, toUInt64 → uint64,
      toFloat64 → double, toString is rejected [no string casts])
  LIMIT n OFFSET m / LIMIT m, n  → OFFSET m LIMIT n (QL clause order)
Strings must use single quotes (ANSI); double quotes always mean
identifiers, exactly like ClickHouse's default dialect.

Own copy of the JAX package's `ecosystem/sql.py`: `translate_sql` gives the
reference's QL text for every input; a FROM-subquery's rows are
materialized on the client's cluster device and the outer query runs
there.
"""

from __future__ import annotations

import re

from ytsaurus_tpu_torch.errors import EErrorCode, YtError

_TOKEN = re.compile(r"""
    (?P<ws>\s+)
  | (?P<string>'(?:\\.|[^'\\])*')
  | (?P<dquote>"(?:[^"\\]|\\.)*")
  | (?P<btick>`[^`]*`)
  | (?P<bracket>\[[^\]]*\])
  | (?P<num>\d+(?:\.\d+)?(?:[eE][+-]?\d+)?u?)
  | (?P<word>[A-Za-z_][A-Za-z0-9_.]*)
  | (?P<op><>|<=|>=|!=|==|\|\||[-+*/%(),=<>.])
""", re.VERBOSE)

_AGG_RENAMES = {
    "uniq": "cardinality",
    "uniqexact": "cardinality",
    "any": "first",
}

_CAST_RENAMES = {
    "toint64": "int64",
    "touint64": "uint64",
    "tofloat64": "double",
}

# aggIf(x, cond) → agg(CASE WHEN cond THEN x END); countIf(cond) →
# sum(CASE WHEN cond THEN 1 END).  Null-skipping aggregation gives the
# -If combinator semantics exactly.
_IF_COMBINATORS = {
    "countif": "sum",
    "sumif": "sum",
    "avgif": "avg",
    "minif": "min",
    "maxif": "max",
}

_TABLE_KEYWORDS = {"from", "join"}


def _tokens(text: str):
    pos = 0
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if m is None:
            raise YtError(f"SQL: cannot tokenize at {text[pos:pos + 20]!r}",
                          code=EErrorCode.QueryParseError)
        pos = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        yield kind, m.group()


def _rewrite_if_combinators(toks: "list[tuple[str, str]]"
                            ) -> "list[tuple[str, str]]":
    """aggIf(x, cond) → agg(CASE WHEN cond THEN x END); countIf(cond)
    → sum(CASE WHEN cond THEN 1 END).  Recursive: arguments may nest
    further combinators."""
    out: list = []
    i = 0
    while i < len(toks):
        kind, tok = toks[i]
        low = tok.lower()
        if kind == "word" and low in _IF_COMBINATORS and \
                i + 1 < len(toks) and toks[i + 1][1] == "(":
            depth = 0
            j = i + 1
            args: list = [[]]
            while j < len(toks):
                k2, t2 = toks[j]
                if t2 == "(":
                    depth += 1
                    if depth > 1:
                        args[-1].append((k2, t2))
                elif t2 == ")":
                    depth -= 1
                    if depth == 0:
                        break
                    args[-1].append((k2, t2))
                elif t2 == "," and depth == 1:
                    args.append([])
                else:
                    args[-1].append((k2, t2))
                j += 1
            if depth != 0:
                raise YtError(f"SQL: unbalanced parens in {tok}(...)",
                              code=EErrorCode.QueryParseError)
            args = [_rewrite_if_combinators(a) for a in args]
            if low == "countif":
                if len(args) != 1:
                    raise YtError("SQL: countIf takes one argument",
                                  code=EErrorCode.QueryParseError)
                cond, value = args[0], [("num", "1")]
            else:
                if len(args) != 2:
                    raise YtError(f"SQL: {tok} takes (value, condition)",
                                  code=EErrorCode.QueryParseError)
                value, cond = args
            # CH -If combinators return the aggregate's DEFAULT on an
            # empty match set (0 for count/sum); our aggregates return
            # NULL over empty sets, so those two wrap in if_null.
            zero_default = low in ("countif", "sumif")
            if zero_default:
                out.append(("word", "if_null"))
                out.append(("op", "("))
            out.append(("word", _IF_COMBINATORS[low]))
            out.append(("op", "("))
            out.append(("word", "CASE"))
            out.append(("word", "WHEN"))
            out.extend(cond)
            out.append(("word", "THEN"))
            out.extend(value)
            out.append(("word", "END"))
            out.append(("op", ")"))
            if zero_default:
                out.append(("op", ","))
                out.append(("num", "0"))
                out.append(("op", ")"))
            i = j + 1
            continue
        out.append((kind, tok))
        i += 1
    return out


_JOIN_MODIFIERS = {"inner", "any", "all", "outer", "left"}
_UNSUPPORTED_JOINS = {"cross", "right", "full", "semi", "anti", "asof"}
_ALIAS_RESERVED = {"on", "using", "where", "group", "order", "limit",
                   "having", "offset", "join", "left", "inner", "any",
                   "all", "cross", "as", "asc", "desc", "with", "union",
                   "settings"}


def _normalize_joins(toks):
    """CH join modifiers → QL's two forms.  INNER/ALL are QL's plain
    JOIN; ANY is accepted and behaves identically when the right side
    is key-unique (the dimension-join case — CH's own ALL default
    matches QL exactly); CROSS/RIGHT/FULL/ASOF have no QL counterpart
    and fail loudly."""
    out = []
    i, n = 0, len(toks)
    while i < n:
        kind, tok = toks[i]
        low = tok.lower()
        if kind == "word" and (low in _JOIN_MODIFIERS or
                               low in _UNSUPPORTED_JOINS):
            j = i
            mods = []
            while j < n and toks[j][0] == "word" and \
                    toks[j][1].lower() in (_JOIN_MODIFIERS |
                                           _UNSUPPORTED_JOINS):
                mods.append(toks[j][1].lower())
                j += 1
            if j < n and toks[j][0] == "word" and \
                    toks[j][1].lower() == "join":
                bad = [m for m in mods if m in _UNSUPPORTED_JOINS]
                if bad:
                    raise YtError(
                        f"SQL: {bad[0].upper()} JOIN is not supported",
                        code=EErrorCode.QueryUnsupported)
                if "left" in mods:
                    out.append(("word", "LEFT"))
                i = j
                continue
        out.append(toks[i])
        i += 1
    return out


def _strip_table_aliases(toks):
    """Remove `[table] AS alias` / `[table] alias` (QL has no table
    aliases) and return the alias names, so qualified column refs can
    drop their prefixes."""
    out = []
    aliases: set = set()
    i, n = 0, len(toks)
    while i < n:
        kind, tok = toks[i]
        out.append(toks[i])
        if kind == "word" and tok.lower() in _TABLE_KEYWORDS and \
                i + 1 < n:
            out.append(toks[i + 1])          # the table reference
            i += 1
            j = i + 1
            if j < n and toks[j][0] == "word" and \
                    toks[j][1].lower() == "as":
                j += 1
            if j < n and toks[j][0] == "word" and \
                    "." not in toks[j][1] and \
                    toks[j][1].lower() not in _ALIAS_RESERVED:
                aliases.add(toks[j][1])
                i = j                        # alias tokens dropped
        i += 1
    return out, aliases


def _on_to_using(toks):
    """After alias stripping, `ON g = g AND h = h` is the degenerate
    same-column equality CH writes as `f.g = d.g` — in QL's flat join
    namespace that reads as ambiguous self-equality, so rewrite it to
    `USING g, h`.  Mixed-name equalities stay as ON."""
    clause_ends = {"where", "group", "order", "limit", "having",
                   "offset", "join", "left", "settings"}
    out = []
    i, n = 0, len(toks)
    while i < n:
        kind, tok = toks[i]
        if kind == "word" and tok.lower() == "on":
            pairs = []
            j = i + 1
            while j + 2 < n and toks[j][0] == "word" and \
                    toks[j + 1] == ("op", "=") and \
                    toks[j + 2][0] == "word":
                pairs.append((toks[j][1], toks[j + 2][1]))
                j += 3
                if j < n and toks[j][0] == "word" and \
                        toks[j][1].lower() == "and":
                    j += 1
                    continue
                break
            # Rewrite ONLY when the whole ON clause was consumed as
            # same-name pairs and scanning stopped at a clause boundary
            # (or the end) — a trailing non-equality conjunct
            # (ON a=b AND v>5) must keep the original text, not lose
            # its AND.
            ends_clean = j >= n or (toks[j][0] == "word" and
                                    toks[j][1].lower() in clause_ends)
            if ends_clean and pairs and \
                    all(a == b for a, b in pairs):
                out.append(("word", "USING"))
                for p, (name, _) in enumerate(pairs):
                    if p:
                        out.append(("op", ","))
                    out.append(("word", name))
                i = j
                continue
        out.append(toks[i])
        i += 1
    return out


def translate_sql(sql: str) -> str:
    """ClickHouse/ANSI-flavored SELECT → native QL text (flat queries;
    subqueries are orchestrated by execute_sql)."""
    toks = _rewrite_if_combinators(list(_tokens(sql.strip().rstrip(";"))))
    toks = _normalize_joins(toks)
    toks, aliases = _strip_table_aliases(toks)
    if aliases:
        # Qualified refs (f.col) lose their table prefix: the joined
        # namespace is flat in QL.
        toks = [(kind, tok.split(".", 1)[1])
                if kind == "word" and "." in tok and
                tok.split(".", 1)[0] in aliases else (kind, tok)
                for kind, tok in toks]
        toks = _on_to_using(toks)
    out: list[str] = []
    expecting_table = False
    limit_value = None
    offset_value = None
    state = "normal"
    distinct_items: "list[str] | None" = None
    collecting_distinct = False
    for kind, tok in toks:
        low = tok.lower()
        if state == "limit" and kind == "num":
            limit_value = tok
            state = "limit_tail"
            continue
        if state == "limit_tail":
            if tok == ",":
                # CH shorthand: LIMIT offset, count.
                state = "limit_second"
                continue
            state = "normal"
        if state == "limit_second" and kind == "num":
            offset_value, limit_value = limit_value, tok
            state = "normal"
            continue
        if state == "offset" and kind == "num":
            offset_value = tok
            state = "normal"
            continue
        if kind == "word" and low == "limit":
            state = "limit"
            continue
        if kind == "word" and low == "offset":
            state = "offset"
            continue
        if kind == "word" and low == "distinct" and \
                out and out[-1].lower() == "select":
            collecting_distinct = True
            distinct_items = []
            continue
        if collecting_distinct:
            if kind == "word" and low in _TABLE_KEYWORDS:
                collecting_distinct = False
            elif kind == "word":
                distinct_items.append(tok)
                out.append(tok)
                continue
            elif tok == ",":
                out.append(tok)
                continue
            else:
                raise YtError(
                    "SQL: SELECT DISTINCT supports bare column lists "
                    "only", code=EErrorCode.QueryParseError)
        if expecting_table:
            out.append(_table_ref(kind, tok))
            expecting_table = False
            continue
        if kind == "word" and low in _TABLE_KEYWORDS:
            out.append(tok)
            expecting_table = True
            continue
        if kind == "dquote":
            # ANSI: double quotes are identifiers.
            out.append(tok[1:-1])
            continue
        if kind == "btick":
            out.append(tok[1:-1])
            continue
        if kind == "op" and tok == "<>":
            out.append("!=")
            continue
        if kind == "op" and tok == "==":
            out.append("=")
            continue
        if kind == "word" and low in _AGG_RENAMES:
            out.append(_AGG_RENAMES[low])
            continue
        if kind == "word" and low in _CAST_RENAMES:
            out.append(_CAST_RENAMES[low])
            continue
        if kind == "word" and low == "tostring":
            raise YtError("SQL: toString is not supported (no string "
                          "casts)", code=EErrorCode.QueryUnsupported)
        out.append(tok)
    if distinct_items:
        lows = [t.lower() for t in out]
        if "group" in lows:
            raise YtError("SQL: DISTINCT cannot combine with GROUP BY",
                          code=EErrorCode.QueryParseError)
        group_toks = ["GROUP", "BY"]
        for i, item in enumerate(distinct_items):
            if i:
                group_toks.append(",")
            group_toks.append(item)
        insert_at = lows.index("order") if "order" in lows else len(out)
        out[insert_at:insert_at] = group_toks
    ql = _respace(out)
    if ql.lower().startswith("select "):
        ql = ql[len("select "):]
    # QL clause order: ... OFFSET m LIMIT n.
    if offset_value is not None:
        ql += f" OFFSET {offset_value}"
    if limit_value is not None:
        ql += f" LIMIT {limit_value}"
    return ql


def _table_ref(kind: str, tok: str) -> str:
    if kind == "bracket":
        return tok                       # already QL form
    if kind == "dquote" or kind == "btick":
        return f"[{tok[1:-1]}]"
    if kind == "word":
        # Bare identifier: treat as an absolute cypress path component
        # under the root ("FROM my_table" → [//my_table], matching CHYT's
        # default-database-as-directory mapping).
        path = tok if tok.startswith("//") else f"//{tok}"
        return f"[{path}]"
    if kind == "string":
        return f"[{tok[1:-1]}]"
    raise YtError(f"SQL: bad table reference {tok!r}",
                  code=EErrorCode.QueryParseError)


_NO_SPACE_BEFORE = {",", ")", "."}
_NO_SPACE_AFTER = {"(", "."}


def _respace(tokens: "list[str]") -> str:
    parts: list[str] = []
    prev = ""
    for tok in tokens:
        if parts and tok not in _NO_SPACE_BEFORE and \
                prev not in _NO_SPACE_AFTER:
            parts.append(" ")
        parts.append(tok)
        prev = tok
    return "".join(parts)


_SUBQUERY_TABLE = "//__chyt_subquery__"


def _mask_strings(sql: str) -> str:
    """Same-length copy with quoted literals blanked, so clause searches
    and paren counting cannot match inside strings."""
    out = list(sql)
    i = 0
    while i < len(sql):
        if sql[i] == "'":
            j = i + 1
            while j < len(sql):
                if sql[j] == "\\":
                    j += 2
                    continue
                if sql[j] == "'":
                    break
                j += 1
            for k in range(i + 1, min(j, len(sql))):
                out[k] = "_"
            i = j + 1
        else:
            i += 1
    return "".join(out)


def _split_subquery(sql: str) -> "tuple[str, str] | None":
    """`outer FROM ( inner ) [AS alias] rest` → (inner SQL, outer SQL
    with the parenthesized subquery replaced by a synthetic table ref).
    Returns None when the query has no FROM-subquery."""
    masked = _mask_strings(sql)
    m = re.search(r"\bfrom\s*\(", masked, re.IGNORECASE)
    if m is None:
        return None
    start = masked.index("(", m.start())
    depth = 0
    for i in range(start, len(masked)):
        if masked[i] == "(":
            depth += 1
        elif masked[i] == ")":
            depth -= 1
            if depth == 0:
                inner = sql[start + 1: i]
                rest = sql[i + 1:]
                # Drop an optional `[AS] alias` after the subquery (QL
                # has one namespace; clause keywords are not aliases).
                alias = re.match(r"\s*(?:as\s+)?([A-Za-z_][A-Za-z0-9_]*)",
                                 rest, re.IGNORECASE)
                if alias and alias.group(1).lower() not in (
                        "where", "group", "order", "having", "limit",
                        "offset", "join", "on"):
                    rest = rest[alias.end():]
                outer = (sql[: m.start()] +
                         f"FROM [{_SUBQUERY_TABLE}]" + rest)
                return inner, outer
    raise YtError("SQL: unbalanced parens in FROM (...)",
                  code=EErrorCode.QueryParseError)


def _infer_schema(rows: "list[dict]"):
    """Column types from materialized subquery rows (None-only columns
    default to int64)."""
    from ytsaurus_tpu_torch.schema import TableSchema
    if not rows:
        raise YtError("SQL: empty subquery result (schema unknown)",
                      code=EErrorCode.QueryExecutionError)
    kinds: dict = {}
    for row in rows:
        for name, value in row.items():
            if value is None:
                kinds.setdefault(name, None)
            elif isinstance(value, bool):
                kinds[name] = "boolean"
            elif isinstance(value, int):
                if kinds.get(name) not in ("double", "uint64"):
                    kinds[name] = "uint64" if value >= 2**63 else "int64"
            elif isinstance(value, float):
                kinds[name] = "double"
            elif isinstance(value, (bytes, str)):
                kinds[name] = "string"
    cols = [(name, kind or "int64") for name, kind in kinds.items()]
    return TableSchema.make(cols)


def execute_sql(client, sql: str) -> "list[dict]":
    """CH-dialect execution, including one level of FROM-subquery: the
    inner SELECT runs first and the outer query evaluates over its
    materialized rowset (CHYT collapses subqueries into engine passes
    the same way; here each pass IS a full coordinated query)."""
    sql = sql.strip().rstrip(";")
    split = _split_subquery(sql)
    if split is None:
        return client.select_rows(translate_sql(sql))
    inner_sql, outer_sql = split
    inner_rows = execute_sql(client, inner_sql)     # nested levels recurse
    from ytsaurus_tpu_torch.chunks import ColumnarChunk
    from ytsaurus_tpu_torch.query import select_rows as chunk_select
    decoded = [{k: (v.decode() if isinstance(v, bytes) else v)
                for k, v in r.items()} for r in inner_rows]
    if decoded:
        schema = _infer_schema(decoded)
    else:
        # Empty inner result is routine (selective WHERE), not an
        # error: take the schema from the inner PLAN so the outer query
        # can still aggregate to its CH-correct empty/zero result.
        schema = _planned_schema(client, inner_sql)
    device = client.cluster.device
    chunk = ColumnarChunk.from_rows(schema, decoded, device=device)
    result = chunk_select(translate_sql(outer_sql),
                          {_SUBQUERY_TABLE: chunk},
                          evaluator=client.cluster.evaluator, device=device)
    return result.to_rows()


def _planned_schema(client, inner_sql: str):
    """Output schema of a (flat) inner query via the QL builder — used
    when no rows materialized to infer types from."""
    from ytsaurus_tpu_torch.client import _SchemaResolver
    from ytsaurus_tpu_torch.query.builder import build_query
    if _split_subquery(inner_sql) is not None:
        raise YtError(
            "SQL: empty nested subquery result (schema unknown)",
            code=EErrorCode.QueryExecutionError)
    plan = build_query(translate_sql(inner_sql), _SchemaResolver(client))
    return plan.output_schema().to_unsorted()


def register() -> None:
    from ytsaurus_tpu_torch.server.query_tracker import register_engine
    register_engine("chyt", execute_sql)
    register_engine("sql", execute_sql)


register()
