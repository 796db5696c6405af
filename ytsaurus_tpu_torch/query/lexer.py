"""Port of the JAX package's `query/lexer.py`: a copy, with imports pointed at
this package (it imports nothing of the JAX package), and one repair: the
number scan consumes the `u` suffix that the docstring below documents, so
`16u` lexes as the uint64 16 (the JAX copy's loop stops before the suffix
and leaves an identifier `u`).

QL lexer.

Tokenizes the YT query language surface (ref grammar: library/query/base/
lexer.rl6): case-insensitive keywords, int literals (with `u` suffix for
uint64), doubles, single/double-quoted strings with escapes, identifiers
(dotted for join-qualified columns, `[...]`-bracketed for exotic names), and
the operator set used by expressions.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

from ytsaurus_tpu_torch.errors import EErrorCode, YtError


class TokenKind(enum.Enum):
    IDENT = "ident"
    INT = "int"
    UINT = "uint"
    DOUBLE = "double"
    STRING = "string"
    KEYWORD = "keyword"
    OP = "op"
    EOF = "eof"


KEYWORDS = {
    "select", "from", "where", "group", "by", "having", "order", "limit",
    "offset", "join", "left", "on", "using", "as", "and", "or", "not", "in",
    "between", "transform", "case", "when", "then", "else", "end", "if",
    "asc", "desc", "false", "true", "null", "with", "totals", "like", "ilike",
    "escape", "rlike", "regexp", "is", "array", "unnest",
}

# Multi-char operators first (longest match wins).
OPERATORS = [
    "<<", ">>", "!=", "<>", "<=", ">=", "=", "<", ">", "(", ")", ",", "+",
    "-", "*", "/", "%", "|", "&", "~", "^", ".", "[", "]", "#", "?",
]


@dataclass(frozen=True)
class Token:
    kind: TokenKind
    value: object           # str for ident/op/keyword/string; int/float for numbers
    pos: int

    def is_keyword(self, *names: str) -> bool:
        return self.kind is TokenKind.KEYWORD and self.value in names

    def is_op(self, *ops: str) -> bool:
        return self.kind is TokenKind.OP and self.value in ops


def _lex_error(source: str, pos: int, message: str) -> YtError:
    context = source[max(0, pos - 20):pos + 20]
    return YtError(f"{message} at position {pos}: ...{context!r}...",
                   code=EErrorCode.QueryParseError)


def tokenize(source: str) -> list[Token]:
    tokens: list[Token] = []
    i, n = 0, len(source)
    while i < n:
        c = source[i]
        if c.isspace():
            i += 1
            continue
        start = i
        # Comments: -- to end of line.
        if source.startswith("--", i):
            while i < n and source[i] != "\n":
                i += 1
            continue
        # Numbers.
        if c.isdigit() or (c == "." and i + 1 < n and source[i + 1].isdigit()):
            j = i
            is_double = False
            while j < n and (source[j].isdigit() or source[j] in "._eE+-xXabcdefABCDEF"):
                ch = source[j]
                if ch in "+-" and source[j - 1] not in "eE":
                    break
                if ch == "." or ((ch in "eE") and not source.startswith("0x", i)):
                    is_double = True
                j += 1
            # The uint64 suffix (`16u`): the loop above stops at it.
            if j < n and source[j] in "uU" and not is_double:
                j += 1
            text = source[i:j].rstrip("uU")
            suffix_u = source[i:j][len(text):] != ""
            try:
                if is_double and not suffix_u:
                    tokens.append(Token(TokenKind.DOUBLE, float(text), start))
                else:
                    value = int(text, 0)
                    kind = TokenKind.UINT if suffix_u else TokenKind.INT
                    tokens.append(Token(kind, value, start))
            except ValueError:
                raise _lex_error(source, i, f"Bad numeric literal {source[i:j]!r}")
            i = j
            continue
        # Strings.
        if c in "'\"":
            quote = c
            j = i + 1
            buf = []
            while j < n and source[j] != quote:
                if source[j] == "\\" and j + 1 < n:
                    esc = source[j + 1]
                    mapping = {"n": "\n", "t": "\t", "r": "\r", "\\": "\\",
                               "'": "'", '"': '"', "0": "\0"}
                    if esc in mapping:
                        buf.append(mapping[esc])
                        j += 2
                        continue
                    if esc == "x" and j + 3 < n:
                        buf.append(chr(int(source[j + 2:j + 4], 16)))
                        j += 4
                        continue
                buf.append(source[j])
                j += 1
            if j >= n:
                raise _lex_error(source, i, "Unterminated string literal")
            tokens.append(Token(TokenKind.STRING, "".join(buf), start))
            i = j + 1
            continue
        # Bracketed identifiers: [path with anything].
        if c == "[":
            j = source.find("]", i + 1)
            if j != -1 and _expects_identifier(tokens):
                tokens.append(Token(TokenKind.IDENT, source[i + 1:j], start))
                i = j + 1
                continue
        # Identifiers / keywords.
        if c.isalpha() or c in "_$":
            j = i
            while j < n and (source[j].isalnum() or source[j] in "_$"):
                j += 1
            word = source[i:j]
            low = word.lower()
            if low in KEYWORDS:
                tokens.append(Token(TokenKind.KEYWORD, low, start))
            else:
                tokens.append(Token(TokenKind.IDENT, word, start))
            i = j
            continue
        # Operators.
        for op in OPERATORS:
            if source.startswith(op, i):
                tokens.append(Token(TokenKind.OP, op, start))
                i += len(op)
                break
        else:
            raise _lex_error(source, i, f"Unexpected character {c!r}")
    tokens.append(Token(TokenKind.EOF, None, n))
    return tokens


def _expects_identifier(tokens: list[Token]) -> bool:
    """Heuristic: after FROM/JOIN/start, `[` opens a bracketed path/name."""
    if not tokens:
        return True
    last = tokens[-1]
    return last.is_keyword("from", "join") or last.is_op(",", "(") or \
        last.is_keyword("select", "by", "on", "using", "where", "and", "or")
