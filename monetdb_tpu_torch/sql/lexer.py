"""SQL lexer (hand-written scanner, the reference's sql/server/sql_scan.c
analog)."""

from __future__ import annotations

import dataclasses
from typing import List

__all__ = ["Token", "tokenize", "SQLSyntaxError"]


class SQLSyntaxError(Exception):
    pass


@dataclasses.dataclass
class Token:
    kind: str      # kw ident num str op punct
    value: str
    pos: int

    def __repr__(self):
        return f"{self.kind}:{self.value}"


KEYWORDS = {
    "select", "distinct", "from", "where", "group", "by", "having", "order",
    "limit", "offset", "as", "and", "or", "not", "in", "exists", "between",
    "like", "escape", "is", "null", "case", "when", "then", "else", "end",
    "cast", "extract", "substring", "interval", "date", "timestamp", "time",
    "join", "inner", "left", "right", "full", "outer", "cross", "on",
    "union", "all", "except", "intersect", "any", "some", "every",
    "asc", "desc", "nulls", "first", "last", "true", "false",
    "create", "table", "insert", "into", "values", "drop", "copy",
    "delimiters", "records", "primary", "key", "foreign", "references",
    "with", "view", "partition", "over", "rows", "range", "unbounded",
    "preceding", "following", "current", "row", "for", "precision",
    "delete", "update", "set", "begin", "start", "transaction", "commit",
    "rollback", "sample", "seed",
    "merge", "remote", "replica", "alter", "add", "to", "default",
    "ilike", "recursive", "groups", "natural", "using",
}

_TWO_CHAR = {"<>", "<=", ">=", "!=", "||"}


def tokenize(sql: str) -> List[Token]:
    toks: List[Token] = []
    i, n = 0, len(sql)
    while i < n:
        c = sql[i]
        if c.isspace():
            i += 1
            continue
        if c == "-" and i + 1 < n and sql[i + 1] == "-":   # comment
            j = sql.find("\n", i)
            i = n if j < 0 else j + 1
            continue
        if c == "/" and i + 1 < n and sql[i + 1] == "*":
            j = sql.find("*/", i)
            if j < 0:
                raise SQLSyntaxError("unterminated comment")
            i = j + 2
            continue
        esc = c in "eE" and i + 1 < n and sql[i + 1] == "'"
        if esc:        # E'...' escape-string literal (sql_scan.c E strings)
            i += 1
            c = "'"
        if c == "'":
            j = i + 1
            buf = []
            while j < n:
                if sql[j] == "'":
                    if j + 1 < n and sql[j + 1] == "'":
                        buf.append("'")
                        j += 2
                        continue
                    break
                if esc and sql[j] == "\\" and j + 1 < n:
                    buf.append({"n": "\n", "t": "\t", "r": "\r",
                                "\\": "\\", "'": "'",
                                "0": "\0"}.get(sql[j + 1], sql[j + 1]))
                    j += 2
                    continue
                buf.append(sql[j])
                j += 1
            else:
                raise SQLSyntaxError("unterminated string")
            toks.append(Token("str", "".join(buf), i))
            i = j + 1
            continue
        if c == '"':
            j = sql.find('"', i + 1)
            if j < 0:
                raise SQLSyntaxError("unterminated identifier")
            toks.append(Token("ident", sql[i + 1:j].lower(), i))
            i = j + 1
            continue
        if c.isdigit() or (c == "." and i + 1 < n and sql[i + 1].isdigit()):
            j = i
            seen_dot = seen_e = False
            while j < n:
                ch = sql[j]
                if ch.isdigit():
                    j += 1
                elif ch == "." and not seen_dot and not seen_e:
                    seen_dot = True
                    j += 1
                elif ch in "eE" and not seen_e and j + 1 < n and \
                        (sql[j + 1].isdigit() or sql[j + 1] in "+-"):
                    seen_e = True
                    j += 2 if sql[j + 1] in "+-" else 1
                else:
                    break
            toks.append(Token("num", sql[i:j], i))
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (sql[j].isalnum() or sql[j] == "_"):
                j += 1
            w = sql[i:j].lower()
            toks.append(Token("kw" if w in KEYWORDS else "ident", w, i))
            i = j
            continue
        if sql[i:i + 2] in _TWO_CHAR:
            toks.append(Token("op", sql[i:i + 2], i))
            i += 2
            continue
        if c in "+-*/%<>=":
            toks.append(Token("op", c, i))
            i += 1
            continue
        if c == "?":
            toks.append(Token("param", "?", i))
            i += 1
            continue
        if c in "(),.;":
            toks.append(Token("punct", c, i))
            i += 1
            continue
        raise SQLSyntaxError(f"unexpected character {c!r} at {i}")
    toks.append(Token("eof", "", n))
    return toks
