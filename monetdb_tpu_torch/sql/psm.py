"""PSM interpreter — session-level execution of SQL function/procedure
bodies with control flow (reference sql/server/rel_psm.c: DECLARE, SET,
IF/ELSE, WHILE, RETURN, and arbitrary side-effecting SQL statements).

Straight-line bodies inline at CREATE time (parser folding); bodies with
loops/branches/side effects are stored raw and interpreted here per
call: conditions and expressions evaluate through the engine
(``SELECT <expr>``), variables substitute as SQL literals — the
reference interprets PSM through the MAL program it generates; here the
session's SQL surface is the evaluation machine.
"""

from __future__ import annotations

import re
from typing import List, Optional, Tuple

__all__ = ["run_psm_body", "parse_blocks", "strip_line_comments"]

def strip_line_comments(text: str) -> str:
    """Remove SQL -- line comments (quote-aware); body-level text
    processing (PSM folding/interpretation) needs them gone."""
    out = []
    q = None
    i, n = 0, len(text)
    while i < n:
        ch = text[i]
        if q:
            out.append(ch)
            if ch == q:
                q = None
            i += 1
        elif ch in "'\"":
            q = ch
            out.append(ch)
            i += 1
        elif ch == "-" and i + 1 < n and text[i + 1] == "-":
            while i < n and text[i] != "\n":
                i += 1
        elif ch == "/" and i + 1 < n and text[i + 1] == "*":
            j = text.find("*/", i + 2)
            i = n if j < 0 else j + 2
        else:
            out.append(ch)
            i += 1
    return "".join(out)


_MAX_ITER = 1_000_000


def _split_stmts(text: str) -> List[str]:
    """';'-separated statements, quote-aware."""
    out, buf, q = [], [], None
    for ch in text:
        if q:
            buf.append(ch)
            if ch == q:
                q = None
        elif ch in "'\"":
            q = ch
            buf.append(ch)
        elif ch == ";":
            if "".join(buf).strip():
                out.append("".join(buf).strip())
            buf = []
        else:
            buf.append(ch)
    if "".join(buf).strip():
        out.append("".join(buf).strip())
    return out


def parse_blocks(stmts: List[str], i: int = 0,
                 stop: Tuple[str, ...] = ()) -> Tuple[list, int]:
    """Group a flat ';'-statement list into nested block nodes:
    ('sql', text) | ('set', var, expr) | ('declare', var) |
    ('return', expr) | ('while', cond, body) |
    ('if', cond, then, els)."""
    nodes = []
    while i < len(stmts):
        st = stmts[i]
        lw = st.lower()
        if any(lw == s or lw.startswith(s + " ") for s in stop) or \
                lw in stop:
            return nodes, i
        if lw.startswith("while"):
            m = re.match(r"while\s+(.*?)\s+do\b(.*)", st,
                         re.I | re.S)
            if not m:
                raise ValueError(f"bad WHILE: {st[:50]}")
            cond = m.group(1)
            rest = m.group(2).strip()
            inner = ([rest] if rest else []) + stmts[i + 1:]
            body, j = parse_blocks(inner, 0, ("end while",))
            consumed = j - (1 if rest else 0)
            nodes.append(("while", cond, body))
            i = i + 1 + consumed
            if i < len(stmts) and stmts[i].lower().startswith("end while"):
                i += 1
            continue
        if lw.startswith("if"):
            m = re.match(r"if\s+(.*?)\s+then\b(.*)", st, re.I | re.S)
            if not m:
                raise ValueError(f"bad IF: {st[:50]}")
            cond = m.group(1)
            rest = m.group(2).strip()
            inner = ([rest] if rest else []) + stmts[i + 1:]
            then, j = parse_blocks(inner, 0, ("else", "elseif", "end if"))
            consumed = j - (1 if rest else 0)
            i = i + 1 + consumed
            els: list = []
            if i < len(stmts):
                lw2 = stmts[i].lower()
                if lw2.startswith("elseif"):
                    # ELSEIF c THEN ... == ELSE IF c THEN ... END IF
                    stmts2 = ["if" + stmts[i][6:]] + stmts[i + 1:]
                    els, j2 = parse_blocks(stmts2, 0, ("end if",))
                    i = i + 1 + (j2 - 1)
                elif lw2.startswith("else"):
                    rest2 = stmts[i][4:].strip()
                    inner2 = ([rest2] if rest2 else []) + stmts[i + 1:]
                    els, j2 = parse_blocks(inner2, 0, ("end if",))
                    i = i + 1 + (j2 - (1 if rest2 else 0))
            if i < len(stmts) and stmts[i].lower().startswith("end if"):
                i += 1
            nodes.append(("if", cond, then, els))
            continue
        if lw.startswith("declare"):
            m = re.match(r"declare\s+table\s+(\w+)\s*\((.*)\)\s*$",
                         st, re.I | re.S)
            if m:
                # DECLARE TABLE t (cols): a body-local table
                # (rel_psm.c psm_declare table case)
                nodes.append(("decl_table", m.group(1).lower(),
                              m.group(2)))
                i += 1
                continue
            m = re.match(r"declare\s+(\w+)", st, re.I)
            if m:
                nodes.append(("declare", m.group(1).lower()))
            i += 1
            continue
        if lw.startswith("set "):
            m = re.match(r"set\s+(\w+)\s*=\s*(.*)", st, re.I | re.S)
            if not m:
                raise ValueError(f"bad SET: {st[:50]}")
            nodes.append(("set", m.group(1).lower(), m.group(2).strip()))
            i += 1
            continue
        if lw.startswith("return"):
            nodes.append(("return", st[6:].strip()))
            i += 1
            continue
        nodes.append(("sql", st))
        i += 1
    return nodes, i


def validate_body(nodes) -> None:
    """Create-time semantic validation of DML against DECLARE TABLE
    definitions (the reference binds PSM bodies at create: an UPDATE of
    a nonexistent column on a declared table errors then)."""
    decls = {}

    def walk(ns):
        for node in ns:
            k = node[0]
            if k == "decl_table":
                for cdef in _split_cols(node[2]):
                    words = {w.lower() for w in cdef.split()}
                    if words & {"unique", "primary", "foreign", "check",
                                "references"}:
                        # the reference rejects constraints on declared
                        # tables (Bug-3319)
                        raise ValueError(
                            "42000!constraints are not supported on "
                            "DECLARE TABLE")
                cols = [c.strip().split()[0].strip('"').lower()
                        for c in _split_cols(node[2])]
                decls[node[1]] = set(cols)
            elif k == "sql":
                st = node[1]
                m = re.match(r"(?is)\s*insert\s+into\s+(\w+)\s*"
                             r"\(([^)]*)\)", st)
                if m and m.group(1).lower() in decls:
                    for c in m.group(2).split(","):
                        if c.strip().strip('"').lower() not in \
                                decls[m.group(1).lower()]:
                            raise ValueError(
                                f"42S22!no such column {c.strip()} in "
                                f"declared table {m.group(1)}")
                m = re.match(r"(?is)\s*update\s+(\w+)\s+set\s+(\w+)",
                             st)
                if m and m.group(1).lower() in decls:
                    if m.group(2).lower() not in decls[m.group(1).lower()]:
                        raise ValueError(
                            f"42S22!no such column {m.group(2)} in "
                            f"declared table {m.group(1)}")
            elif k == "while":
                walk(node[2])
            elif k == "if":
                walk(node[2])
                walk(node[3])
    walk(nodes)


def _split_cols(text: str):
    out, buf, depth = [], [], 0
    for ch in text:
        if ch == "(":
            depth += 1
            buf.append(ch)
        elif ch == ")":
            depth -= 1
            buf.append(ch)
        elif ch == "," and depth == 0:
            out.append("".join(buf))
            buf = []
        else:
            buf.append(ch)
    if "".join(buf).strip():
        out.append("".join(buf))
    return out


class _Return(Exception):
    def __init__(self, value):
        self.value = value


def _lit(v) -> str:
    import datetime
    from decimal import Decimal
    if v is None:
        return "NULL"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float, Decimal)):
        return str(v)
    if isinstance(v, (datetime.date, datetime.datetime, datetime.time)):
        return f"'{v.isoformat(' ') if hasattr(v, 'hour') else v}'" \
            if isinstance(v, datetime.datetime) else f"'{v}'"
    return "'" + str(v).replace("'", "''") + "'"


def run_psm_body(session, body: str, env: dict):
    """Interpret a PSM body with the given parameter environment;
    returns the RETURN value (or None)."""
    body = strip_line_comments(body)
    stmts = _split_stmts(body)
    low = body.strip().lower()
    if low.startswith("begin"):
        # strip BEGIN/END wrapper statements
        if stmts and stmts[0].lower().startswith("begin"):
            first = stmts[0][5:].strip()
            stmts = ([first] if first else []) + stmts[1:]
        if stmts and stmts[-1].lower() == "end":
            stmts = stmts[:-1]
        elif stmts and stmts[-1].lower().endswith("end"):
            stmts[-1] = stmts[-1][:-3].strip()
            if not stmts[-1]:
                stmts = stmts[:-1]
    nodes, _ = parse_blocks(stmts)
    env = dict(env)
    try:
        _run_nodes(session, nodes, env)
        return None
    except _Return as r:
        return r.value
    finally:
        for t in env.get("#decl_tables", []):
            try:
                session._sql(f"drop table {t}")
            except Exception:
                pass


def _subst(text: str, env: dict) -> str:
    for k, v in env.items():
        if k.startswith("#"):
            continue
        text = re.sub(rf"\b{re.escape(k)}\b", _lit(v), text,
                      flags=re.I)
    return text


def _subst_stmt(text: str, env: dict) -> str:
    """Substitute parameters into a statement, but not into an INSERT's
    column-name list (a parameter may share a column's name; the
    reference resolves by position, textual substitution must skip the
    name position)."""
    m = re.match(r"(?is)(\s*insert\s+into\s+\S+\s*\()(.*?)(\)\s*"
                 r"(?:values|select)\b.*)", text)
    if m:
        return m.group(1) + m.group(2) + _subst(m.group(3), env)
    return _subst(text, env)


def _eval(session, expr: str, env: dict):
    res = session._sql("select " + _subst(expr, env))
    return res.rows[0][0] if res is not None and res.rows else None


def _run_nodes(session, nodes: list, env: dict) -> None:
    for node in nodes:
        kind = node[0]
        if kind == "decl_table":
            # body-local table: create now, drop when the body exits
            session._sql(f"create table {node[1]} ({node[2]})")
            env.setdefault("#decl_tables", []).append(node[1])
        elif kind == "declare":
            env.setdefault(node[1], None)
        elif kind == "set":
            env[node[1]] = _eval(session, node[2], env)
        elif kind == "return":
            raise _Return(_eval(session, node[1], env))
        elif kind == "sql":
            session._sql(_subst_stmt(node[1], env))
        elif kind == "if":
            _cond, then, els = node[1], node[2], node[3]
            if bool(_eval(session, node[1], env)):
                _run_nodes(session, then, env)
            else:
                _run_nodes(session, els, env)
        elif kind == "while":
            it = 0
            while bool(_eval(session, node[1], env)):
                _run_nodes(session, node[2], env)
                it += 1
                if it > _MAX_ITER:
                    raise RuntimeError("PSM WHILE iteration limit")
        else:  # pragma: no cover
            raise ValueError(kind)
