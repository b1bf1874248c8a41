"""JSON functions over VARCHAR columns — the analog of the reference's
json atom module (monetdb5/modules/atoms/json.c: json.isvalid, json.filter
with a JSONPath subset, json.text, json.length, json.keyarray,
json.valuearray; SQL surface in sql/scripts/40_json.sql).

Values live in the string dictionary, so each function runs once per
distinct JSON document on the host and lands as one device gather — the
same execution shape as the rest of the string library (ops/strfuncs.py).

Path subset (matches the reference's grammar json.c:40-55):
  $            whole document
  .key / ."key"  object member
  [n]          array index
  [*] / .*     wildcard (collects all members/elements)
"""

from __future__ import annotations

import json as _json
import re
from typing import List, Optional

from .strfuncs import map_dict, map_dict_int
from ..column import Column

__all__ = ["isvalid", "filter_path", "text", "length", "keyarray",
           "valuearray"]

_STEP = re.compile(r'\.(\*|"[^"]*"|[A-Za-z_][A-Za-z0-9_]*)|\[(\*|\d+)\]')


def _parse_path(path: str) -> List[object]:
    if not path.startswith("$"):
        raise ValueError(f"json path must start with $: {path!r}")
    steps: List[object] = []
    i = 1
    while i < len(path):
        m = _STEP.match(path, i)
        if m is None:
            raise ValueError(f"bad json path at {path[i:]!r}")
        key, idx = m.group(1), m.group(2)
        if key is not None:
            steps.append("*" if key == "*" else key.strip('"'))
        else:
            steps.append("*" if idx == "*" else int(idx))
        i = m.end()
    return steps


def _walk(doc, steps: List[object]) -> List[object]:
    cur = [doc]
    for s in steps:
        nxt: List[object] = []
        for d in cur:
            if s == "*":
                if isinstance(d, dict):
                    nxt.extend(d.values())
                elif isinstance(d, list):
                    nxt.extend(d)
            elif isinstance(s, int):
                if isinstance(d, list) and -len(d) <= s < len(d):
                    nxt.append(d[s])
            elif isinstance(d, dict) and s in d:
                nxt.append(d[s])
        cur = nxt
    return cur


def _loads(v: str):
    try:
        return _json.loads(v)
    except (ValueError, TypeError):
        return None


def isvalid(col: Column) -> Column:
    from ..dtypes import BOOL
    c = map_dict_int(col, lambda v: 1 if _loads(v) is not None else 0)
    return Column(BOOL, c.data == 1, c.count, nonil=col.nonil)


def filter_path(col: Column, path: str) -> Column:
    """json.filter: matches as a JSON array ([] when none) — the
    reference returns an array of all matches (json.c JSONfilter)."""
    steps = _parse_path(path)

    def f(v: str) -> str:
        doc = _loads(v)
        if doc is None:
            return ""
        out = _walk(doc, steps)
        if not out:
            return "[]"
        if len(out) == 1 and not any(s == "*" for s in steps):
            return _json.dumps(out[0], separators=(",", ":"))
        return _json.dumps(out, separators=(",", ":"))
    return map_dict(col, f)


def text(col: Column, sep: str = " ") -> Column:
    """json.text: concatenate all atomic leaf values (json.c JSONjson2text).
    """
    def leaves(d):
        if isinstance(d, dict):
            for v in d.values():
                yield from leaves(v)
        elif isinstance(d, list):
            for v in d:
                yield from leaves(v)
        elif d is not None:
            yield str(d) if not isinstance(d, bool) else \
                ("true" if d else "false")

    return map_dict(col, lambda v: sep.join(leaves(_loads(v))))


def length(col: Column) -> Column:
    """json.length: #members/elements at the top level (json.c JSONlength).
    """
    def f(v: str) -> int:
        doc = _loads(v)
        if isinstance(doc, (dict, list)):
            return len(doc)
        return 1 if doc is not None else 0
    return map_dict_int(col, f)


def keyarray(col: Column) -> Column:
    return map_dict(col, lambda v: _json.dumps(
        list(d.keys()) if isinstance(d := _loads(v), dict) else [],
        separators=(",", ":")))


def valuearray(col: Column) -> Column:
    return map_dict(col, lambda v: _json.dumps(
        list(d.values()) if isinstance(d := _loads(v), dict) else
        (d if isinstance(d, list) else []), separators=(",", ":")))
