"""LIKE over a string dictionary, on the host.

The port's copy of the two host-only functions of the reference package's
ops/strfuncs.py that the fragment lowering needs (that module imports its
array library at the top, so the functions are copied, not the module).
String predicates run once per *distinct* dictionary value on the host and
become a boolean lookup table; the device applies it with one gather by
code (``p_strpred`` in exec/fragment.py).
"""

from __future__ import annotations

import re
from typing import Optional

import numpy as np

__all__ = ["like_regex"]


def like_regex(pattern: str, escape: Optional[str] = None) -> "re.Pattern":
    """SQL LIKE pattern → anchored regex (%→.*, _→., escape handling —
    reference: modules/mal/pcre.c converts LIKE to PCRE the same way)."""
    out = []
    i = 0
    while i < len(pattern):
        ch = pattern[i]
        if escape and ch == escape and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
        i += 1
    return re.compile("^" + "".join(out) + "$", re.DOTALL)


def _like_mask_vectorized(values: np.ndarray, pattern: str,
                          escape: Optional[str],
                          caseless: bool) -> Optional[np.ndarray]:
    """Vectorized LIKE over the dictionary for %-only patterns: chained
    numpy substring finds with per-row start offsets - the strimps role
    (gdk/gdk_strimps.c:13-64 prefilters candidate strings the same way)
    but exact, so no residual check is needed.  One numpy pass per
    literal segment instead of a python regex call per distinct value.
    Returns None for patterns needing the regex fallback ('_' wildcards
    or escapes)."""
    if escape is not None or "_" in pattern:
        return None
    vals = np.asarray(values, dtype=np.str_)
    if caseless:
        vals = np.strings.lower(vals)
        pattern = pattern.lower()
    anch_start = not pattern.startswith("%")
    anch_end = not pattern.endswith("%")
    segs = [s for s in pattern.split("%") if s]
    n = len(vals)
    if not segs:
        if anch_start or anch_end:     # '' or impossible ''-anchored
            return np.strings.str_len(vals) == 0 if pattern == "" else \
                np.zeros(n, np.bool_)
        return np.ones(n, np.bool_)    # '%', '%%', ...
    m = np.ones(n, np.bool_)
    pos = np.zeros(n, np.int64)
    rest = segs
    if anch_start:
        first = segs[0]
        m &= np.strings.startswith(vals, first)
        pos = np.full(n, len(first), np.int64)
        rest = segs[1:]
    last = None
    if anch_end and rest:
        last, rest = rest[-1], rest[:-1]
    for seg in rest:
        idx = np.strings.find(vals, seg, pos)
        m &= idx >= 0
        pos = np.where(idx >= 0, idx + len(seg), pos)
    if last is not None:
        m &= np.strings.endswith(vals, last)
        m &= np.strings.str_len(vals) - len(last) >= pos
    elif anch_end and anch_start and not rest and len(segs) == 1:
        # pure literal: startswith already checked; require exact length
        m &= np.strings.str_len(vals) == len(segs[0])
    return m
