"""String operators over dictionary-encoded columns.

The reference implements bulk string ops as C loops over the string heap
(gdk/gdk_string.c, modules/kernel/batstr.c ~9.6k+5.9k LoC) and prefilters
LIKE with string imprints (gdk/gdk_strimps.c). This design makes the
dictionary the unit of string work: any per-value function or predicate runs
once per *distinct* value on the host, and the device applies the result
with a single gather by code — asymptotically cheaper than the reference's
per-row loops whenever the dictionary is smaller than the column, which is
the common case by construction.
"""

from __future__ import annotations

import re
from typing import Optional

import numpy as np
import torch

from ..column import Cand, Column, StrDict, valid_mask
from .cuda_kernels import LIKE_ANY, LIKE_ONE

__all__ = ["like_regex", "like_cand", "lut_cand", "in_strings_cand",
           "substring", "map_dict", "concat"]


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


def like_program(pattern: str, escape: Optional[str] = None,
                 caseless: bool = False) -> np.ndarray:
    """The LIKE pattern as the program of the device matcher
    (csrc/like_match.cu): int16 ops, ``LIKE_ANY`` for ``%``, ``LIKE_ONE``
    for ``_`` (one code point) and each literal's UTF-8 bytes, lower-cased
    first when ``caseless``.  Tokenized exactly as ``like_regex`` reads the
    pattern (an escape character at its very end is itself)."""
    ops = []
    i = 0
    while i < len(pattern):
        ch = pattern[i]
        i += 1
        if escape and ch == escape and i < len(pattern):
            ch = pattern[i]
            i += 1
        elif ch in "%_":
            ops.append(LIKE_ANY if ch == "%" else LIKE_ONE)
            continue
        ops.extend((ch.lower() if caseless else ch).encode(
            "utf-8", "surrogatepass"))
    return np.array(ops, np.int16)


def _to_dev(lut: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A host lookup table on the device of the codes it will be gathered
    by.  An empty dictionary gets one slot so that the clamped gather of an
    all-nil column stays in range."""
    if len(lut) == 0:
        lut = np.zeros(1, lut.dtype)
    return torch.from_numpy(np.ascontiguousarray(lut)).to(like.device)


def _gather_lut(lut: np.ndarray, codes: torch.Tensor, nil) -> torch.Tensor:
    """lut[code] per row, ``nil`` where the code is nil."""
    ok = codes >= 0
    return torch.where(ok, _to_dev(lut, codes)[torch.where(ok, codes, 0).long()],
                       nil)


def _lut_gather(codes, count, lut, base_mask):
    live = valid_mask(codes.shape[0], count, codes.device)
    if base_mask is not None:
        live = live & base_mask
    return live & _gather_lut(lut, codes, False)


def lut_cand(col: Column, lut: np.ndarray,
             cand: Optional[Cand] = None) -> Cand:
    """Apply a per-dictionary-value boolean table to a code column."""
    base_mask = cand.as_mask(col.cap, col.data.device) \
        if (cand is not None and not cand.is_all()) else None
    m = _lut_gather(col.data, col.count, np.asarray(lut, dtype=np.bool_),
                    base_mask)
    return Cand.from_mask(m, col.count)


def like_cand(col: Column, pattern: str, negated: bool = False,
              escape: Optional[str] = None,
              cand: Optional[Cand] = None, caseless: bool = False,
              regex: bool = False) -> Cand:
    """LIKE/ILIKE predicate: host regex over the dictionary, device gather.
    NOT LIKE excludes nils (SQL three-valued logic), which the code>=0
    test in the gather already enforces. caseless = ILIKE; regex = raw
    PCRE-style pattern (modules/mal/pcre.c likematch/rematch)."""
    return lut_cand(col, like_lut(col.sdict, pattern, negated, escape,
                                  caseless, regex), cand)


def like_lut(sdict: StrDict, pattern: str, negated: bool = False,
             escape: Optional[str] = None, caseless: bool = False,
             regex: bool = False) -> np.ndarray:
    """The host's bool table of a LIKE / ILIKE / regex predicate over a
    dictionary's values (inverted for NOT): numpy's vectorized pass for
    %-only patterns, else a Python regex a value."""
    flags = re.DOTALL | (re.IGNORECASE if caseless else 0)
    lut = None
    if not regex:
        lut = _like_mask_vectorized(sdict.values, pattern, escape, caseless)
    if lut is None:
        if regex:
            rx = re.compile(pattern, flags)
            lut = sdict.match_mask(lambda v: rx.search(v) is not None)
        else:
            rx = re.compile(like_regex(pattern, escape).pattern, flags)
            lut = sdict.match_mask(lambda v: rx.match(v) is not None)
    return ~lut if negated else lut


def _like_mask_vectorized(values: np.ndarray, pattern: str,
                          escape: Optional[str],
                          caseless: bool) -> Optional[np.ndarray]:
    """Vectorized LIKE over the dictionary for %-only patterns: chained
    numpy substring finds with per-row start offsets - the strimps role
    (gdk/gdk_strimps.c:13-64 prefilters candidate strings the same way)
    but exact, so no residual check is needed.  One numpy pass per
    literal segment instead of a python regex call per distinct value
    (~10x at 1M distincts).  Returns None for patterns needing the regex
    fallback ('_' wildcards or escapes)."""
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


def in_strings_cand(col: Column, values, negated: bool = False,
                    cand: Optional[Cand] = None) -> Cand:
    vs = set(values)
    lut = col.sdict.match_mask(lambda v: v in vs)
    if negated:
        lut = ~lut
    return lut_cand(col, lut, cand)


def map_dict(col: Column, fn) -> Column:
    """Apply a per-value host function, re-encode order-preserving.

    The device-side cost is one gather (old code → new code); the host cost
    is O(|dict|). This is the engine's entire scalar-string-function story."""
    old = col.sdict.values
    mapped = [fn(v) for v in old]
    isnone = np.array([m is None for m in mapped], dtype=bool)
    new_vals = np.array(["" if m is None else str(m) for m in mapped])
    uniq, inv = np.unique(new_vals, return_inverse=True)
    remap = np.where(isnone, -1, inv).astype(np.int32)
    codes = col.data
    new_codes = torch.where(codes >= 0, _gather_lut(remap, codes, 0), codes)
    return Column(col.typ, new_codes, col.count,
                  nonil=col.nonil and not bool(isnone.any()),
                  sdict=StrDict(uniq))


def substring(col: Column, start: int, length: Optional[int] = None) -> Column:
    """SQL SUBSTRING(s FROM start FOR length), 1-based (reference:
    gdk/gdk_string.c str_substring / batstr)."""
    a = max(start - 1, 0)
    if length is None:
        return map_dict(col, lambda v: v[a:])
    return map_dict(col, lambda v: v[a:a + max(length, 0)])


def concat(a: Column, b, prefix: bool = False) -> Column:
    """String concatenation: column || const, const || column
    (prefix=True), or column || column (host re-encode — the result
    cardinality is data-dependent, so the dictionary is rebuilt)."""
    if isinstance(b, str):
        if prefix:
            return map_dict(a, lambda v: b + v)
        return map_dict(a, lambda v: v + b)
    if isinstance(b, Column):
        return concat_cols(a, b)
    raise TypeError(type(b))


def concat_cols(a: Column, b: Column) -> Column:
    """column || column: decode both sides on host, re-encode
    order-preserving (batstr concat; nil || x = nil)."""
    n = a.count
    ac = a.data[:n].cpu().numpy()
    bc = b.data[:n].cpu().numpy()
    av = a.sdict.decode(ac)
    bv = b.sdict.decode(bc)
    vals = [None if (x is None or y is None) else str(x) + str(y)
            for x, y in zip(av, bv)]
    from ..storage.columns import column_from_pyvalues
    from ..dtypes import varchar
    return column_from_pyvalues(vals, varchar(), device=a.data.device)


def map_dict_int(col: Column, fn) -> Column:
    """Per-distinct-value host function returning ints → device gather
    (length/position family, reference gdk/gdk_string.c str_length etc.)."""
    from ..dtypes import I32
    lut = np.fromiter((int(fn(v)) for v in col.sdict.values),
                      count=len(col.sdict), dtype=np.int32)
    nil = int(np.iinfo(np.int32).min)
    out = _gather_lut(lut, col.data, nil)
    out = torch.where(col.live_mask(), out, nil)
    return Column(I32, out, col.count, nonil=col.nonil)


# scalar string library over dictionaries (batstr.c parity set)
def upper(col):
    return map_dict(col, str.upper)


def lower(col):
    return map_dict(col, str.lower)


def trim(col):
    return map_dict(col, str.strip)


def ltrim(col):
    return map_dict(col, str.lstrip)


def rtrim(col):
    return map_dict(col, str.rstrip)


def length(col):
    return map_dict_int(col, len)


def replace(col, old: str, new: str):
    return map_dict(col, lambda v: v.replace(old, new))


def position(col, sub: str):
    """SQL POSITION(sub IN s): 1-based, 0 when absent."""
    return map_dict_int(col, lambda v: v.find(sub) + 1)


def left_str(col, k: int):
    return map_dict(col, lambda v: v[:max(k, 0)])


def right_str(col, k: int):
    return map_dict(col, lambda v: v[-k:] if k > 0 else "")


def lpad(col, k: int, fill: str = " "):
    return map_dict(col, lambda v: v.rjust(k, fill)[:k])


def rpad(col, k: int, fill: str = " "):
    return map_dict(col, lambda v: v.ljust(k, fill)[:k])


# ======================================================================
# text similarity (reference: monetdb5/modules/mal/txtsim.c —
# levenshtein w/ costs, dameraulevenshtein, jarowinkler, soundex,
# difference, qgramnormalize). Host DP over the dictionary's distinct
# values, one device gather per call — the dict is tiny relative to the
# column, so the device's share is one pass over the codes.
# ======================================================================
def _lev(a: str, b: str, ins: int = 1, dele: int = 1, sub: int = 1) -> int:
    if a == b:
        return 0
    la, lb = len(a), len(b)
    if la == 0:
        return lb * ins
    if lb == 0:
        return la * dele
    prev = list(range(0, (lb + 1) * ins, ins))
    for i in range(1, la + 1):
        cur = [i * dele] + [0] * lb
        ca = a[i - 1]
        for j in range(1, lb + 1):
            cur[j] = min(prev[j] + dele, cur[j - 1] + ins,
                         prev[j - 1] + (0 if ca == b[j - 1] else sub))
        prev = cur
    return prev[lb]


def _damerau(a: str, b: str) -> int:
    la, lb = len(a), len(b)
    d = [[0] * (lb + 1) for _ in range(la + 1)]
    for i in range(la + 1):
        d[i][0] = i
    for j in range(lb + 1):
        d[0][j] = j
    for i in range(1, la + 1):
        for j in range(1, lb + 1):
            cost = 0 if a[i - 1] == b[j - 1] else 1
            d[i][j] = min(d[i - 1][j] + 1, d[i][j - 1] + 1,
                          d[i - 1][j - 1] + cost)
            if i > 1 and j > 1 and a[i - 1] == b[j - 2] \
                    and a[i - 2] == b[j - 1]:
                d[i][j] = min(d[i][j], d[i - 2][j - 2] + cost)
    return d[la][lb]


def _jaro_winkler(a: str, b: str) -> float:
    if a == b:
        return 1.0
    la, lb = len(a), len(b)
    if la == 0 or lb == 0:
        return 0.0
    window = max(la, lb) // 2 - 1
    ma = [False] * la
    mb = [False] * lb
    m = 0
    for i in range(la):
        lo, hi = max(0, i - window), min(lb, i + window + 1)
        for j in range(lo, hi):
            if not mb[j] and a[i] == b[j]:
                ma[i] = mb[j] = True
                m += 1
                break
    if m == 0:
        return 0.0
    t = 0
    k = 0
    for i in range(la):
        if ma[i]:
            while not mb[k]:
                k += 1
            if a[i] != b[k]:
                t += 1
            k += 1
    jaro = (m / la + m / lb + (m - t / 2) / m) / 3
    # winkler prefix boost (standard p=0.1, max prefix 4)
    pfx = 0
    for x, y in zip(a[:4], b[:4]):
        if x != y:
            break
        pfx += 1
    return jaro + pfx * 0.1 * (1 - jaro)


_SOUNDEX_CODE = {**dict.fromkeys("bfpv", "1"), **dict.fromkeys("cgjkqsxz", "2"),
                 **dict.fromkeys("dt", "3"), "l": "4",
                 **dict.fromkeys("mn", "5"), "r": "6"}


def _soundex(s: str) -> str:
    s = "".join(c for c in s.lower() if c.isalpha())
    if not s:
        return ""
    out = s[0].upper()
    prev = _SOUNDEX_CODE.get(s[0], "")
    for c in s[1:]:
        code = _SOUNDEX_CODE.get(c, "")
        if code and code != prev:
            out += code
            if len(out) == 4:
                break
        if c not in "hw":
            prev = code
    return (out + "000")[:4]


def _qgram_normalize(s: str) -> str:
    """txtsim.c qgramnormalize: uppercase, strip non-alnum to single
    spaces."""
    out = []
    prev_space = True
    for c in s.upper():
        if c.isalnum():
            out.append(c)
            prev_space = False
        elif not prev_space:
            out.append(" ")
            prev_space = True
    return "".join(out).strip()


def map_dict_f64(col: Column, fn) -> Column:
    """Per-distinct-value host float function → device gather."""
    from ..dtypes import F64
    lut = np.fromiter((float(fn(v)) for v in col.sdict.values),
                      count=len(col.sdict), dtype=np.float64)
    out = _gather_lut(lut, col.data, float("nan"))
    out = torch.where(col.live_mask(), out, float("nan"))
    return Column(F64, out, col.count, nonil=col.nonil)


def levenshtein(col, other: str, ins: int = 1, dele: int = 1,
                sub: int = 1):
    return map_dict_int(col, lambda v: _lev(v, other, ins, dele, sub))


def editdistance(col, other: str):
    return map_dict_int(col, lambda v: _damerau(v, other))


def jarowinkler(col, other: str):
    return map_dict_f64(col, lambda v: _jaro_winkler(v, other))


def soundex(col):
    return map_dict(col, _soundex)


def difference(col, other: str):
    """soundex difference: #matching soundex positions (txtsim.c)."""
    so = _soundex(other)
    return map_dict_int(
        col, lambda v: sum(1 for x, y in zip(_soundex(v), so) if x == y))


def qgram_normalize(col):
    return map_dict(col, _qgram_normalize)


# ---------------------------------------------------------------------------
# extended batstr parity (modules/kernel/batstr.c / modules/atoms/str.c)
# ---------------------------------------------------------------------------

def repeat(col, k: int):
    return map_dict(col, lambda v: v * max(k, 0))


def reverse(col):
    return map_dict(col, lambda v: v[::-1])


def ascii_code(col):
    """ascii(s): code point of the first character (0 for empty)."""
    return map_dict_int(col, lambda v: ord(v[0]) if v else 0)


def splitpart(col, sep: str, k: int):
    """splitpart(s, sep, k): 1-based k-th field, '' when out of range
    (modules/kernel/batstr.c STRsplitpart)."""
    def f(v):
        parts = v.split(sep) if sep else [v]
        return parts[k - 1] if 1 <= k <= len(parts) else ""
    return map_dict(col, f)


def str_insert(col, start: int, length: int, repl: str):
    """insert(s, start, length, repl): replace s[start:start+length]
    (1-based, str.c STRinsert semantics: 0-based offset actually —
    MonetDB uses 0-based start here)."""
    def f(v):
        a = max(start, 0)
        return v[:a] + repl + v[a + max(length, 0):]
    return map_dict(col, f)


def trim_chars(col, chars: str, mode: str = "both"):
    fn = {"both": str.strip, "leading": str.lstrip,
          "trailing": str.rstrip}[mode]
    return map_dict(col, lambda v: fn(v, chars))


def startswith(col, prefix: str, negated: bool = False) -> Cand:
    lut = col.sdict.match_mask(lambda v: v.startswith(prefix))
    return lut_cand(col, ~lut if negated else lut)


def endswith(col, suffix: str, negated: bool = False) -> Cand:
    lut = col.sdict.match_mask(lambda v: v.endswith(suffix))
    return lut_cand(col, ~lut if negated else lut)


def contains(col, sub: str, negated: bool = False) -> Cand:
    lut = col.sdict.match_mask(lambda v: sub in v)
    return lut_cand(col, ~lut if negated else lut)


def regexp_replace(col, pattern: str, repl: str, flags: str = ""):
    """regexp_replace(s, pat, repl[, flags]) (pcre.c replace)."""
    f = re.IGNORECASE if "i" in flags else 0
    rx = re.compile(pattern, f)
    return map_dict(col, lambda v: rx.sub(repl, v))


def md5_hex(col):
    import hashlib
    return map_dict(col, lambda v: hashlib.md5(v.encode()).hexdigest())
