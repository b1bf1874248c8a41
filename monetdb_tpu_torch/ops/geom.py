"""Geometry module — the TPU-native rebuild of the reference's geom/
extension (geom/monetdb5/geom.c ~5.9k LoC + geomBulk.c bulk variants +
geod.c geodesic functions, SQL surface geom/sql/40_geom.sql).

Design (no libgeos): geometries live as WKT in ordinary dictionary-encoded
string columns; the executor parses each *distinct* value once on the host
(the engine's global string-function discipline) and lowers the math to
vectorized device kernels:

  * POINT columns become parallel (x, y) float64 device arrays — distance,
    DWithin, translate etc. are pure elementwise VPU work.
  * containment/intersection against a constant geometry runs a two-phase
    device pipeline: bounding-box prefilter (the R-tree analog,
    gdk/gdk_rtree.c) then an exact vectorized ray-casting / segment test
    over the polygon's padded edge list — O(n·V) fused device FLOPs
    instead of a per-row host loop.
  * geodesic distance (geod.c) is the great-circle distance on the WGS84
    mean-radius sphere, computed on device in float64.

Scalar metrics over general geometries (area, length, centroid) evaluate
once per distinct dictionary value on host and apply by gather.

The port of the reference package's ops/geom.py: the host engine (WKT,
per-distinct metrics, the exact general-geometry engine) is the reference's
code; the column math runs as torch ops on the device of the column's codes.
The [n, E] intermediates of the segment distance and the ray cast are built
a block of rows at a time, so their peak stays O(block * E) where the
reference's fused XLA kernel needed none.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..column import Column, StrDict
from ..dtypes import BOOL, F64, I32, varchar

__all__ = ["Geom", "parse_wkt", "format_wkt", "point_xy", "st_distance",
           "st_distance_geographic", "st_dwithin", "st_contains",
           "st_intersects", "st_within", "st_area", "st_length",
           "st_centroid", "st_envelope", "st_x", "st_y", "st_numpoints",
           "make_point_col", "geom_scalar", "GEOD_RADIUS",
           "geom_distance", "geom_intersects", "geom_contains_geom",
           "geom_boolean", "convex_hull", "geom_buffer", "geom_relate"]

# WGS84 mean Earth radius (m); geod.c computes exact WGS84 geodesics via
# the ellipsoid — the spherical great-circle is the TPU-kernel-friendly
# approximation (<0.5% error), documented at the SQL surface.
GEOD_RADIUS = 6371008.8


@dataclass
class Geom:
    """Host-parsed geometry. rings: list of (V,2) float arrays — for
    points one 1x2 array, linestrings one Vx2, polygons outer ring first
    then holes, multipolygon = list of (polygon rings) flattened with
    part boundaries in `parts`.  multipoint: one (N,2) ring;
    multilinestring: one ring per line; geometrycollection: `subs` holds
    the member geometries and `rings` is their concatenation (so bbox and
    point counts keep working uniformly)."""
    kind: str            # point linestring polygon multipolygon
    #                      multipoint multilinestring collection
    rings: List[np.ndarray] = field(default_factory=list)
    parts: Optional[List[int]] = None   # multipolygon: #rings per part
    srid: int = 0
    subs: Optional[List["Geom"]] = None  # collection members

    @property
    def bbox(self) -> Tuple[float, float, float, float]:
        allc = np.concatenate(self.rings)
        return (float(allc[:, 0].min()), float(allc[:, 1].min()),
                float(allc[:, 0].max()), float(allc[:, 1].max()))


_NUM = r"[-+]?\d+(?:\.\d+)?(?:[eE][-+]?\d+)?"


def _coords(body: str) -> np.ndarray:
    pts = []
    for pair in body.split(","):
        xy = pair.split()
        pts.append((float(xy[0]), float(xy[1])))
    return np.array(pts, dtype=np.float64)


def parse_wkt(s: str, srid: int = 0) -> Geom:
    """WKT → Geom (the reference parses via libgeos GEOSGeomFromWKT,
    geom.c wkbFROMSTR)."""
    s = s.strip()
    m = re.match(r"SRID=(\d+)\s*;\s*(.*)", s, re.I | re.S)
    if m:
        srid = int(m.group(1))
        s = m.group(2)
    head, _, rest = s.partition("(")
    head = head.strip().upper()
    body = rest.rsplit(")", 1)[0]
    if head == "POINT":
        return Geom("point", [_coords(body)], srid=srid)
    if head == "LINESTRING":
        return Geom("linestring", [_coords(body)], srid=srid)
    if head == "POLYGON":
        rings = [_coords(r.strip().lstrip("(").rstrip(")"))
                 for r in re.split(r"\)\s*,\s*\(", body)]
        return Geom("polygon", rings, srid=srid)
    if head == "MULTIPOLYGON":
        parts, rings = [], []
        for part in re.split(r"\)\s*\)\s*,\s*\(\s*\(", body):
            pr = [_coords(r.strip().lstrip("(").rstrip(")"))
                  for r in re.split(r"\)\s*,\s*\(", part)]
            rings += pr
            parts.append(len(pr))
        return Geom("multipolygon", rings, parts=parts, srid=srid)
    if head == "MULTIPOINT":
        # both spellings: MULTIPOINT (1 2, 3 4) and ((1 2), (3 4))
        return Geom("multipoint",
                    [_coords(body.replace("(", "").replace(")", ""))],
                    srid=srid)
    if head == "MULTILINESTRING":
        rings = [_coords(r.strip().lstrip("(").rstrip(")"))
                 for r in re.split(r"\)\s*,\s*\(", body)]
        return Geom("multilinestring", rings, srid=srid)
    if head == "GEOMETRYCOLLECTION":
        if head == "GEOMETRYCOLLECTION" and body.strip().upper() in \
                ("", "EMPTY"):
            return Geom("collection", [], srid=srid, subs=[])
        subs, depth, start = [], 0, 0
        for i, ch in enumerate(body):
            if ch == "(":
                depth += 1
            elif ch == ")":
                depth -= 1
            elif ch == "," and depth == 0:
                subs.append(parse_wkt(body[start:i], srid))
                start = i + 1
        subs.append(parse_wkt(body[start:], srid))
        rings = [r for g in subs for r in g.rings]
        return Geom("collection", rings, srid=srid, subs=subs)
    if s.upper().endswith("EMPTY"):
        kind = head.split()[0].lower()
        kind = {"geometrycollection": "collection"}.get(kind, kind)
        return Geom(kind, [], srid=srid,
                    subs=[] if kind == "collection" else None)
    raise ValueError(f"unsupported WKT: {s[:40]}")


def _fmt_ring(r: np.ndarray) -> str:
    return ", ".join(f"{x:.10g} {y:.10g}" for x, y in r)


def format_wkt(g: Geom) -> str:
    if not g.rings and g.kind != "collection":
        return {"point": "POINT", "linestring": "LINESTRING",
                "polygon": "POLYGON", "multipoint": "MULTIPOINT",
                "multilinestring": "MULTILINESTRING",
                "multipolygon": "MULTIPOLYGON"}[g.kind] + " EMPTY"
    if g.kind == "point":
        x, y = g.rings[0][0]
        return f"POINT ({x:.10g} {y:.10g})"
    if g.kind == "linestring":
        return f"LINESTRING ({_fmt_ring(g.rings[0])})"
    if g.kind == "polygon":
        return "POLYGON (" + ", ".join(
            f"({_fmt_ring(r)})" for r in g.rings) + ")"
    if g.kind == "multipoint":
        return "MULTIPOINT (" + _fmt_ring(g.rings[0]) + ")"
    if g.kind == "multilinestring":
        return "MULTILINESTRING (" + ", ".join(
            f"({_fmt_ring(r)})" for r in g.rings) + ")"
    if g.kind == "collection":
        if not g.subs:
            return "GEOMETRYCOLLECTION EMPTY"
        return "GEOMETRYCOLLECTION (" + ", ".join(
            format_wkt(s) for s in g.subs) + ")"
    i = 0
    parts = []
    for n in g.parts or [len(g.rings)]:
        parts.append("(" + ", ".join(
            f"({_fmt_ring(r)})" for r in g.rings[i:i + n]) + ")")
        i += n
    return "MULTIPOLYGON (" + ", ".join(parts) + ")"


# ---------------------------------------------------------------------------
# column decomposition: WKT string column → device coordinate arrays
# ---------------------------------------------------------------------------

#: elements of one [rows, edges] intermediate of the segment distance and
#: the ray cast (2^24 float64 = 128 MiB); a larger product runs in blocks
#: of rows
_BLOCK_ELEMS = 1 << 24


def _lut_gather(lut: np.ndarray, codes: torch.Tensor) -> torch.Tensor:
    """lut[code] per row on the codes' device; a nil code (< 0) reads the
    LUT's last slot, which holds the nil value."""
    idx = torch.where(codes >= 0, codes, len(lut) - 1).long()
    return torch.from_numpy(lut).to(codes.device)[idx]


def _dev(v, like: torch.Tensor) -> torch.Tensor:
    """Host numbers (numpy / python) as a float64 tensor on ``like``'s
    device."""
    return torch.as_tensor(np.asarray(v, dtype=np.float64),
                           device=like.device)


def _row_blocks(n: int, edges: int):
    """Row ranges whose [rows, edges] intermediates stay within
    _BLOCK_ELEMS elements."""
    step = max(1, _BLOCK_ELEMS // max(edges, 1))
    return [(i, min(i + step, n)) for i in range(0, max(n, 1), step)]

def _dict_geoms(col: Column) -> List[Optional[Geom]]:
    """Parse each distinct dictionary value once (cached on the StrDict)."""
    sd = col.sdict
    cache = getattr(sd, "_geom_cache", None)
    if cache is None:
        cache = []
        for v in sd.values:
            try:
                cache.append(parse_wkt(str(v)))
            except Exception:
                cache.append(None)     # nil-only dict slots stay inert
        sd._geom_cache = cache
    return cache


def point_xy(col: Column) -> Tuple[torch.Tensor, torch.Tensor,
                                   torch.Tensor]:
    """POINT column → (x, y, valid) device arrays. Non-point / nil rows
    are invalid (NaN coordinates)."""
    geoms = _dict_geoms(col)
    n = len(geoms)
    xs = np.full(n + 1, np.nan)
    ys = np.full(n + 1, np.nan)
    for i, g in enumerate(geoms):
        if g is not None and g.kind == "point":
            xs[i], ys[i] = g.rings[0][0]
    x = _lut_gather(xs, col.data)
    y = _lut_gather(ys, col.data)
    return x, y, ~(torch.isnan(x) | torch.isnan(y))


def make_point_col(x: Column, y: Column) -> Column:
    """ST_MakePoint/ST_Point over two numeric columns → WKT point column
    (geom.c geomMakePoint2)."""
    n = x.count
    xv = x.data[:n].cpu().numpy().astype(np.float64)
    yv = y.data[:n].cpu().numpy().astype(np.float64)
    vals = [f"POINT ({a:.10g} {b:.10g})" for a, b in zip(xv, yv)]
    from ..storage.columns import column_from_pyvalues
    return column_from_pyvalues(vals, varchar(), device=x.data.device)


def _f64_col(data, count, nonil=False) -> Column:
    return Column(F64, data, count, nonil=nonil)


def _bool_col(data, count) -> Column:
    return Column(BOOL, data, count, nonil=True)


# ---------------------------------------------------------------------------
# device kernels
# ---------------------------------------------------------------------------

def st_x(col: Column) -> Column:
    x, _y, _v = point_xy(col)
    return _f64_col(x, col.count)


def st_y(col: Column) -> Column:
    _x, y, _v = point_xy(col)
    return _f64_col(y, col.count)


def st_distance(a: Column, b) -> Column:
    """Euclidean distance. point-column × point-column/constant runs as
    one fused elementwise kernel (geomBulk.c wkbDistance_bat); general
    geometries fall back to exact host math per distinct value."""
    ax, ay, _ = point_xy(a)
    if isinstance(b, Column):
        bx, by, _ = point_xy(b)
    else:
        g = b if isinstance(b, Geom) else parse_wkt(str(b))
        if g.kind != "point":
            return _host_distance_to(a, g)
        bx, by = g.rings[0][0]
    d = torch.sqrt((ax - bx) ** 2 + (ay - by) ** 2)
    return _f64_col(d, a.count)


def _host_distance_to(a: Column, g: Geom) -> Column:
    """point column → min distance to a general geometry's segments."""
    segs = _all_segments(g)
    ax, ay, _ = point_xy(a)
    x1, y1, x2, y2 = (_dev(segs[:, i], ax) for i in range(4))
    dx, dy = x2 - x1, y2 - y1
    ln = dx * dx + dy * dy
    den = torch.where(ln == 0, 1.0, ln)
    parts = []
    for lo, hi in _row_blocks(ax.shape[0], len(segs)):
        bx, by = ax[lo:hi, None], ay[lo:hi, None]
        t = torch.clamp(((bx - x1) * dx + (by - y1) * dy) / den, 0.0, 1.0)
        px, py = x1 + t * dx, y1 + t * dy
        d = torch.sqrt((bx - px) ** 2 + (by - py) ** 2)
        parts.append(torch.amin(d, dim=1))
    dist = torch.cat(parts)
    if g.kind in ("polygon", "multipolygon"):
        inside = _raycast(ax, ay, g)
        dist = torch.where(inside, 0.0, dist)
    return _f64_col(dist, a.count)


def st_distance_geographic(a: Column, b) -> Column:
    """Great-circle distance in meters on the mean-radius sphere
    (geod.c wkbDistanceGeographic; exact WGS84 geodesic replaced by the
    spherical formula — device-friendly, <0.5% of the ellipsoid)."""
    ax, ay, _ = point_xy(a)        # x=lon, y=lat (degrees)
    if isinstance(b, Column):
        bx, by, _ = point_xy(b)
    else:
        g = b if isinstance(b, Geom) else parse_wkt(str(b))
        bx, by = g.rings[0][0]
    if not isinstance(by, torch.Tensor):
        bx, by = _dev(bx, ax), _dev(by, ax)
    rad = math.pi / 180.0
    la1, la2 = ay * rad, by * rad
    dlat = (by - ay) * rad / 2
    dlon = (bx - ax) * rad / 2
    h = torch.sin(dlat) ** 2 + torch.cos(la1) * torch.cos(la2) * \
        torch.sin(dlon) ** 2
    d = 2 * GEOD_RADIUS * torch.arcsin(torch.sqrt(torch.clamp(h, 0.0, 1.0)))
    return _f64_col(d, a.count)


def st_dwithin(a: Column, b, dist: float,
               geographic: bool = False) -> Column:
    d = (st_distance_geographic if geographic else st_distance)(a, b)
    return _bool_col(d.data <= dist, a.count)


def _all_segments(g: Geom) -> np.ndarray:
    """All edges of all rings as an (E,4) array [x1 y1 x2 y2]."""
    segs = []
    for r in g.rings:
        if len(r) < 2:
            continue
        a = r
        b = np.roll(r, -1, axis=0)
        if g.kind == "linestring":
            a, b = r[:-1], r[1:]
        segs.append(np.concatenate([a, b], axis=1))
    return np.concatenate(segs) if segs else np.zeros((0, 4))


def _raycast(px: torch.Tensor, py: torch.Tensor, g: Geom) -> torch.Tensor:
    """Vectorized even-odd point-in-polygon over the polygon's padded edge
    list: O(n·V) device work, a block of rows at a time, replaces the
    per-row GEOSContains call (the exact phase after the bbox prefilter)."""
    segs = _all_segments(g)
    x1, y1 = _dev(segs[:, 0], px), _dev(segs[:, 1], px)
    x2, y2 = _dev(segs[:, 2], px), _dev(segs[:, 3], px)
    dy = torch.where(y2 == y1, 1.0, y2 - y1)
    dx = x2 - x1
    parts = []
    for lo, hi in _row_blocks(px.shape[0], len(segs)):
        py_ = py[lo:hi, None]
        px_ = px[lo:hi, None]
        straddle = (y1 > py_) != (y2 > py_)
        xs = x1 + (py_ - y1) * dx / dy
        parts.append(torch.sum(straddle & (px_ < xs), dim=1))
    crossings = torch.cat(parts)
    return (crossings % 2) == 1


def st_contains(container, pts: Column) -> Column:
    """ST_Contains(constant polygon, point column): bbox prefilter then
    exact ray cast — the rtree-then-exact two-phase of the reference
    (gdk_rtree.c prefilter + GEOSContains exact)."""
    g = container if isinstance(container, Geom) else \
        parse_wkt(str(container))
    px, py, valid = point_xy(pts)
    xmin, ymin, xmax, ymax = g.bbox
    inbox = (px >= xmin) & (px <= xmax) & (py >= ymin) & (py <= ymax)
    exact = _raycast(px, py, g)
    return _bool_col(valid & inbox & exact, pts.count)


def st_within(pts: Column, container) -> Column:
    return st_contains(container, pts)


def st_intersects(a: Column, b) -> Column:
    """point column × constant geometry: containment/boundary test.
    For polygons this equals st_contains ∪ on-boundary; the boundary set
    has measure zero, so the containment kernel is the practical test
    (the reference delegates to GEOSIntersects)."""
    g = b if isinstance(b, Geom) else parse_wkt(str(b))
    if g.kind in ("polygon", "multipolygon"):
        return st_contains(g, a)
    d = _host_distance_to(a, g)
    return _bool_col(d.data <= 1e-12, a.count)


# ---------------------------------------------------------------------------
# per-distinct-value host metrics (area/length/centroid/envelope)
# ---------------------------------------------------------------------------

def _ring_area(r: np.ndarray) -> float:
    x, y = r[:, 0], r[:, 1]
    return 0.5 * float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))


def geom_area(g: Geom) -> float:
    """Shoelace; holes subtract (geom.c wkbArea → GEOSArea)."""
    if g.kind == "collection":
        return sum(geom_area(s) for s in g.subs or [])
    if g.kind not in ("polygon", "multipolygon") or not g.rings:
        return 0.0
    areas = [abs(_ring_area(r)) for r in g.rings]
    if g.kind == "polygon":
        return areas[0] - sum(areas[1:])
    out, i = 0.0, 0
    for n in g.parts or [len(g.rings)]:
        out += areas[i] - sum(areas[i + 1:i + n])
        i += n
    return out


def geom_length(g: Geom) -> float:
    """Perimeter / line length (geom.c wkbLength)."""
    total = 0.0
    for r in g.rings:
        a = r
        b = np.roll(r, -1, axis=0)
        if g.kind == "linestring":
            a, b = r[:-1], r[1:]
        total += float(np.sum(np.hypot(b[:, 0] - a[:, 0],
                                       b[:, 1] - a[:, 1])))
    return total


def geom_centroid(g: Geom) -> Tuple[float, float]:
    if g.kind == "point":
        return tuple(g.rings[0][0])
    if g.kind == "linestring":
        r = g.rings[0]
        seg = np.hypot(np.diff(r[:, 0]), np.diff(r[:, 1]))
        mid = (r[:-1] + r[1:]) / 2
        w = seg.sum()
        if w == 0:
            return tuple(r[0])
        return (float((mid[:, 0] * seg).sum() / w),
                float((mid[:, 1] * seg).sum() / w))
    # polygon centroid (outer ring, holes subtract)
    cx = cy = aa = 0.0
    for j, r in enumerate(g.rings):
        x, y = r[:, 0], r[:, 1]
        cross = x * np.roll(y, -1) - np.roll(x, -1) * y
        a = 0.5 * cross.sum()
        if a == 0:
            continue
        sx = float(np.sum((x + np.roll(x, -1)) * cross) / (6 * a)) * a
        sy = float(np.sum((y + np.roll(y, -1)) * cross) / (6 * a)) * a
        sgn = 1.0 if (g.kind != "polygon" or j == 0) else -1.0
        cx += sgn * sx
        cy += sgn * sy
        aa += sgn * a
    return (cx / aa, cy / aa) if aa else tuple(g.rings[0][0])


def _map_geom_f64(col: Column, fn) -> Column:
    geoms = _dict_geoms(col)
    lut = np.array([np.nan if g is None else fn(g) for g in geoms]
                   + [np.nan])
    return _f64_col(_lut_gather(lut, col.data), col.count)


def st_area(col: Column) -> Column:
    return _map_geom_f64(col, geom_area)


def st_length(col: Column) -> Column:
    return _map_geom_f64(col, geom_length)


def st_numpoints(col: Column) -> Column:
    geoms = _dict_geoms(col)
    lut = np.array([-2**31 if g is None else sum(len(r) for r in g.rings)
                    for g in geoms] + [-2**31], dtype=np.int32)
    return Column(I32, _lut_gather(lut, col.data), col.count)


def _map_geom_str(col: Column, fn) -> Column:
    from .strfuncs import map_dict

    def run(v):
        v = str(v)
        if not v.strip():
            return None        # nil-channel dictionary slot
        return fn(parse_wkt(v))
    return map_dict(col, run)


def st_centroid(col: Column) -> Column:
    def f(g):
        x, y = geom_centroid(g)
        return f"POINT ({x:.10g} {y:.10g})"
    return _map_geom_str(col, f)


def st_astext(col: Column) -> Column:
    return _map_geom_str(col, format_wkt)


def st_envelope(col: Column) -> Column:
    def f(g):
        x0, y0, x1, y1 = g.bbox
        return (f"POLYGON (({x0:.10g} {y0:.10g}, {x1:.10g} {y0:.10g}, "
                f"{x1:.10g} {y1:.10g}, {x0:.10g} {y1:.10g}, "
                f"{x0:.10g} {y0:.10g}))")
    return _map_geom_str(col, f)


# ---------------------------------------------------------------------------
# exact general-geometry engine (host; runs once per distinct dict value)
#
# The reference delegates every two-geometry operation to libgeos
# (geom.c wkbspatial → GEOSIntersects/GEOSIntersection/…).  This is an
# original implementation of the same OGC surface: exact segment-
# intersection predicates, boundary-classification boolean ops
# (intersection/union/difference/symdifference), monotone-chain convex
# hull, and piecewise buffer.  Column-level calls evaluate per *distinct*
# dictionary value and broadcast by device gather, so an n-row column
# with k distincts costs k host evaluations + one O(n) LUT gather.
# ---------------------------------------------------------------------------

_EPS = 1e-9


def _iter_polys(g: Geom):
    """Yield each polygon part as its ring list (outer first, even-odd)."""
    if g.kind == "polygon":
        if g.rings:
            yield g.rings
    elif g.kind == "multipolygon":
        i = 0
        for n in g.parts or ([len(g.rings)] if g.rings else []):
            yield g.rings[i:i + n]
            i += n
    elif g.kind == "collection":
        for s in g.subs or []:
            yield from _iter_polys(s)


def _iter_lines(g: Geom):
    if g.kind == "linestring":
        yield from g.rings
    elif g.kind == "multilinestring":
        yield from g.rings
    elif g.kind == "collection":
        for s in g.subs or []:
            yield from _iter_lines(s)


def _iter_points(g: Geom) -> np.ndarray:
    out = []
    if g.kind == "point" and g.rings:
        out.append(g.rings[0][:1])
    elif g.kind == "multipoint" and g.rings:
        out.append(g.rings[0])
    elif g.kind == "collection":
        for s in g.subs or []:
            p = _iter_points(s)
            if len(p):
                out.append(p)
    return np.concatenate(out) if out else np.zeros((0, 2))


def _segs_of_rings(rings, closed=True) -> np.ndarray:
    segs = []
    for r in rings:
        if len(r) < 2:
            continue
        a, b = (r, np.roll(r, -1, axis=0)) if closed else (r[:-1], r[1:])
        segs.append(np.concatenate([a, b], axis=1))
    return np.concatenate(segs) if segs else np.zeros((0, 4))


def _boundary_segs(g: Geom) -> np.ndarray:
    """All boundary segments: polygon rings closed, lines open."""
    out = [np.zeros((0, 4))]
    for rings in _iter_polys(g):
        out.append(_segs_of_rings(rings, closed=True))
    lines = list(_iter_lines(g))
    if lines:
        out.append(_segs_of_rings(lines, closed=False))
    return np.concatenate(out)


def _pts_in_rings(pts: np.ndarray, rings) -> np.ndarray:
    """Even-odd point-in-polygon over a ring list (holes included)."""
    if not len(pts):
        return np.zeros(0, bool)
    segs = _segs_of_rings(rings, closed=True)
    if not len(segs):
        return np.zeros(len(pts), bool)
    px, py = pts[:, 0:1], pts[:, 1:2]
    x1, y1, x2, y2 = (segs[:, i][None, :] for i in range(4))
    straddle = (y1 > py) != (y2 > py)
    dy = np.where(y2 == y1, 1.0, y2 - y1)
    xs = x1 + (py - y1) * (x2 - x1) / dy
    return (np.sum(straddle & (px < xs), axis=1) % 2) == 1


def _pts_in_geom(pts: np.ndarray, g: Geom) -> np.ndarray:
    """Inside any polygon part of g (even-odd, exclusive of holes)."""
    out = np.zeros(len(pts), bool)
    for rings in _iter_polys(g):
        out |= _pts_in_rings(pts, rings)
    return out


def _pt_seg_dist(pts: np.ndarray, segs: np.ndarray) -> np.ndarray:
    """(N,2) points × (E,4) segments → (N,E) distances."""
    if not len(pts) or not len(segs):
        return np.full((len(pts), max(len(segs), 1)), np.inf)
    x1, y1, x2, y2 = (segs[:, i][None, :] for i in range(4))
    px, py = pts[:, 0:1], pts[:, 1:2]
    dx, dy = x2 - x1, y2 - y1
    ln = dx * dx + dy * dy
    t = np.clip(((px - x1) * dx + (py - y1) * dy)
                / np.where(ln == 0, 1.0, ln), 0.0, 1.0)
    return np.hypot(px - (x1 + t * dx), py - (y1 + t * dy))


def _segs_touch(s1: np.ndarray, s2: np.ndarray, proper_only=False):
    """Any segment of s1 intersects any of s2 (touching counts unless
    proper_only). Orientation tests, vectorized over the pair grid."""
    if not len(s1) or not len(s2):
        return False
    ax, ay, bx, by = (s1[:, i][:, None] for i in range(4))
    cx, cy, dx, dy = (s2[:, i][None, :] for i in range(4))

    def cross(ox, oy, px, py, qx, qy):
        return (px - ox) * (qy - oy) - (py - oy) * (qx - ox)

    d1 = cross(ax, ay, bx, by, cx, cy)
    d2 = cross(ax, ay, bx, by, dx, dy)
    d3 = cross(cx, cy, dx, dy, ax, ay)
    d4 = cross(cx, cy, dx, dy, bx, by)
    proper = (((d1 > _EPS) & (d2 < -_EPS)) | ((d1 < -_EPS) & (d2 > _EPS))) \
        & (((d3 > _EPS) & (d4 < -_EPS)) | ((d3 < -_EPS) & (d4 > _EPS)))
    if proper_only:
        return bool(proper.any())

    def onseg(dv, px, py, ox, oy, qx, qy):
        return (np.abs(dv) <= _EPS) \
            & (px >= np.minimum(ox, qx) - _EPS) \
            & (px <= np.maximum(ox, qx) + _EPS) \
            & (py >= np.minimum(oy, qy) - _EPS) \
            & (py <= np.maximum(oy, qy) + _EPS)

    touch = onseg(d1, cx, cy, ax, ay, bx, by) \
        | onseg(d2, dx, dy, ax, ay, bx, by) \
        | onseg(d3, ax, ay, cx, cy, dx, dy) \
        | onseg(d4, bx, by, cx, cy, dx, dy)
    return bool((proper | touch).any())


def _sample_pts(g: Geom) -> np.ndarray:
    """Vertices + standalone points — the finite witness set."""
    pts = [np.zeros((0, 2))] + [r for r in g.rings if len(r)]
    return np.concatenate(pts)


def _bbox_disjoint(g: Geom, h: Geom) -> bool:
    if not g.rings or not h.rings:
        return True
    a, b = g.bbox, h.bbox
    return a[2] < b[0] - _EPS or b[2] < a[0] - _EPS \
        or a[3] < b[1] - _EPS or b[3] < a[1] - _EPS


def geom_intersects(g: Geom, h: Geom) -> bool:
    """Exact ST_Intersects for any geometry pair (touch counts)."""
    if _bbox_disjoint(g, h):
        return False
    if _segs_touch(_boundary_segs(g), _boundary_segs(h)):
        return True
    if _pts_in_geom(_sample_pts(g), h).any():
        return True
    if _pts_in_geom(_sample_pts(h), g).any():
        return True
    # point-on-line / point-point
    pg, ph = _sample_pts(g), _sample_pts(h)
    sg, sh = _boundary_segs(g), _boundary_segs(h)
    if len(pg) and len(sh) and (_pt_seg_dist(pg, sh) <= _EPS).any():
        return True
    if len(ph) and len(sg) and (_pt_seg_dist(ph, sg) <= _EPS).any():
        return True
    if len(pg) and len(ph):
        d = np.hypot(pg[:, 0:1] - ph[None, :, 0].reshape(1, -1),
                     pg[:, 1:2] - ph[None, :, 1].reshape(1, -1))
        if (d <= _EPS).any():
            return True
    return False


def geom_distance(g: Geom, h: Geom) -> float:
    """Exact min distance (0 when intersecting) — geom.c wkbDistance."""
    if geom_intersects(g, h):
        return 0.0
    best = np.inf
    sg, sh = _boundary_segs(g), _boundary_segs(h)
    pg, ph = _sample_pts(g), _sample_pts(h)
    if len(pg) and len(sh):
        best = min(best, float(_pt_seg_dist(pg, sh).min()))
    if len(ph) and len(sg):
        best = min(best, float(_pt_seg_dist(ph, sg).min()))
    if len(pg) and len(ph):
        d = np.hypot(pg[:, None, 0] - ph[None, :, 0],
                     pg[:, None, 1] - ph[None, :, 1])
        best = min(best, float(d.min()))
    return best


def _subdivide_ring(r: np.ndarray, osegs: np.ndarray) -> np.ndarray:
    """Insert every intersection with `osegs` into the closed ring `r`."""
    pts = []
    n = len(r)
    for i in range(n):
        a, b = r[i], r[(i + 1) % n]
        pts.append(a)
        if len(osegs):
            ax, ay = a
            bx, by = b
            cx, cy, dx, dy = (osegs[:, k] for k in range(4))
            rxs = bx - ax
            rys = by - ay
            sxs = dx - cx
            sys_ = dy - cy
            den = rxs * sys_ - rys * sxs
            ok = np.abs(den) > 1e-15
            den = np.where(ok, den, 1.0)
            t = ((cx - ax) * sys_ - (cy - ay) * sxs) / den
            u = ((cx - ax) * rys - (cy - ay) * rxs) / den
            hit = ok & (t > 1e-12) & (t < 1 - 1e-12) \
                & (u >= -1e-12) & (u <= 1 + 1e-12)
            ts = list(t[hit])
            # collinear overlaps produce no crossing: also split at the
            # other boundary's vertices that lie ON this edge
            ln2 = rxs * rxs + rys * rys
            if ln2 > 0:
                for px_, py_ in np.concatenate(
                        [osegs[:, :2], osegs[:, 2:]]):
                    tv = ((px_ - ax) * rxs + (py_ - ay) * rys) / ln2
                    if 1e-9 < tv < 1 - 1e-9:
                        qx, qy = ax + tv * rxs, ay + tv * rys
                        if abs(qx - px_) + abs(qy - py_) <= 1e-9:
                            ts.append(tv)
            for t_ in sorted(set(np.round(ts, 12))):
                pts.append(np.array([ax + t_ * rxs, ay + t_ * rys]))
    return np.array(pts) if pts else np.zeros((0, 2))


def _interior_pt(ring: np.ndarray):
    """A point strictly inside a simple ring (ear-midpoint probe)."""
    n = len(ring)
    for i in range(n):
        c = (ring[(i - 1) % n] + ring[i] + ring[(i + 1) % n]) / 3.0
        if _pts_in_rings(c[None], [ring])[0]:
            return c
    return ring.mean(axis=0)


def _stitch(edges) -> List[np.ndarray]:
    """Chain directed edges into closed rings (endpoint hash join)."""
    def key(p):
        return (round(float(p[0]) / 1e-9), round(float(p[1]) / 1e-9))
    by_start = {}
    for i, (p, q) in enumerate(edges):
        by_start.setdefault(key(p), []).append(i)
    used = [False] * len(edges)
    rings = []
    for i in range(len(edges)):
        if used[i]:
            continue
        path = [edges[i][0]]
        cur = i
        used[i] = True
        guard = 0
        while guard <= len(edges):
            guard += 1
            q = edges[cur][1]
            kq = key(q)
            if kq == key(path[0]):
                if len(path) >= 3:
                    rings.append(np.array(path))
                break
            path.append(q)
            nxt = None
            for j in by_start.get(kq, []):
                if not used[j]:
                    nxt = j
                    break
            if nxt is None:
                break
            used[nxt] = True
            cur = nxt
    return [r for r in rings if abs(_ring_area(r)) > 1e-12]


def _assemble(rings: List[np.ndarray]) -> Geom:
    """Rings → polygon/multipolygon with even-odd hole nesting."""
    if not rings:
        return Geom("polygon", [])
    order = sorted(range(len(rings)), key=lambda i: -abs(_ring_area(rings[i])))
    depth = []
    for i in order:
        p = _interior_pt(rings[i])
        d = sum(1 for j in order if j != i
                and abs(_ring_area(rings[j])) > abs(_ring_area(rings[i]))
                and _pts_in_rings(p[None], [rings[j]])[0])
        depth.append(d)
    outers = [order[k] for k in range(len(order)) if depth[k] % 2 == 0]
    if len(outers) == 1:
        holes = [rings[order[k]] for k in range(len(order))
                 if depth[k] % 2 == 1]
        return Geom("polygon", [rings[outers[0]]] + holes)
    parts, flat = [], []
    for o in outers:
        po = _interior_pt(rings[o])
        mine = [rings[o]]
        for k in range(len(order)):
            j = order[k]
            if depth[k] % 2 == 1 and \
                    _pts_in_rings(_interior_pt(rings[j])[None],
                                  [rings[o]])[0]:
                mine.append(rings[j])
        del po
        parts.append(len(mine))
        flat += mine
    return Geom("multipolygon", flat, parts=parts)


def geom_boolean(op: str, g: Geom, h: Geom) -> Geom:
    """Polygon boolean ops: intersection | union | difference |
    symdifference — boundary classification: subdivide each boundary at
    the other's crossings, keep edges by inside/outside test, stitch
    (the role of GEOSIntersection/Union/Difference in geom.c)."""
    if op == "symdifference":
        a = geom_boolean("difference", g, h)
        b = geom_boolean("difference", h, g)
        rings = a.rings + b.rings
        parts = ([len(a.rings)] if a.kind == "polygon" else
                 list(a.parts or [])) + \
                ([len(b.rings)] if b.kind == "polygon" else
                 list(b.parts or []))
        parts = [p for p in parts if p]
        if not rings:
            return Geom("polygon", [])
        return Geom("multipolygon", rings, parts=parts) \
            if len(parts) > 1 else Geom("polygon", rings)
    ga = list(_iter_polys(g))
    gb = list(_iter_polys(h))
    A = [r for rings in ga for r in rings]
    B = [r for rings in gb for r in rings]
    if not A or not B:
        if op == "intersection":
            return Geom("polygon", [])
        if op == "union":
            return _assemble(A + B)
        return _assemble(A) if op == "difference" else Geom("polygon", [])
    segs_a, segs_b = _segs_of_rings(A), _segs_of_rings(B)
    allc = np.concatenate(A + B)
    delta = 1e-7 * max(float(np.abs(allc).max()), 1.0)
    edges = []
    for src, (rings, selfg, other, osegs) in enumerate((
            (A, g, h, segs_b), (B, h, g, segs_a))):
        for r in rings:
            pts = _subdivide_ring(r, osegs)
            n = len(pts)
            for i in range(n):
                p, q = pts[i], pts[(i + 1) % n]
                d = q - p
                ln = float(np.hypot(*d))
                if ln <= 1e-12:
                    continue
                mid = (p + q) / 2.0
                nrm = np.array([-d[1], d[0]]) / ln
                # which side of the edge is selfg's interior?
                sgn = 1.0 if _pts_in_geom((mid + delta * nrm)[None],
                                          selfg)[0] else -1.0
                int_in = bool(_pts_in_geom((mid + sgn * delta * nrm)[None],
                                           other)[0])
                ext_in = bool(_pts_in_geom((mid - sgn * delta * nrm)[None],
                                           other)[0])
                onb = float(_pt_seg_dist(mid[None], osegs).min()) <= 1e-9 \
                    if len(osegs) else False
                # collinear shared edges: keep a single copy (side A's)
                dedup = onb and src == 1
                if op == "intersection":
                    keep, rev = int_in and not dedup, False
                elif op == "union":
                    keep, rev = (not ext_in) and not dedup, False
                else:  # difference g - h
                    if src == 0:
                        keep, rev = not int_in, False
                    else:
                        keep, rev = ext_in and not onb, True
                if keep:
                    edges.append((q, p) if rev else (p, q))
    return _assemble(_stitch(edges))


def convex_hull(g: Geom) -> Geom:
    """Monotone-chain convex hull (geom.c wkbConvexHull)."""
    pts = _sample_pts(g)
    if len(pts) == 0:
        return Geom("polygon", [])
    pts = np.unique(pts, axis=0)
    if len(pts) == 1:
        return Geom("point", [pts])
    order = np.lexsort((pts[:, 1], pts[:, 0]))
    pts = pts[order]

    def half(it):
        out = []
        for p in it:
            while len(out) >= 2:
                u, v = out[-1] - out[-2], p - out[-2]
                if u[0] * v[1] - u[1] * v[0] > 0:
                    break
                out.pop()
            out.append(p)
        return out

    lo = half(pts)
    hi = half(pts[::-1])
    hull = np.array(lo[:-1] + hi[:-1])
    if len(hull) == 2:
        return Geom("linestring", [hull])
    return Geom("polygon", [hull])


def geom_buffer(g: Geom, dist: float, quad: int = 8) -> Geom:
    """ST_Buffer: points → 4*quad-gon circles; lines/polygons → union of
    the geometry with per-edge rectangles and per-vertex circles
    (piecewise-exact Minkowski sum; arcs polygonized like GEOS's
    quad_segs).  Falls back to the convex hull of the offset circles if
    union stitching degenerates (documented approximation)."""
    k = max(4, 4 * quad)
    th = np.linspace(0, 2 * np.pi, k, endpoint=False)
    circ = np.stack([np.cos(th), np.sin(th)], axis=1) * abs(dist)

    if dist <= 0:
        if g.kind in ("polygon", "multipolygon") and dist < 0:
            # negative buffer: erode = difference with boundary sweep
            sweep = geom_buffer(Geom("multilinestring",
                                     [r for rings in _iter_polys(g)
                                      for r in (list(rings) + [rings[0]])]),
                                -dist, quad)
            return geom_boolean("difference", g, sweep)
        return g

    # convex inputs: the buffer IS the convex hull of the vertex circles
    # (exact up to arc polygonization)
    hull0 = convex_hull(g)
    pts0 = _sample_pts(g)
    if g.kind != "multipolygon" and (not list(_iter_polys(g)) or
                                     abs(geom_area(hull0) - geom_area(g))
                                     <= 1e-9 * max(geom_area(hull0), 1.0)):
        if g.kind in ("point", "multipoint") and \
                geom_num_geometries(g) > 1:
            pass                        # separate circles, not one hull
        else:
            cloud = (pts0[:, None, :] + circ[None, :, :]).reshape(-1, 2)
            return convex_hull(Geom("multipoint", [cloud]))

    # general case: union of per-edge capsules (hull of the two endpoint
    # circles — exact stadium) + the areal body itself
    pieces: List[Geom] = []
    for p in _iter_points(g):
        pieces.append(Geom("polygon", [p[None, :] + circ]))
    for s in _boundary_segs(g):
        a, b = s[:2], s[2:]
        cloud = np.concatenate([a[None, :] + circ, b[None, :] + circ])
        pieces.append(convex_hull(Geom("multipoint", [cloud])))
    if g.kind in ("polygon", "multipolygon"):
        pieces.append(Geom(g.kind, list(g.rings), parts=g.parts))
    if not pieces:
        return g
    try:
        out = pieces[0]
        for p in pieces[1:]:
            out = geom_boolean("union", out, p)
        if out.rings:
            return out
    except Exception:
        pass
    return convex_hull(Geom("multipoint",
                            [np.concatenate([_sample_pts(p)
                                             for p in pieces])]))


def _interiors_intersect(g: Geom, h: Geom) -> bool:
    ga, gb = list(_iter_polys(g)), list(_iter_polys(h))
    if ga and gb:
        return geom_area(geom_boolean("intersection", g, h)) > _EPS
    if ga or gb:
        areal, other = (g, h) if ga else (h, g)
        asegs = _boundary_segs(areal)
        # subdivide each line segment at the areal boundary; test midpoints
        for line in list(_iter_lines(other)) + \
                [p[None, :] for p in _iter_points(other)]:
            if len(line) == 1:
                if _pts_in_geom(line, areal).any():
                    return True
                continue
            for i in range(len(line) - 1):
                a, b = line[i], line[i + 1]
                cuts = _subdivide_ring(np.array([a, b, b]), asegs)
                mids = (cuts + np.roll(cuts, -1, axis=0))[:-1] / 2.0
                onb = _pt_seg_dist(mids, asegs).min(axis=1) <= _EPS \
                    if len(asegs) else np.zeros(len(mids), bool)
                if (_pts_in_geom(mids, areal) & ~onb).any():
                    return True
        return False
    # line × line: proper crossing or collinear overlap
    return _segs_touch(_boundary_segs(g), _boundary_segs(h),
                       proper_only=True) or _collinear_overlap(g, h)


def _collinear_overlap(g: Geom, h: Geom) -> bool:
    sg, sh = _boundary_segs(g), _boundary_segs(h)
    for s in sg:
        mid = (s[:2] + s[2:]) / 2.0
        if len(sh) and float(_pt_seg_dist(mid[None], sh).min()) <= _EPS:
            return True
    return False


def geom_contains_geom(g: Geom, h: Geom) -> bool:
    """ST_Contains(g, h) for areal g: every point of h inside-or-on g,
    at least one strictly inside, boundary of h never crossing out."""
    if not list(_iter_polys(g)):
        return False
    segs_g = _boundary_segs(g)
    pts = _sample_pts(h)
    if not len(pts):
        return False
    inside = _pts_in_geom(pts, g)
    onb = _pt_seg_dist(pts, segs_g).min(axis=1) <= _EPS if len(segs_g) \
        else np.zeros(len(pts), bool)
    if not bool((inside | onb).all()):
        return False
    # no boundary segment of h may properly cross g's boundary
    if _segs_touch(_boundary_segs(h), segs_g, proper_only=True):
        return False
    return bool(inside.any()) or _interiors_intersect(g, h)


def geom_equals(g: Geom, h: Geom) -> bool:
    if list(_iter_polys(g)) or list(_iter_polys(h)):
        if abs(geom_area(g) - geom_area(h)) > _EPS:
            return False
        return geom_area(geom_boolean("symdifference", g, h)) <= _EPS
    pg = np.unique(np.round(_sample_pts(g) / _EPS), axis=0)
    ph = np.unique(np.round(_sample_pts(h) / _EPS), axis=0)
    if pg.shape != ph.shape or not np.array_equal(pg, ph):
        return False
    return abs(geom_length(g) - geom_length(h)) <= _EPS


def geom_touches(g: Geom, h: Geom) -> bool:
    return geom_intersects(g, h) and not _interiors_intersect(g, h)


def geom_crosses(g: Geom, h: Geom) -> bool:
    ga, gb = bool(list(_iter_polys(g))), bool(list(_iter_polys(h)))
    if ga and gb:
        return False                      # areal×areal never "crosses"
    if ga or gb:
        areal, line = (g, h) if ga else (h, g)
        if not list(_iter_lines(line)):
            return False
        segs = _boundary_segs(areal)
        # witness points: vertices + midpoints of boundary-subdivided edges
        wit = [_sample_pts(line)]
        for ln in _iter_lines(line):
            for i in range(len(ln) - 1):
                cuts = _subdivide_ring(np.array([ln[i], ln[i + 1],
                                                 ln[i + 1]]), segs)[:-1]
                wit.append((cuts + np.roll(cuts, -1, axis=0))[:-1] / 2.0)
        pts = np.concatenate(wit)
        inside = _pts_in_geom(pts, areal)
        onb = _pt_seg_dist(pts, segs).min(axis=1) <= _EPS if len(segs) \
            else np.zeros(len(pts), bool)
        return bool((inside & ~onb).any()) and bool((~inside & ~onb).any())
    return _segs_touch(_boundary_segs(g), _boundary_segs(h),
                       proper_only=True) and not _collinear_overlap(g, h)


def geom_overlaps(g: Geom, h: Geom) -> bool:
    if not (list(_iter_polys(g)) and list(_iter_polys(h))):
        return False
    ai = geom_area(geom_boolean("intersection", g, h))
    return ai > _EPS and ai < geom_area(g) - _EPS \
        and ai < geom_area(h) - _EPS


def geom_relate(g: Geom, h: Geom) -> str:
    """Compact DE-9IM-style summary (II, IB∪BI, BB as T/F triplet) —
    enough to drive the named predicates; full 9-char matrices are the
    GEOS surface the reference re-exports."""
    ii = "T" if _interiors_intersect(g, h) else "F"
    bb = "T" if _segs_touch(_boundary_segs(g), _boundary_segs(h)) else "F"
    it = "T" if geom_intersects(g, h) else "F"
    return ii + bb + it


def geom_transform(g: Geom, src: int, dst: int) -> Geom:
    """ST_Transform between EPSG:4326 (lon/lat) and EPSG:3857 (Web
    Mercator) — the exact spherical formulas; general PROJ pipelines are
    out of scope (reference: geom.c wkbTransform → PROJ)."""
    if src == dst:
        return g
    R = 6378137.0

    def fwd(c):
        lam = np.radians(c[:, 0])
        phi = np.radians(np.clip(c[:, 1], -89.9999, 89.9999))
        return np.stack([R * lam,
                         R * np.log(np.tan(np.pi / 4 + phi / 2))], axis=1)

    def inv(c):
        return np.stack([np.degrees(c[:, 0] / R),
                         np.degrees(2 * np.arctan(np.exp(c[:, 1] / R))
                                    - np.pi / 2)], axis=1)

    if (src, dst) == (4326, 3857):
        f = fwd
    elif (src, dst) == (3857, 4326):
        f = inv
    else:
        raise ValueError(f"st_transform: unsupported {src}->{dst} "
                         "(4326<->3857 supported)")
    out = Geom(g.kind, [f(r) for r in g.rings], parts=g.parts, srid=dst,
               subs=[geom_transform(s, src, dst) for s in g.subs]
               if g.subs else None)
    return out


def geom_type_name(g: Geom) -> str:
    return {"point": "ST_Point", "linestring": "ST_LineString",
            "polygon": "ST_Polygon", "multipoint": "ST_MultiPoint",
            "multilinestring": "ST_MultiLineString",
            "multipolygon": "ST_MultiPolygon",
            "collection": "ST_GeometryCollection"}[g.kind]


def geom_dimension(g: Geom) -> int:
    if list(_iter_polys(g)):
        return 2
    if list(_iter_lines(g)):
        return 1
    return 0


def geom_num_geometries(g: Geom) -> int:
    if g.kind == "collection":
        return len(g.subs or [])
    if g.kind == "multipolygon":
        return len(g.parts or [1])
    if g.kind == "multilinestring":
        return len(g.rings)
    if g.kind == "multipoint":
        return len(g.rings[0]) if g.rings else 0
    return 1 if g.rings else 0


def geom_geometry_n(g: Geom, n: int) -> Optional[Geom]:
    """1-based ST_GeometryN."""
    i = n - 1
    if i < 0 or i >= geom_num_geometries(g):
        return None
    if g.kind == "collection":
        return (g.subs or [])[i]
    if g.kind == "multipolygon":
        off = sum((g.parts or [])[:i])
        cnt = (g.parts or [len(g.rings)])[i]
        return Geom("polygon", g.rings[off:off + cnt], srid=g.srid)
    if g.kind == "multilinestring":
        return Geom("linestring", [g.rings[i]], srid=g.srid)
    if g.kind == "multipoint":
        return Geom("point", [g.rings[0][i:i + 1]], srid=g.srid)
    return g


def geom_is_valid(g: Geom) -> bool:
    """Structural validity: rings closed-able (≥3 pts), no self-
    intersection of any polygon ring (proper crossings only)."""
    for rings in _iter_polys(g):
        for r in rings:
            if len(r) < 3:
                return False
            segs = _segs_of_rings([r])
            n = len(segs)
            for i in range(n):
                far = segs[np.r_[0:max(i - 1, 0), i + 2:n]] \
                    if n > 3 else segs[0:0]
                # skip adjacent edges (they share endpoints)
                if i == 0 and n > 3:
                    far = segs[2:n - 1]
                if len(far) and _segs_touch(segs[i:i + 1], far,
                                            proper_only=True):
                    return False
    if g.kind == "point" and g.rings and len(g.rings[0]) != 1:
        return False
    return True


def geom_is_simple(g: Geom) -> bool:
    if list(_iter_polys(g)):
        return geom_is_valid(g)
    lines = list(_iter_lines(g))
    for ln in lines:
        segs = _segs_of_rings([ln], closed=False)
        n = len(segs)
        for i in range(n):
            if i + 2 < n and _segs_touch(segs[i:i + 1], segs[i + 2:],
                                         proper_only=True):
                return False
    return True


# ---------------------------------------------------------------------------
# column-level OGC surface (geom/sql/40_geom.sql function catalog)
# ---------------------------------------------------------------------------

def _with_srid(g: Geom) -> str:
    w = format_wkt(g)
    return f"SRID={g.srid};{w}" if g.srid else w


def geom_boundary(g: Geom) -> Geom:
    """ST_Boundary: polygon → its rings as lines; line → endpoints."""
    polys = list(_iter_polys(g))
    if polys:
        rings = [np.concatenate([r, r[:1]]) for rr in polys for r in rr]
        return Geom("multilinestring", rings, srid=g.srid) \
            if len(rings) > 1 else Geom("linestring", rings, srid=g.srid)
    lines = list(_iter_lines(g))
    if lines:
        eps = np.array([p for ln in lines for p in (ln[0], ln[-1])])
        return Geom("multipoint", [eps], srid=g.srid)
    return Geom("collection", [], srid=g.srid, subs=[])


def geom_affine(g: Geom, fn) -> Geom:
    return Geom(g.kind, [fn(np.asarray(r, dtype=np.float64))
                         for r in g.rings], parts=g.parts, srid=g.srid,
                subs=[geom_affine(s, fn) for s in g.subs]
                if g.subs else None)


def geom_point_on_surface(g: Geom):
    for rings in _iter_polys(g):
        return _interior_pt(rings[0])
    pts = _sample_pts(g)
    return pts[0] if len(pts) else None


_SCALAR_GEOM_FUNCS = {}


def _geom1(name, fn, fmt=None):
    """Register a 1-geometry scalar function; fmt formats the result."""
    def run(*args):
        g = parse_wkt(str(args[0]))
        r = fn(g, *args[1:])
        return fmt(r) if fmt else r
    _SCALAR_GEOM_FUNCS[name] = run
    return run


def _fmt_geom(r):
    if r is None:
        return None
    return _with_srid(r) if isinstance(r, Geom) else r


def _fmt_point(p):
    return None if p is None else f"POINT ({p[0]:.10g} {p[1]:.10g})"


_geom1("st_area", lambda g: geom_area(g))
_geom1("st_length", lambda g: geom_length(g))
_geom1("st_perimeter", lambda g: geom_length(g))
_geom1("st_x", lambda g: float(g.rings[0][0][0]) if g.rings else None)
_geom1("st_y", lambda g: float(g.rings[0][0][1]) if g.rings else None)
_geom1("st_numpoints", lambda g: int(sum(len(r) for r in g.rings)))
_geom1("st_npoints", lambda g: int(sum(len(r) for r in g.rings)))
_geom1("st_astext", lambda g: format_wkt(g))
_geom1("st_geometrytype", geom_type_name)
_geom1("st_srid", lambda g: int(g.srid))
_geom1("st_setsrid", lambda g, srid: Geom(
    g.kind, g.rings, parts=g.parts, srid=int(srid), subs=g.subs),
    _fmt_geom)
_geom1("st_isvalid", geom_is_valid)
_geom1("st_issimple", geom_is_simple)
_geom1("st_isempty", lambda g: not g.rings and not (g.subs or []))
_geom1("st_isclosed", lambda g: bool(
    g.kind in ("linestring", "multilinestring") and g.rings
    and all(np.allclose(r[0], r[-1]) for r in g.rings)))
_geom1("st_isring", lambda g: bool(
    g.kind == "linestring" and g.rings and len(g.rings[0]) >= 4
    and np.allclose(g.rings[0][0], g.rings[0][-1]) and geom_is_simple(g)))
_geom1("st_dimension", geom_dimension)
_geom1("st_coorddim", lambda g: 2)
_geom1("st_numgeometries", geom_num_geometries)
_geom1("st_geometryn", lambda g, n: geom_geometry_n(g, int(n)), _fmt_geom)
_geom1("st_boundary", geom_boundary, _fmt_geom)
_geom1("st_convexhull", convex_hull, _fmt_geom)
_geom1("st_buffer", lambda g, d, q=8: geom_buffer(g, float(d), int(q)),
       _fmt_geom)
_geom1("st_centroid", lambda g: geom_centroid(g), _fmt_point)
_geom1("st_pointonsurface", geom_point_on_surface, _fmt_point)
_geom1("st_startpoint", lambda g: g.rings[0][0]
       if g.kind == "linestring" and g.rings else None, _fmt_point)
_geom1("st_endpoint", lambda g: g.rings[0][-1]
       if g.kind == "linestring" and g.rings else None, _fmt_point)
_geom1("st_pointn", lambda g, n: g.rings[0][int(n) - 1]
       if g.kind == "linestring" and g.rings
       and 1 <= int(n) <= len(g.rings[0]) else None, _fmt_point)
_geom1("st_exteriorring", lambda g: Geom(
    "linestring", [np.concatenate([g.rings[0], g.rings[0][:1]])],
    srid=g.srid) if g.kind == "polygon" and g.rings else None, _fmt_geom)
_geom1("st_numinteriorrings", lambda g: max(len(g.rings) - 1, 0)
       if g.kind == "polygon" else 0)
_geom1("st_interiorringn", lambda g, n: Geom(
    "linestring", [np.concatenate([g.rings[int(n)], g.rings[int(n)][:1]])],
    srid=g.srid) if g.kind == "polygon" and 1 <= int(n) < len(g.rings)
    else None, _fmt_geom)
_geom1("st_xmin", lambda g: g.bbox[0] if g.rings else None)
_geom1("st_ymin", lambda g: g.bbox[1] if g.rings else None)
_geom1("st_xmax", lambda g: g.bbox[2] if g.rings else None)
_geom1("st_ymax", lambda g: g.bbox[3] if g.rings else None)
_geom1("st_force2d", lambda g: g, _fmt_geom)
_geom1("st_translate", lambda g, dx, dy: geom_affine(
    g, lambda r: r + np.array([float(dx), float(dy)])), _fmt_geom)
_geom1("st_scale", lambda g, sx, sy: geom_affine(
    g, lambda r: r * np.array([float(sx), float(sy)])), _fmt_geom)
_geom1("st_rotate", lambda g, a: geom_affine(
    g, lambda r: r @ np.array([[math.cos(float(a)), math.sin(float(a))],
                               [-math.sin(float(a)), math.cos(float(a))]])),
    _fmt_geom)
_geom1("st_transform", lambda g, dst: geom_transform(
    g, g.srid or 4326, int(dst)), _fmt_geom)
_geom1("st_envelope", lambda g: parse_wkt(
    f"POLYGON (({g.bbox[0]:.10g} {g.bbox[1]:.10g}, "
    f"{g.bbox[2]:.10g} {g.bbox[1]:.10g}, "
    f"{g.bbox[2]:.10g} {g.bbox[3]:.10g}, "
    f"{g.bbox[0]:.10g} {g.bbox[3]:.10g}, "
    f"{g.bbox[0]:.10g} {g.bbox[1]:.10g}))") if g.rings
    else Geom("polygon", []), _fmt_geom)

# two-geometry scalar functions
_PRED2 = {"st_intersects": geom_intersects,
          "st_disjoint": lambda g, h: not geom_intersects(g, h),
          "st_contains": geom_contains_geom,
          "st_covers": geom_contains_geom,
          "st_within": lambda g, h: geom_contains_geom(h, g),
          "st_coveredby": lambda g, h: geom_contains_geom(h, g),
          "st_equals": geom_equals,
          "st_touches": geom_touches,
          "st_crosses": geom_crosses,
          "st_overlaps": geom_overlaps}
_BOOL2 = dict(_PRED2)
_GEOM2 = {"st_intersection": lambda g, h: geom_boolean("intersection", g, h),
          "st_union": lambda g, h: geom_boolean("union", g, h),
          "st_difference": lambda g, h: geom_boolean("difference", g, h),
          "st_symdifference":
          lambda g, h: geom_boolean("symdifference", g, h)}

for _n, _f in list(_PRED2.items()):
    _SCALAR_GEOM_FUNCS[_n] = (lambda f: lambda *a: bool(
        f(parse_wkt(str(a[0])), parse_wkt(str(a[1])))))(_f)
for _n, _f in list(_GEOM2.items()):
    _SCALAR_GEOM_FUNCS[_n] = (lambda f: lambda *a: _with_srid(
        f(parse_wkt(str(a[0])), parse_wkt(str(a[1])))))(_f)
_SCALAR_GEOM_FUNCS["st_distance"] = \
    lambda *a: geom_distance(parse_wkt(str(a[0])), parse_wkt(str(a[1])))
_SCALAR_GEOM_FUNCS["st_relate"] = \
    lambda *a: geom_relate(parse_wkt(str(a[0])), parse_wkt(str(a[1])))
_SCALAR_GEOM_FUNCS["st_dwithin"] = \
    lambda *a: geom_distance(parse_wkt(str(a[0])),
                             parse_wkt(str(a[1]))) <= float(a[2])
_SCALAR_GEOM_FUNCS["st_makeenvelope"] = \
    lambda x0, y0, x1, y1, srid=0: _with_srid(Geom("polygon", [np.array(
        [[float(x0), float(y0)], [float(x1), float(y0)],
         [float(x1), float(y1)], [float(x0), float(y1)]])],
        srid=int(srid)))
_SCALAR_GEOM_FUNCS["st_makeline"] = \
    lambda *a: format_wkt(Geom("linestring", [np.array(
        [parse_wkt(str(x)).rings[0][0] for x in a])]))
_SCALAR_GEOM_FUNCS["st_collect"] = \
    lambda *a: format_wkt(Geom("collection", [],
                               subs=[parse_wkt(str(x)) for x in a]))


def _map_geom_bool(col: Column, fn) -> Column:
    geoms = _dict_geoms(col)
    lut = np.array([False if g is None else bool(fn(g)) for g in geoms]
                   + [False])
    return _bool_col(_lut_gather(lut, col.data), col.count)


def _map_geom_i32(col: Column, fn) -> Column:
    geoms = _dict_geoms(col)
    lut = np.array([-2**31 if g is None else fn(g) for g in geoms]
                   + [-2**31], dtype=np.int32)
    return Column(I32, _lut_gather(lut, col.data), col.count)


def _col_is_points(col: Column) -> bool:
    return all(g is not None and g.kind == "point"
               for g in _dict_geoms(col))


_F64_FUNCS = {"st_area", "st_length", "st_perimeter", "st_x", "st_y",
              "st_xmin", "st_ymin", "st_xmax", "st_ymax", "st_distance"}
_I32_FUNCS = {"st_numpoints", "st_npoints", "st_srid", "st_dimension",
              "st_coorddim", "st_numgeometries", "st_numinteriorrings"}
_BOOL_FUNCS = set(_BOOL2) | {"st_isvalid", "st_issimple", "st_isempty",
                             "st_isclosed", "st_isring", "st_dwithin"}


def column_geom_fn(name: str, col: Column, *rest):
    """Generic per-distinct column evaluation of any registered geometry
    function (the geomBulk.c bulk-variant role: evaluate once per
    distinct dictionary value, broadcast by device gather)."""
    fn = _SCALAR_GEOM_FUNCS.get(name)
    if fn is None:
        return None
    from .strfuncs import map_dict
    if name in _BOOL_FUNCS:
        return _map_geom_bool(col, lambda g: bool(fn(_with_srid(g), *rest)))
    if name in _I32_FUNCS:
        return _map_geom_i32(
            col, lambda g: (lambda v: -2**31 if v is None else int(v))(
                fn(_with_srid(g), *rest)))
    if name in _F64_FUNCS:
        return _map_geom_f64(
            col, lambda g: (lambda v: np.nan if v is None else float(v))(
                fn(_with_srid(g), *rest)))
    def _safe(v):
        try:
            return fn(str(v), *rest)
        except Exception:
            return None
    return map_dict(col, _safe)


def geom_scalar(name: str, *args):
    """Scalar (constant-argument) geometry evaluation for SELECT items
    over literals; returns a python value."""
    if name in ("st_makepoint", "st_point"):
        return f"POINT ({float(args[0]):.10g} {float(args[1]):.10g})"
    fn = _SCALAR_GEOM_FUNCS.get(name)
    if fn is None:
        raise ValueError(f"unsupported scalar geometry function {name}")
    return fn(*args)
