"""Geometry in the PyTorch port on the CPU (``monetdb_tpu_torch.ops.geom``
and the executor's ``_eval_geom``): the reference package's 19 geometry
tests (tests/test_geom.py) pointed at the port with every store on
``device="cpu"``, then the same SQL through a JAX ``Session`` and a port
``Session`` over seeded points and constant geometries of every kind.

Counts, ids and containment are compared exactly; distances, sums and
areas to rel 1e-12 (XLA may fuse a multiply-add that torch rounds twice).
"""

import math
import os

os.environ.setdefault("MTPU_TORCH_EXPAND_MEMO", "0")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import monetdb_tpu.config as ref_config  # noqa: E402
import monetdb_tpu.sql.binder as ref_binder  # noqa: E402
import monetdb_tpu_torch.sql.binder as binder  # noqa: E402
from monetdb_tpu.session import Session as RefSession  # noqa: E402
from monetdb_tpu.storage import Database as RefDatabase  # noqa: E402
from monetdb_tpu_torch.ops import geom as TG  # noqa: E402
from monetdb_tpu_torch.ops.geom import (  # noqa: E402
    GEOD_RADIUS, convex_hull, format_wkt, geom_area, geom_boolean,
    geom_buffer, geom_centroid, geom_contains_geom, geom_crosses,
    geom_distance, geom_equals, geom_intersects, geom_is_simple,
    geom_is_valid, geom_length, geom_overlaps, geom_touches, parse_wkt)
from monetdb_tpu_torch.session import Session  # noqa: E402
from monetdb_tpu_torch.storage.database import Database  # noqa: E402



@pytest.fixture(autouse=True, scope="module")
def _restore_binder_counters():
    """Leave the generated-name counters (``col<N>``) of both binders as
    this file found them: other files of the same worker compare names
    across the packages."""
    saved = binder.Binder._auto_counter, ref_binder.Binder._auto_counter
    yield
    binder.Binder._auto_counter, ref_binder.Binder._auto_counter = saved

# --- tests/test_geom.py -----------------------------------------------------

def mk():
    s = Session(Database(device="cpu"))
    s.sql("create table pts (id int, g varchar(80))")
    s.sql("""insert into pts values
        (1, 'POINT (1 1)'), (2, 'POINT (3 4)'), (3, 'POINT (10 0)'),
        (4, 'POINT (2.5 2.5)'), (5, NULL)""")
    return s


def test_wkt_roundtrip():
    for w in ["POINT (1.5 -2)", "LINESTRING (0 0, 1 1, 2 0)",
              "POLYGON ((0 0, 4 0, 4 4, 0 4, 0 0))",
              "POLYGON ((0 0, 4 0, 4 4, 0 4, 0 0), (1 1, 2 1, 2 2, 1 2, 1 1))",
              "MULTIPOLYGON (((0 0, 1 0, 1 1, 0 1, 0 0)), "
              "((5 5, 6 5, 6 6, 5 6, 5 5)))"]:
        assert format_wkt(parse_wkt(w)) == w


def test_st_xy_and_makepoint():
    s = mk()
    r = s.sql("select id, st_x(g), st_y(g) from pts where id <= 2 "
              "order by id")
    assert r.rows == [(1, 1.0, 1.0), (2, 3.0, 4.0)]
    r2 = s.sql("select st_astext(st_makepoint(7, 8)) from pts "
               "where id = 1")
    assert r2.rows == [("POINT (7 8)",)]
    # column form: build points from numeric columns
    s.sql("create table xy (x int, y int)")
    s.sql("insert into xy values (1,2),(3,4)")
    r3 = s.sql("select st_makepoint(x, y) from xy")
    assert r3.rows == [("POINT (1 2)",), ("POINT (3 4)",)]


def test_st_distance_point_point():
    s = mk()
    r = s.sql("select id, st_distance(g, 'POINT (0 0)') from pts "
              "where id <= 3 order by id")
    want = [(1, math.hypot(1, 1)), (2, 5.0), (3, 10.0)]
    for (gi, gd), (wi, wd) in zip(r.rows, want):
        assert gi == wi and abs(gd - wd) < 1e-12


def test_st_distance_point_polygon():
    s = mk()
    # unit square at origin: point (3,4) is hypot(2,3)... nearest corner
    # (1,1) → hypot(2,3); point (1,1) on corner → 0 ; inside → 0
    sq = "POLYGON ((0 0, 1 0, 1 1, 0 1, 0 0))"
    r = s.sql(f"select id, st_distance(g, '{sq}') from pts "
              "where id in (1, 2) order by id")
    assert abs(r.rows[0][1] - 0.0) < 1e-12          # (1,1) on boundary
    assert abs(r.rows[1][1] - math.hypot(2, 3)) < 1e-12


def test_st_contains_and_within():
    s = mk()
    sq = "POLYGON ((0 0, 5 0, 5 5, 0 5, 0 0))"
    r = s.sql(f"select id from pts where st_contains('{sq}', g) "
              "order by id")
    assert r.rows == [(1,), (2,), (4,)]
    r2 = s.sql(f"select id from pts where st_within(g, '{sq}') "
               "order by id")
    assert r2.rows == [(1,), (2,), (4,)]
    # polygon with a hole: (2.5, 2.5) falls in the hole
    holed = ("POLYGON ((0 0, 5 0, 5 5, 0 5, 0 0), "
             "(2 2, 3 2, 3 3, 2 3, 2 2))")
    r3 = s.sql(f"select id from pts where st_contains('{holed}', g) "
               "order by id")
    assert r3.rows == [(1,), (2,)]


def test_st_intersects_multipolygon():
    s = mk()
    mp = ("MULTIPOLYGON (((0 0, 2 0, 2 2, 0 2, 0 0)), "
          "((9 -1, 11 -1, 11 1, 9 1, 9 -1)))")
    r = s.sql(f"select id from pts where st_intersects(g, '{mp}') "
              "order by id")
    assert r.rows == [(1,), (3,)]


def test_st_dwithin():
    s = mk()
    r = s.sql("select id from pts where st_dwithin(g, 'POINT (0 0)', 5.0) "
              "order by id")
    assert r.rows == [(1,), (2,), (4,)]


def test_geodesic_distance():
    s = Session(Database(device="cpu"))
    s.sql("create table cities (name varchar(20), g varchar(60))")
    # lon lat: Amsterdam and Paris
    s.sql("""insert into cities values
        ('ams', 'POINT (4.9041 52.3676)'), ('par', 'POINT (2.3522 48.8566)')""")
    r = s.sql("select st_distance_geographic(g, 'POINT (2.3522 48.8566)') "
              "from cities where name = 'ams'")
    d = r.rows[0][0]
    # haversine reference
    la1, la2 = math.radians(52.3676), math.radians(48.8566)
    dlat, dlon = la2 - la1, math.radians(2.3522 - 4.9041)
    h = (math.sin(dlat / 2) ** 2
         + math.cos(la1) * math.cos(la2) * math.sin(dlon / 2) ** 2)
    want = 2 * GEOD_RADIUS * math.asin(math.sqrt(h))
    assert abs(d - want) < 1e-6
    assert 425_000 < d < 435_000       # ~430 km


def test_area_length_centroid_envelope():
    s = Session(Database(device="cpu"))
    s.sql("create table shapes (id int, g varchar(120))")
    s.sql("""insert into shapes values
        (1, 'POLYGON ((0 0, 4 0, 4 4, 0 4, 0 0))'),
        (2, 'POLYGON ((0 0, 4 0, 4 4, 0 4, 0 0), (1 1, 2 1, 2 2, 1 2, 1 1))'),
        (3, 'LINESTRING (0 0, 3 4, 3 10)')""")
    r = s.sql("select id, st_area(g), st_length(g) from shapes order by id")
    assert r.rows[0][1] == 16.0 and r.rows[0][2] == 16.0
    assert r.rows[1][1] == 15.0 and r.rows[1][2] == 20.0
    assert r.rows[2][1] == 0.0 and abs(r.rows[2][2] - 11.0) < 1e-12
    r2 = s.sql("select st_astext(st_centroid(g)) from shapes where id = 1")
    assert r2.rows == [("POINT (2 2)",)]
    r3 = s.sql("select st_envelope(g) from shapes where id = 3")
    assert parse_wkt(r3.rows[0][0]).bbox == (0.0, 0.0, 3.0, 10.0)
    r4 = s.sql("select st_numpoints(g) from shapes where id = 1")
    assert r4.rows == [(5,)]


def test_host_metrics_match_reference_math():
    rng = np.random.default_rng(5)
    pts = rng.random((8, 2)) * 10
    hull = pts[np.argsort(np.arctan2(pts[:, 1] - 5, pts[:, 0] - 5))]
    ring = np.vstack([hull, hull[:1]])
    w = "POLYGON ((" + ", ".join(f"{x} {y}" for x, y in ring) + "))"
    g = parse_wkt(w)
    x, y = ring[:-1, 0], ring[:-1, 1]
    want = 0.5 * abs(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))
    assert abs(geom_area(g) - want) < 1e-9
    segs = np.hypot(np.diff(ring[:, 0]), np.diff(ring[:, 1])).sum()
    assert abs(geom_length(g) - segs) < 1e-9


def test_geomfromtext_validates():
    s = mk()
    r = s.sql("select st_astext(st_geomfromtext('POINT(2    3)')) "
              "from pts where id = 1")
    assert r.rows == [("POINT (2 3)",)]
    with pytest.raises(Exception):
        s.sql("select st_geomfromtext('NOTAGEOM(1)') from pts")


# ---------------------------------------------------------------------------
# OGC breadth: the general-geometry engine (predicates, boolean ops, hull,
# buffer, transforms) — reference surface geom/monetdb5/geom.c wkbspatial
# family via libgeos; here an original boundary-classification engine.
# Oracle: analytically computed areas/relations on simple shapes.
# ---------------------------------------------------------------------------



SQ02 = "POLYGON ((0 0, 2 0, 2 2, 0 2, 0 0))"        # [0,2]^2
SQ13 = "POLYGON ((1 1, 3 1, 3 3, 1 3, 1 1))"        # [1,3]^2
SQ46 = "POLYGON ((4 4, 6 4, 6 6, 4 6, 4 4))"        # disjoint
SQIN = "POLYGON ((0.5 0.5, 1 0.5, 1 1, 0.5 1, 0.5 0.5))"  # inside SQ02


def test_wkt_new_kinds_roundtrip():
    for w in ["MULTIPOINT (1 1, 2 3)",
              "MULTILINESTRING ((0 0, 1 1), (2 2, 3 3, 4 2))",
              "GEOMETRYCOLLECTION (POINT (1 2), "
              "LINESTRING (0 0, 1 1), "
              "POLYGON ((0 0, 1 0, 1 1, 0 1, 0 0)))",
              "GEOMETRYCOLLECTION EMPTY"]:
        assert format_wkt(parse_wkt(w)) == w
    assert format_wkt(parse_wkt("MULTIPOINT ((1 1), (2 3))")) == \
        "MULTIPOINT (1 1, 2 3)"


def test_boolean_ops_squares():
    a, b = parse_wkt(SQ02), parse_wkt(SQ13)
    inter = geom_boolean("intersection", a, b)
    assert abs(geom_area(inter) - 1.0) < 1e-9          # [1,2]^2
    uni = geom_boolean("union", a, b)
    assert abs(geom_area(uni) - 7.0) < 1e-9            # 4 + 4 - 1
    diff = geom_boolean("difference", a, b)
    assert abs(geom_area(diff) - 3.0) < 1e-9
    sym = geom_boolean("symdifference", a, b)
    assert abs(geom_area(sym) - 6.0) < 1e-9


def test_boolean_ops_containment_and_disjoint():
    a, c, d = parse_wkt(SQ02), parse_wkt(SQIN), parse_wkt(SQ46)
    # fully contained: intersection = inner, union = outer
    assert abs(geom_area(geom_boolean("intersection", a, c)) - 0.25) < 1e-9
    assert abs(geom_area(geom_boolean("union", a, c)) - 4.0) < 1e-9
    # difference with a contained square = ring with a hole
    hole = geom_boolean("difference", a, c)
    assert abs(geom_area(hole) - 3.75) < 1e-9
    # disjoint
    assert geom_area(geom_boolean("intersection", a, d)) == 0.0
    assert abs(geom_area(geom_boolean("union", a, d)) - 8.0) < 1e-9


def test_predicates():
    a, b, d = parse_wkt(SQ02), parse_wkt(SQ13), parse_wkt(SQ46)
    touch = parse_wkt("POLYGON ((2 0, 4 0, 4 2, 2 2, 2 0))")  # shares edge
    line_in = parse_wkt("LINESTRING (-1 1, 3 1)")   # crosses SQ02
    line_out = parse_wkt("LINESTRING (5 0, 6 0)")
    assert geom_intersects(a, b) and not geom_intersects(a, d)
    assert geom_overlaps(a, b) and not geom_overlaps(a, d)
    assert geom_touches(a, touch) and not geom_touches(a, b)
    assert geom_crosses(line_in, a) and not geom_crosses(line_out, a)
    assert geom_contains_geom(a, parse_wkt(SQIN))
    assert not geom_contains_geom(a, b)
    assert geom_equals(a, parse_wkt(
        "POLYGON ((2 0, 2 2, 0 2, 0 0, 2 0))"))     # rotated start
    assert not geom_equals(a, b)
    assert geom_distance(a, d) == pytest.approx(math.hypot(2, 2))
    assert geom_distance(a, b) == 0.0


def test_convex_hull_and_buffer():
    g = parse_wkt("MULTIPOINT (0 0, 4 0, 4 4, 0 4, 2 2, 1 1)")
    h = convex_hull(g)
    assert abs(geom_area(h) - 16.0) < 1e-9
    # point buffer ≈ circle
    c = geom_buffer(parse_wkt("POINT (5 5)"), 2.0, quad=16)
    assert geom_area(c) == pytest.approx(math.pi * 4, rel=0.01)
    # polygon buffer grows the square by edge strips + corner arcs
    pb = geom_buffer(parse_wkt(SQ02), 1.0, quad=8)
    want = 4 + 4 * 2 * 1 + math.pi     # area + perimeter*d + corner circle
    assert geom_area(pb) == pytest.approx(want, rel=0.05)


def test_sql_geometry_breadth():
    s = Session(Database(device="cpu"))
    s.sql("create table g2 (id int, g varchar(200))")
    s.sql(f"""insert into g2 values
        (1, '{SQ02}'), (2, '{SQ46}'),
        (3, 'LINESTRING (0 0, 1 1, 2 0)'),
        (4, 'MULTIPOLYGON (((0 0, 1 0, 1 1, 0 1, 0 0)),
             ((5 5, 6 5, 6 6, 5 6, 5 5)))')""")
    r = s.sql("select id, st_geometrytype(g), st_dimension(g), "
              "st_numgeometries(g) from g2 order by id")
    assert r.rows[0][1:] == ("ST_Polygon", 2, 1)
    assert r.rows[2][1:] == ("ST_LineString", 1, 1)
    assert r.rows[3][1:] == ("ST_MultiPolygon", 2, 2)
    # 1 overlaps; 3 and 4 touch SQ13 exactly at its corner (1,1) —
    # ST_Intersects includes touching
    r = s.sql(f"select id from g2 where st_intersects(g, '{SQ13}') "
              "order by id")
    assert [x[0] for x in r.rows] == [1, 3, 4]
    r = s.sql(f"select id from g2 where st_overlaps(g, '{SQ13}') "
              "order by id")
    assert [x[0] for x in r.rows] == [1]
    r = s.sql(f"select st_area(st_intersection(g, '{SQ13}')) from g2 "
              "where id = 1")
    assert r.rows[0][0] == pytest.approx(1.0)
    r = s.sql(f"select st_area(st_union(g, '{SQ13}')) from g2 where id=1")
    assert r.rows[0][0] == pytest.approx(7.0)
    r = s.sql("select st_xmin(g), st_ymax(g) from g2 where id = 1")
    assert r.rows == [(0.0, 2.0)]
    r = s.sql("select st_astext(st_boundary(g)) from g2 where id = 1")
    assert parse_wkt(r.rows[0][0]).kind in ("linestring",
                                            "multilinestring")
    r = s.sql("select st_isclosed(g), st_isvalid(g) from g2 where id = 3")
    assert r.rows == [(False, True)]
    r = s.sql("select st_srid(st_setsrid(g, 4326)) from g2 where id = 1")
    assert r.rows == [(4326,)]
    r = s.sql("select st_astext(st_geometryn(g, 2)) from g2 where id = 4")
    assert geom_area(parse_wkt(r.rows[0][0])) == pytest.approx(1.0)
    r = s.sql("select st_astext(st_convexhull(g)) from g2 where id = 3")
    assert parse_wkt(r.rows[0][0]).kind == "polygon"
    r = s.sql(f"select st_equals(g, '{SQ02}'), st_disjoint(g, '{SQ46}'), "
              f"st_touches(g, 'POLYGON ((2 0, 4 0, 4 2, 2 2, 2 0))') "
              "from g2 where id = 1")
    assert r.rows == [(True, True, True)]   # SQ46 is disjoint from SQ02
    r = s.sql("select st_distance(g, 'POLYGON ((4 4, 6 4, 6 6, 4 6, 4 4))')"
              " from g2 where id = 1")
    assert r.rows[0][0] == pytest.approx(math.hypot(2, 2))


def test_sql_transform_and_affine():
    s = Session(Database(device="cpu"))
    s.sql("create table tg (id int, g varchar(120))")
    s.sql("insert into tg values (1, 'POINT (10 45)')")
    r = s.sql("select st_astext(st_transform(st_transform("
              "st_setsrid(g, 4326), 3857), 4326)) from tg")
    g = parse_wkt(r.rows[0][0])
    assert g.rings[0][0][0] == pytest.approx(10, abs=1e-6)
    assert g.rings[0][0][1] == pytest.approx(45, abs=1e-6)
    r = s.sql("select st_astext(st_translate(g, 1, -1)) from tg")
    assert r.rows == [("POINT (11 44)",)]
    r = s.sql("select st_astext(st_scale(g, 2, 3)) from tg")
    assert r.rows == [("POINT (20 135)",)]


def test_invalid_and_simple():
    bow = parse_wkt("POLYGON ((0 0, 2 2, 2 0, 0 2, 0 0))")   # bowtie
    assert not geom_is_valid(bow)
    assert geom_is_valid(parse_wkt(SQ02))
    assert geom_is_simple(parse_wkt("LINESTRING (0 0, 1 1, 2 0)"))
    assert not geom_is_simple(
        parse_wkt("LINESTRING (0 0, 2 2, 2 0, 0 2)"))        # self-cross


# ---------------------------------------------------------------------------
# parity with the JAX package: the same SQL through both Sessions
# ---------------------------------------------------------------------------

def _ring(cx, cy, r, n, phase=0.0):
    a = np.linspace(0, 2 * math.pi, n, endpoint=False) + phase
    pts = [(cx + r * (1 + 0.3 * math.sin(5 * t)) * math.cos(t),
            cy + r * (1 + 0.3 * math.sin(5 * t)) * math.sin(t)) for t in a]
    pts.append(pts[0])
    return "(" + ", ".join(f"{x:.6f} {y:.6f}" for x, y in pts) + ")"


#: one 64-vertex polygon with a hole, a multipolygon, a linestring, a point
POLY = f"POLYGON ({_ring(0, 0, 40, 64)}, {_ring(5, 5, 10, 12, 0.2)})"
MPOLY = (f"MULTIPOLYGON (({_ring(-60, 30, 15, 9)}), "
         f"({_ring(60, -30, 20, 11, 0.5)}))")
LINE = "LINESTRING (-80 -60, -20 10, 30 -5, 90 70)"
PT = "POINT (12.5 -7.25)"

_PARITY_ROWS = 1000


def _geo_tables(make):
    rng = np.random.default_rng(11)
    xy = rng.uniform(-100, 100, (_PARITY_ROWS, 2))
    s = make()
    s.sql("create table gp (id int, g varchar(60))")
    vals = ", ".join(f"({i}, 'POINT ({x:.6f} {y:.6f})')"
                     for i, (x, y) in enumerate(xy))
    s.sql(f"insert into gp values {vals}, ({_PARITY_ROWS}, null)")
    s.sql("create table gs (id int, g varchar(400))")
    shapes = [POLY, MPOLY, LINE, PT] + [
        f"POLYGON ({_ring(x, y, 3 + i % 7, 5 + i % 9)})"
        for i, (x, y) in enumerate(xy[:20])]
    s.sql("insert into gs values " + ", ".join(
        f"({i}, '{w}')" for i, w in enumerate(shapes)))
    return s


PARITY_SQL = [
    f"select count(*) from gp where st_contains('{POLY}', g)",
    f"select id from gp where st_contains('{POLY}', g) order by id",
    f"select id from gp where st_within(g, '{MPOLY}') order by id",
    f"select id from gp where st_intersects(g, '{MPOLY}') order by id",
    *[f"select sum(st_distance(g, '{c}')) from gp"
      for c in (POLY, MPOLY, LINE, PT)],
    f"select id, st_distance(g, '{POLY}') from gp where id < 100 "
    "order by id",
    f"select id, st_distance(g, '{LINE}') from gp where id < 100 "
    "order by id",
    f"select count(*) from gp where st_dwithin(g, '{PT}', 35.0)",
    f"select count(*) from gp where st_dwithingeographic(g, '{PT}', "
    "2500000.0)",
    f"select id, st_distance_geographic(g, '{PT}') from gp where id < 100 "
    "order by id",
    "select sum(st_x(g)), sum(st_y(g)), count(st_x(g)) from gp",
    "select id, st_area(g), st_length(g), st_numpoints(g) from gs "
    "order by id",
    "select sum(st_area(g)) from gs",
    "select id, st_astext(st_centroid(g)), st_envelope(g) from gs "
    "order by id",
    f"select id from gs where st_intersects(g, '{POLY}') order by id",
    f"select id, st_isvalid(g), st_geometrytype(g) from gs order by id",
]


def _close(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        return a == b or math.isclose(a, b, rel_tol=1e-12, abs_tol=1e-9)
    return a == b


@pytest.fixture(scope="module")
def both_sessions():
    ref_config.set("spmd_auto_mesh", False)
    try:
        yield (_geo_tables(lambda: Session(Database(device="cpu"))),
               _geo_tables(lambda: RefSession(RefDatabase())))
    finally:
        ref_config.reset("spmd_auto_mesh")


@pytest.mark.parametrize("i", range(len(PARITY_SQL)))
def test_geom_sql_matches_jax_session(both_sessions, i):
    port, ref = both_sessions
    ref_config.set("spmd_auto_mesh", False)
    binder.Binder._auto_counter = 0
    got = port.sql(PARITY_SQL[i])
    ref_binder.Binder._auto_counter = 0
    want = ref.sql(PARITY_SQL[i])
    assert got.names == want.names
    assert [str(t) for t in got.types] == [str(t) for t in want.types]
    assert len(got.rows) == len(want.rows) and got.rows, PARITY_SQL[i]
    for gr, wr in zip(got.rows, want.rows):
        assert all(_close(a, b) for a, b in zip(gr, wr)), (gr, wr)


def test_raycast_blocks_change_no_result(monkeypatch):
    """The [rows, edges] intermediates in blocks of rows give the same
    containment and distances as one block."""
    s = _geo_tables(lambda: Session(Database(device="cpu")))
    sql = (f"select id, st_distance(g, '{POLY}') from gp "
           f"where st_contains('{MPOLY}', g) or id < 100 order by id")
    whole = s.sql(sql).rows
    monkeypatch.setattr(TG, "_BLOCK_ELEMS", 1000)
    s2 = _geo_tables(lambda: Session(Database(device="cpu")))
    assert s2.sql(sql).rows == whole
