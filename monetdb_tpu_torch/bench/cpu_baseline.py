"""Measured CPU SQL-engine baseline for TPC-H (BASELINE.md protocol step 1),
the port's copy of the JAX package's module over the port's generator.

The intended baseline is MonetDB itself built from its sources, timed via
its TRACE profiler (mal_profiler.c:674); that build needs bison for
sql/server/sql_parser.y (cmake/monetdb-findpackages.cmake:14).  The
measurable stand-in is stdlib sqlite3 — a real, single-threaded CPU SQL
engine — running the same 22 queries hand-lowered to the same physical
domains (tests/tpch_sqlite_oracle.py, which imports neither JAX nor either
package) over the same generated data (``bench.tpch_gen``, the JAX
package's generator copied).  Numbers are sqlite's CPU times, recorded
under a marker that names the engine actually measured — never MonetDB's,
and never a figure of a GPU.

Usage:  python -m monetdb_tpu_torch.bench.cpu_baseline [SF]
Prints per-query cold/warm ms to stderr, a BASELINE.md table to stdout.
"""

from __future__ import annotations

import os
import sqlite3
import sys
import threading
import time

from .tpch_gen import gen_tpch

#: seconds a query may run before sqlite is interrupted and it is left out
CAP_S = 300.0
#: warm repetitions a query (the median is reported)
WARM = 3
#: key indexes (the analog of MonetDB's hash indexes, gdk_hash.c)
INDEXES = (
    "create index idx_l_ok on lineitem(l_orderkey)",
    "create index idx_l_pk on lineitem(l_partkey, l_suppkey)",
    "create index idx_l_sk on lineitem(l_suppkey)",
    "create index idx_o_ok on orders(o_orderkey)",
    "create index idx_o_ck on orders(o_custkey)",
    "create index idx_c_ck on customer(c_custkey)",
    "create index idx_p_pk on part(p_partkey)",
    "create index idx_ps_pk on partsupp(ps_partkey, ps_suppkey)",
    "create index idx_ps_sk on partsupp(ps_suppkey)",
    "create index idx_s_sk on supplier(s_suppkey)",
    "create index idx_n_nk on nation(n_nationkey)",
    "create index idx_r_rk on region(r_regionkey)",
)


def main() -> None:
    sf = float(sys.argv[1]) if len(sys.argv) > 1 else 1.0
    repo = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, os.path.join(repo, "tests"))
    from tpch_sqlite_oracle import ORACLE, load_sqlite

    t0 = time.perf_counter()
    data = gen_tpch(sf)
    print(f"gen sf{sf}: {time.perf_counter()-t0:.1f}s", file=sys.stderr)

    t0 = time.perf_counter()
    con = load_sqlite(data)
    print(f"sqlite load: {time.perf_counter()-t0:.1f}s", file=sys.stderr)
    # the analytical setup a tuned CPU run would use: key indexes, stats
    # and a big page cache
    con.execute("pragma cache_size = -2000000")  # 2 GB page cache
    t0 = time.perf_counter()
    for ddl in INDEXES:
        con.execute(ddl)
    con.execute("analyze")
    print(f"index+analyze: {time.perf_counter()-t0:.1f}s", file=sys.stderr)

    def run_capped(sql: str):
        """Run one query; abort via sqlite interrupt after CAP_S."""
        timer = threading.Timer(CAP_S, con.interrupt)
        timer.start()
        try:
            t0 = time.perf_counter()
            con.execute(sql).fetchall()
            return (time.perf_counter() - t0) * 1e3
        except sqlite3.OperationalError:
            return None
        finally:
            timer.cancel()

    warm_ms = {}
    for qn in sorted(ORACLE):
        sql = ORACLE[qn]
        cold = run_capped(sql)
        if cold is None:
            print(f"q{qn:02d}: TIMEOUT (>{CAP_S:.0f}s), excluded",
                  file=sys.stderr)
            continue
        reps = [t for t in (run_capped(sql) for _ in range(WARM))
                if t is not None]
        warm_ms[qn] = round(sorted(reps)[len(reps) // 2], 1) if reps \
            else round(cold, 1)
        print(f"q{qn:02d}: cold={cold:9.1f}ms warm={warm_ms[qn]:9.1f}ms",
              file=sys.stderr)

    marker = "cpu-sf1-measured" if sf == 1.0 else f"cpu-sf{sf}-measured"
    print(f"<!-- {marker} engine=sqlite-{sqlite3.sqlite_version} -->")
    print("| query | warm ms |")
    print("|---|---|")
    for qn in sorted(warm_ms):
        print(f"| q{qn} | {warm_ms[qn]} |")


if __name__ == "__main__":
    main()
