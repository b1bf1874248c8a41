"""Entry points of the port: the flagship fragment with example arguments,
and a dry run of the whole sharded path on tiny shapes - the counterpart of
the reference's ``__graft_entry__.py``, without its tunnel and
``XLA_FLAGS`` workarounds (a torch mesh needs no virtual devices: a row
mesh's devices may repeat).

    python -m monetdb_tpu_torch.harness      # both, on cuda:0

``entry(device)`` returns ``(fn, args)``: TPC-H Q1's filter and grouped
aggregation (``bench.kernels.q1_step``) and its example columns on
``device``.  ``dryrun_multichip(n, device)`` runs, on ``row_mesh([device] *
n)``: the 22 TPC-H queries at SF0.002 through ``Session(db, mesh=...)``
against a one-device ``Engine`` at the reference dry run's thresholds (the
mesh must run at least 20 of them and shuffle a join and a group-by or
distinct), Q6 again with ``assert_props``, ``sharded_q1`` and
``sharded_q6`` against their one-device steps, and ``lane_counts`` ->
``dist_group_sum`` and ``dist_fk_join`` against numpy.  Every check
raises AssertionError.  The device is the card unless the caller names
another (the tests pass ``"cpu"``).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

__all__ = ["entry", "dryrun_multichip"]

#: the reference dry run's scaled thresholds (__graft_entry__.py:105-107):
#: tiny tables take the shard / shuffle / broadcast decisions large ones do
DRYRUN_CONFIG = {"spmd_min_shard_rows": 64, "spmd_broadcast_rows": 4096,
                 "spmd_shuffle_min_rows": 64}


def _example_args(n=4096, domain=8):
    """The reference's example columns (numpy, seed 0)."""
    rng = np.random.default_rng(0)
    code = rng.integers(0, domain, n).astype(np.int32)
    shipdate = rng.integers(8000, 10600, n).astype(np.int32)
    qty = rng.integers(100, 5100, n).astype(np.int64)
    extp = rng.integers(10_000, 10_000_000, n).astype(np.int64)
    disc = rng.integers(0, 11, n).astype(np.int64)
    tax = rng.integers(0, 9, n).astype(np.int64)
    cutoff = np.int32(10_471)
    return (code, shipdate, qty, extp, disc, tax, cutoff)


def _device(device) -> torch.device:
    return torch.device("cuda", 0) if device is None else torch.device(device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def entry(device=None):
    """(fn, args): Q1's fused step and its example arguments as tensors on
    ``device`` (default ``cuda:0``)."""
    from .bench.kernels import q1_step
    dev = _device(device)

    def fn(code, shipdate, qty, extp, disc, tax, cutoff):
        return q1_step(code, shipdate, qty, extp, disc, tax, cutoff,
                       domain=8)

    return fn, tuple(torch.as_tensor(a, device=dev) for a in _example_args())


def _rows_match(a, b, tag, ordered=False):
    """Exact row comparison.  ``ordered`` (queries with ORDER BY) compares
    rows in order; unordered queries sort both sides first.  Decimals,
    ints and strings compare exactly; only floats get an epsilon."""
    assert len(a) == len(b), f"{tag}: row count diverged"
    if not ordered:
        a = sorted(a, key=lambda r: str(r))
        b = sorted(b, key=lambda r: str(r))
    for i, (ra, rb) in enumerate(zip(a, b)):
        for x, y in zip(ra, rb):
            if isinstance(x, float) and isinstance(y, float):
                assert abs(x - y) <= 1e-9 * max(1.0, abs(x)), \
                    f"{tag} row {i}: {x!r} != {y!r}"
            else:
                assert x == y, f"{tag} row {i}: {x!r} != {y!r}"


def _dryrun_sql(mesh, dev) -> dict:
    """The 22 TPC-H queries through Session(db, mesh) against one device;
    returns the fragment STATS deltas."""
    from . import config
    from .bench.tpch_gen import gen_tpch
    from .bench.tpch_load import load_tables, load_tpch_db
    from .bench.tpch_queries import QUERIES
    from .engine import Engine
    from .exec.fragment import STATS
    from .session import Session

    for k, v in DRYRUN_CONFIG.items():
        config.set(k, v)
    try:
        data = gen_tpch(0.002)
        e1 = Engine(load_tables(data, device=dev))  # single-device oracle
        sess = Session(load_tpch_db(data=data, device=dev), mesh=mesh)
        s0 = dict(STATS)
        for q in sorted(QUERIES):
            _rows_match(list(e1.query(QUERIES[q]).rows),
                        list(sess.sql(QUERIES[q]).rows), f"q{q}",
                        ordered="order by" in QUERIES[q].lower())
        d = {k: STATS[k] - s0[k] for k in STATS}
        assert d["spmd_runs"] >= 20, \
            f"SQL ran on the mesh only {d['spmd_runs']}/22 times"
        assert d["shuffle_joins"] > 0, \
            "no SQL join hash-repartitioned through the all-to-all shuffle"
        assert d["shuffle_groupbys"] + d["shuffle_distincts"] > 0, \
            "no SQL group-by/distinct repartitioned through the shuffle"
        # every shard's outputs compared (obs/assertprops.py)
        config.set("assert_props", True)
        try:
            _rows_match(list(e1.query(QUERIES[6]).rows),
                        list(sess.sql(QUERIES[6]).rows), "q6+assert_props")
        finally:
            config.reset("assert_props")
    finally:
        for k in DRYRUN_CONFIG:
            config.reset(k)
    return d


def _dryrun_steps(mesh, dev, n_devices: int) -> None:
    """sharded_q1 / sharded_q6 against their one-device steps."""
    from .bench.kernels import q1_step, q6_step
    from .parallel import shard_array, sharded_q1, sharded_q6

    n = 128 * n_devices
    code, shipdate, qty, extp, disc, tax, cutoff = _example_args(n)
    cols = (code, shipdate, qty, extp, disc, tax)
    got = sharded_q1(mesh, domain=8)(
        *[shard_array(a, mesh, fill=-1 if i == 0 else 0)
          for i, a in enumerate(cols)], cutoff)
    want = q1_step(*[torch.as_tensor(a, device=dev) for a in cols],
                   int(cutoff), domain=8)
    assert all(torch.equal(g, w) for g, w in zip(got, want)), "sharded_q1"
    q6_args = (shipdate, disc, qty, extp.astype(np.int32))
    scal = (8766, 9131, 5, 7, 2400)
    r = sharded_q6(mesh)(shard_array(shipdate, mesh),
                         shard_array(disc, mesh, fill=-1),
                         shard_array(qty, mesh, fill=1 << 40),
                         shard_array(q6_args[3], mesh), *scal)
    w = q6_step(*[torch.as_tensor(a, device=dev) for a in q6_args], *scal)
    assert int(r) == int(w), f"sharded_q6 {int(r)} != {int(w)}"
    _sync(dev)


def _dryrun_shuffles(mesh, n_devices: int) -> None:
    """lane_counts -> dist_group_sum and dist_fk_join against numpy."""
    from .parallel import shard_array
    from .parallel.shuffle import dist_fk_join, dist_group_sum, lane_counts

    n = 128 * n_devices
    _c, _s, qty, extp, _d, _t, _cut = _example_args(n)
    keys = qty % 11
    k = shard_array(keys, mesh, fill=0)
    v = shard_array(extp, mesh, fill=0)
    live = shard_array(np.ones(n, bool), mesh, fill=False)
    # counts pass -> exact lane capacity
    cap = int(lane_counts(mesh, k, live).max()) + 1
    ko, so, gl = dist_group_sum(mesh, k, v, live, lane_cap=cap)
    gl = gl.cpu().numpy()
    got = dict(zip(ko.cpu().numpy()[gl].tolist(),
                   so.cpu().numpy()[gl].tolist()))
    want = {int(g): int(extp[keys == g].sum()) for g in np.unique(keys)}
    assert got == want, "dist_group_sum != numpy"

    rkeys = np.arange(n, dtype=np.int64) % 11
    rk = shard_array(rkeys, mesh, fill=0)
    rv = shard_array(rkeys * 100, mesh, fill=0)
    rlive = shard_array(np.ones(n, bool), mesh, fill=False)
    rcap = int(lane_counts(mesh, rk, rlive).max()) + 1
    ok, (olv, orv), hit = dist_fk_join(mesh, k, [v], live, rk, [rv], rlive,
                                       lane_cap=max(cap, rcap))
    h = hit.cpu().numpy()
    # the build side repeats each key: a hit carries that key's payload
    assert h.sum() == n, "dist_fk_join lost probe rows"
    assert np.array_equal(orv.cpu().numpy()[h], ok.cpu().numpy()[h] * 100)
    assert sorted(olv.cpu().numpy()[h].tolist()) == sorted(extp.tolist())


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """The whole sharded path on ``row_mesh([device] * n_devices)``
    (default ``cuda:0``); returns the fragment STATS deltas of its SQL."""
    from .parallel import row_mesh
    dev = _device(device)
    mesh = row_mesh([dev] * n_devices)
    stats = _dryrun_sql(mesh, dev)
    _dryrun_steps(mesh, dev, n_devices)
    _dryrun_shuffles(mesh, n_devices)
    _sync(dev)
    return stats


def main() -> int:
    if not torch.cuda.is_available():
        print("harness: no CUDA device", file=sys.stderr)
        return 1
    fn, args = entry()
    out = fn(*args)
    _sync(args[0].device)
    print("entry ok:", [o.cpu().numpy()[:2] for o in out][:2])
    stats = dryrun_multichip(8)
    print(f"dryrun_multichip(8) ok: spmd_runs {stats['spmd_runs']}, "
          f"shuffle joins {stats['shuffle_joins']}, group-bys "
          f"{stats['shuffle_groupbys']}, distincts "
          f"{stats['shuffle_distincts']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
