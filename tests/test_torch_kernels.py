"""The kernels of the PyTorch port (monetdb_tpu_torch/ops/cuda_kernels.py:
seg_sum64, q1_grouped_sums, grouped_sum_limbs) against the reference Pallas
kernels (monetdb_tpu/ops/pallas_kernels.py, run in interpret mode on the
CPU as test_pallas_kernels.py runs them) and a numpy oracle.  Every check
is exact equality: both sides compute exact int64 sums.  join_probe, which
replaces no Pallas kernel, against a row-by-row numpy oracle, bit for bit.

The CPU tests exercise the plain PyTorch versions, which the wrappers take
for CPU tensors.  The CUDA kernels themselves are held against those plain
versions on a GPU by tests/test_torch_cuda.py and chip_smoke.py.
"""

import functools

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from monetdb_tpu.ops import pallas_kernels as PK
from monetdb_tpu_torch.ops import cuda_kernels as CK


def _pallas(sid, vals, domain):
    s, c = PK.seg_sum64(jnp.asarray(sid), jnp.asarray(vals), domain=domain,
                        interpret=True)
    return np.asarray(s), np.asarray(c)


def _port(sid, vals, domain):
    s, c = CK.seg_sum64(torch.from_numpy(sid), torch.from_numpy(vals),
                        domain=domain)
    return s.numpy(), c.numpy()


def _oracle(sid, vals, domain):
    sums = np.zeros(domain, np.int64)
    cnts = np.zeros(domain, np.int64)
    for g in range(domain):
        m = sid == g
        sums[g] = vals[m].sum()
        cnts[g] = m.sum()
    return sums, cnts


@pytest.mark.parametrize("sid_dtype", [np.int32, np.int64])
def test_seg_sum64_exact_negatives_and_excluded(sid_dtype):
    """Negative values, values beyond int32 and excluded rows (sid ==
    domain), as tests/test_pallas_kernels.py:66 checks the reference."""
    n = PK.SEG_SUM_BLOCK * 2
    domain = 5
    rng = np.random.default_rng(11)
    sid = rng.integers(0, domain + 1, n).astype(sid_dtype)
    vals = rng.integers(-(2 ** 45), 2 ** 45, n).astype(np.int64)
    ps, pc = _pallas(sid, vals, domain)
    ts, tc = _port(sid, vals, domain)
    assert np.array_equal(ts, ps) and np.array_equal(tc, pc)
    os_, oc = _oracle(sid, vals, domain)
    assert np.array_equal(ts, os_) and np.array_equal(tc, oc)


def test_seg_sum64_matches_onehot_segreduce():
    """Agreement with the one-hot form the kernel replaces under
    _SegReduce.sum (tests/test_pallas_kernels.py:82)."""
    n = PK.SEG_SUM_BLOCK
    domain = 8
    rng = np.random.default_rng(12)
    sid = rng.integers(0, domain + 1, n).astype(np.int64)
    vals = np.where(sid < domain, rng.integers(0, 10 ** 12, n), 0)
    oh = sid[:, None] == np.arange(domain)[None, :]
    want = np.where(oh, vals[:, None], 0).sum(axis=0)
    ts, _ = _port(sid, vals, domain)
    ps, _ = _pallas(sid, vals, domain)
    assert np.array_equal(ts, want) and np.array_equal(ts, ps)


# interpret-mode Pallas unrolls a loop over the domain: above 12 slots it
# takes many seconds, so the wider domains are held against numpy
@pytest.mark.parametrize("domain,ref", [(1, _pallas), (12, _pallas),
                                        (32, _oracle), (128, _oracle)])
def test_seg_sum64_domains(domain, ref):
    """The domains the engine gives the kernel (Q6: 1, Q1: 12, up to the
    one-hot bound 128), with sids outside [0, domain) on both sides."""
    n = PK.SEG_SUM_BLOCK
    rng = np.random.default_rng(domain)
    sid = rng.integers(-2, domain + 3, n).astype(np.int64)
    vals = rng.integers(-(2 ** 40), 2 ** 40, n).astype(np.int64)
    rs, rc = ref(sid, vals, domain)
    ts, tc = _port(sid, vals, domain)
    assert np.array_equal(ts, rs) and np.array_equal(tc, rc)


@pytest.mark.parametrize("n", [0, 1, 6001, 16384 * 3 + 77])
def test_seg_sum64_ragged_vs_numpy(n):
    """Any length: the port takes ragged tails the TPU kernel cannot."""
    domain = 12
    rng = np.random.default_rng(n)
    sid = rng.integers(0, domain + 1, n).astype(np.int32)
    vals = rng.integers(-(2 ** 45), 2 ** 45, n).astype(np.int64)
    ts, tc = _port(sid, vals, domain)
    os_, oc = _oracle(sid, vals, domain)
    assert np.array_equal(ts, os_) and np.array_equal(tc, oc)


def test_seg_sum64_wraps_mod_2_64():
    """Sums past int64 wrap modulo 2^64 on both sides (the TPU kernel's
    limb recombination wraps the same way)."""
    n = PK.SEG_SUM_BLOCK
    sid = np.zeros(n, np.int64)
    vals = np.full(n, 2 ** 62 + 3, np.int64)
    ps, _ = _pallas(sid, vals, 1)
    ts, _ = _port(sid, vals, 1)
    assert np.array_equal(ts, ps)
    want = ((2 ** 62 + 3) * n + 2 ** 63) % 2 ** 64 - 2 ** 63
    assert int(ts[0]) == want != 0


def test_seg_sum64_cpu_takes_plain_version():
    """On CPU tensors the wrapper is the plain version and launches
    nothing; a tensor on any other non-CUDA device is refused."""
    before = dict(CK.LAUNCHES)
    sid = torch.tensor([0, 1, 2, 1])
    vals = torch.tensor([5, -7, 9, 11], dtype=torch.int32)
    s, c = CK.seg_sum64(sid, vals, domain=2)
    assert s.tolist() == [5, 4] and c.tolist() == [1, 2]
    assert CK.LAUNCHES == before
    with pytest.raises(ValueError):
        CK.seg_sum64(sid.to("meta"), vals.to("meta"), domain=2)


# ---------------------------------------------------------------------------
# q1_grouped_sums and grouped_sum_limbs
# ---------------------------------------------------------------------------


@pytest.fixture
def pallas_interpret(monkeypatch):
    """These two reference kernels have no ``interpret`` argument: patch
    ``pl.pallas_call`` as tests/test_pallas_kernels.py does."""
    from jax.experimental import pallas as pl
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(orig, interpret=True))
    monkeypatch.setattr(PK.pl, "pallas_call",
                        functools.partial(orig, interpret=True))


def _q1_inputs(n, seed, ncodes=6):
    """Six int32 columns in the ranges of the reference's tests; about a
    hundredth of the rows carry code -1, the cutoff excludes some."""
    rng = np.random.default_rng(seed)
    code = rng.integers(0, ncodes, n).astype(np.int32)
    code[rng.random(n) < 0.01] = -1
    ship = rng.integers(8035, 10561, n).astype(np.int32)
    qty = rng.integers(100, 5100, n).astype(np.int32)
    extp = (qty.astype(np.int64) * rng.integers(90, 2000, n)).astype(np.int32)
    disc = rng.integers(0, 11, n).astype(np.int32)
    tax = rng.integers(0, 9, n).astype(np.int32)
    return (code, ship, qty, extp, disc, tax), 10471


def _q1_port(cols, cutoff, domain):
    out = CK.q1_grouped_sums(*[torch.from_numpy(a) for a in cols], cutoff,
                             domain=domain)
    return [o.numpy() for o in out]


def _q1_oracle(cols, cutoff, domain):
    """Python-int sums per group."""
    code, ship, qty, extp, disc, tax = cols
    m = (ship <= cutoff) & (code >= 0)
    dp = extp.astype(object) * (100 - disc.astype(object))
    ch = dp * (100 + tax.astype(object))
    out = [[] for _ in range(6)]
    for g in range(domain):
        mg = m & (code == g)
        for j, v in enumerate((qty, extp, dp, ch, disc)):
            out[j].append(int(v[mg].astype(object).sum()))
        out[5].append(int(mg.sum()))
    return out


def _gsl_port(code, vals, mask, domain):
    s, c = CK.grouped_sum_limbs(torch.from_numpy(code),
                                torch.from_numpy(vals),
                                torch.from_numpy(mask), domain=domain)
    return s.numpy(), c.numpy()


def _gsl_oracle(code, vals, mask, domain):
    sums, cnts = [], []
    for g in range(domain):
        mg = mask & (code == g)
        sums.append(int(vals[mg].astype(object).sum()))
        cnts.append(int(mg.sum()))
    return sums, cnts


def test_q1_grouped_sums_matches_pallas(pallas_interpret):
    """The reference kernel's own test shape (3 blocks, domain 8, padding
    rows with code -1): all six outputs equal, and equal to python ints."""
    cols, cutoff = _q1_inputs(PK._BLOCK * 3, 7)
    ref = PK.q1_grouped_sums(*[jnp.asarray(a) for a in cols],
                             np.int32(cutoff), domain=8)
    got = _q1_port(cols, cutoff, 8)
    assert len(got) == 6
    for g, r in zip(got, ref):
        assert g.dtype == np.int64 and np.array_equal(g, np.asarray(r))
    assert [g.tolist() for g in got] == _q1_oracle(cols, cutoff, 8)


@pytest.mark.parametrize("n,domain,ncodes", [
    (0, 8, 6), (1, 8, 6), (6001, 8, 6), (16384 * 2 + 77, 8, 6),
    (5000, 1, 3), (5000, 13, 15)])
def test_q1_grouped_sums_ragged_and_domains_vs_numpy(n, domain, ncodes):
    """Any length (the TPU kernel needs n % 16384 == 0), domains 1 and 13,
    codes at and beyond the domain excluded."""
    cols, cutoff = _q1_inputs(n, n + domain, ncodes)
    got = _q1_port(cols, cutoff, domain)
    assert [g.tolist() for g in got] == _q1_oracle(cols, cutoff, domain)


def test_q1_grouped_sums_all_rows_masked():
    cols, _ = _q1_inputs(4096, 3)
    got = _q1_port(cols, 0, 8)             # cutoff before every shipdate
    assert all(g.tolist() == [0] * 8 for g in got)
    cols = (np.full(4096, -1, np.int32),) + cols[1:]
    got = _q1_port(cols, 10471, 8)         # every row is padding
    assert all(g.tolist() == [0] * 8 for g in got)


def test_q1_grouped_sums_exact_beyond_int32_products():
    """disc_price beyond 2^31 (outside the TPU kernel's range notes): the
    port forms 64-bit products and stays exact."""
    n = 1000
    cols = (np.zeros(n, np.int32), np.zeros(n, np.int32),
            np.full(n, 5000, np.int32), np.full(n, 2_000_000_000, np.int32),
            np.zeros(n, np.int32), np.full(n, 8, np.int32))
    got = _q1_port(cols, 0, 8)
    assert int(got[2][0]) == 2_000_000_000 * 100 * n
    assert int(got[3][0]) == 2_000_000_000 * 100 * 108 * n


def test_grouped_sum_limbs_matches_pallas(pallas_interpret):
    """The reference kernel's own test shape (2 blocks, domain 13)."""
    n = PK._BLOCK * 2
    rng = np.random.default_rng(3)
    code = rng.integers(0, 13, n).astype(np.int32)
    vals = rng.integers(0, 2 ** 30, n).astype(np.int32)
    mask = rng.random(n) < 0.7
    rs, rc = PK.grouped_sum_limbs(jnp.asarray(code), jnp.asarray(vals),
                                  jnp.asarray(mask), domain=13)
    ts, tc = _gsl_port(code, vals, mask, 13)
    assert ts.dtype == tc.dtype == np.int64
    assert np.array_equal(ts, np.asarray(rs))
    assert np.array_equal(tc, np.asarray(rc))
    assert (ts.tolist(), tc.tolist()) == _gsl_oracle(code, vals, mask, 13)


@pytest.mark.parametrize("n,domain", [(0, 13), (1, 13), (6001, 13),
                                      (16384 + 77, 13), (5000, 1)])
def test_grouped_sum_limbs_ragged_and_domains_vs_numpy(n, domain):
    """Any length, domains 1 and 13, codes outside [0, domain) excluded."""
    rng = np.random.default_rng(n + domain)
    code = rng.integers(-1, domain + 2, n).astype(np.int32)
    vals = rng.integers(0, 2 ** 31 - 1, n).astype(np.int32)
    mask = rng.random(n) < 0.6
    ts, tc = _gsl_port(code, vals, mask, domain)
    assert (ts.tolist(), tc.tolist()) == _gsl_oracle(code, vals, mask,
                                                     domain)


def test_grouped_sum_limbs_all_rows_masked():
    rng = np.random.default_rng(9)
    code = rng.integers(0, 13, 4096).astype(np.int32)
    vals = rng.integers(0, 2 ** 30, 4096).astype(np.int32)
    ts, tc = _gsl_port(code, vals, np.zeros(4096, bool), 13)
    assert ts.tolist() == [0] * 13 and tc.tolist() == [0] * 13


def test_fused_kernels_cpu_take_plain_version():
    """On CPU tensors both wrappers are their plain versions and launch
    nothing; tensors on another non-CUDA device are refused."""
    before = dict(CK.LAUNCHES)
    cols, cutoff = _q1_inputs(64, 1)
    t = [torch.from_numpy(a) for a in cols]
    got = CK.q1_grouped_sums(*t, cutoff)
    want = CK.q1_grouped_sums_plain(*t, cutoff)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    mask = t[1] <= cutoff
    got = CK.grouped_sum_limbs(t[0], t[3], mask, domain=8)
    want = CK.grouped_sum_limbs_plain(t[0], t[3], mask, domain=8)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert CK.LAUNCHES == before
    with pytest.raises(ValueError):
        CK.q1_grouped_sums(*[x.to("meta") for x in t], cutoff)
    with pytest.raises(ValueError):
        CK.grouped_sum_limbs(t[0].to("meta"), t[3].to("meta"),
                             mask.to("meta"), domain=8)


# ---------------------------------------------------------------------------
# join_probe: the dense equi-join's probe side
# ---------------------------------------------------------------------------

_PROBE_KEY_DTYPES = {"int8": np.int8, "int16": np.int16, "int32": np.int32,
                     "int64": np.int64, "str": np.int32}
_COL_DTYPES = [np.int8, np.int16, np.int32, np.int64, np.float32,
               np.float64, np.bool_, np.int32, np.float64]


def _probe_inputs(key_kind, nkeys, ncols, masked, seed, cap=203, rcap=37):
    """Probe keys of one kind with nils and values on both sides of each
    key's range, a build slot table over the keys' packed domain, and
    ``ncols`` build columns of every width (NaN and bool among them)."""
    rng = np.random.default_rng(seed)
    dt = _PROBE_KEY_DTYPES[key_kind]
    is_str = key_kind == "str"
    keys, specs = [], []
    domain = 1
    for j in range(nkeys):
        lo = 0 if is_str else int(rng.integers(-5, 6))
        span = int(rng.integers(2, 7))
        k = rng.integers(lo - 2, lo + span + 2, cap).astype(dt)
        k[rng.random(cap) < 0.1] = np.iinfo(dt).min       # nils
        keys.append(k)
        specs.append((bool(j % 2 == 0 or is_str), lo, span, is_str))
        domain *= span
    slots = rng.integers(0, rcap + 1, domain).astype(np.int32)
    slots[rng.random(domain) < 0.3] = rcap                  # no build row
    count = int(rng.integers(cap // 2, cap + 1))
    mask = rng.random(cap) < 0.7 if masked else None
    cols = []
    for j in range(ncols):
        cdt = _COL_DTYPES[j % len(_COL_DTYPES)]
        if cdt == np.bool_:
            c = rng.random(rcap) < 0.5
        elif np.issubdtype(cdt, np.floating):
            c = rng.standard_normal(rcap).astype(cdt)
            c[::5] = np.nan
        else:
            c = rng.integers(-100, 100, rcap).astype(cdt)
        cols.append(c)
    return keys, specs, slots, rcap, count, mask, cols


def _probe_oracle(keys, specs, slots, rcap, count, mask, cols, want):
    """Row by row: liveness, each key's nil and range checks, the packed
    code's slot, the mask ``want`` asks for and the carried values."""
    cap = len(keys[0])
    matched = np.zeros(cap, bool)
    rowid = np.full(cap, -1)
    for i in range(cap):
        ok = i < count and (mask is None or mask[i])
        comb = 0
        for k, (nil, lo, span, is_str) in zip(keys, specs):
            v = int(k[i])
            if nil and not is_str and v == np.iinfo(k.dtype).min:
                ok = False
            c = v - lo
            ok = ok and 0 <= c < span
            comb = comb * span + c
        if ok and slots[comb] < rcap:
            matched[i], rowid[i] = True, slots[comb]
    out = []
    for c in cols:
        nil = False if c.dtype == np.bool_ else np.nan \
            if np.issubdtype(c.dtype, np.floating) else np.iinfo(c.dtype).min
        out.append(np.where(matched, c[np.maximum(rowid, 0)],
                            np.array(nil, c.dtype)))
    if want is None:
        return None, out
    m = {"semi": matched, "anti": ~matched, "matched": matched}[want]
    if mask is not None and want != "matched":
        m = m & mask
    return m, out


def _same_bits(got: torch.Tensor, want: np.ndarray) -> bool:
    g = got.numpy()
    if g.dtype != want.dtype:
        return False
    if g.dtype == np.bool_:
        return np.array_equal(g, want)
    return np.array_equal(g.view(f"u{g.itemsize}"),
                          want.view(f"u{want.itemsize}"))


@pytest.mark.parametrize("want", ["semi", "anti", "matched", None])
@pytest.mark.parametrize("nkeys", [1, 2, 3])
@pytest.mark.parametrize("key_kind", sorted(_PROBE_KEY_DTYPES))
def test_join_probe_plain_vs_numpy(key_kind, nkeys, want):
    """join_probe_plain (the torch chain the kernel replaces) against a row
    by row oracle, bit for bit: inner joins ask for "semi" with columns,
    left joins for no mask, semi / anti joins for theirs without columns,
    a residual for the bare match; 0-9 carried columns of widths 1-8 with
    NaN nils; a mask or none, and rows past the count."""
    seed = 17 * nkeys + len(key_kind) + (0 if want is None else len(want))
    ncols = seed % 10
    keys, specs, slots, rcap, count, mask, cols = _probe_inputs(
        key_kind, nkeys, ncols, seed % 2 == 0, seed)
    t = torch.from_numpy
    got_mask, got_cols = CK.join_probe_plain(
        [t(k) for k in keys], specs, t(slots), rcap,
        torch.tensor(count), None if mask is None else t(mask),
        [t(c) for c in cols], cap=len(keys[0]), want=want)
    want_mask, want_cols = _probe_oracle(keys, specs, slots, rcap, count,
                                         mask, cols, want)
    assert (got_mask is None) == (want_mask is None)
    if want_mask is not None:
        assert _same_bits(got_mask, want_mask)
    assert len(got_cols) == ncols
    assert all(_same_bits(g, w) for g, w in zip(got_cols, want_cols))


@pytest.mark.parametrize("nkeys", [5, 6])
def test_join_probe_folds_keys_past_the_kernels_limit(nkeys):
    """Keys beyond JOIN_MAX_KEYS are packed into one int64 key first; the
    packed keys give the plain version's answer (validity and code)."""
    keys, specs, slots, rcap, count, mask, cols = _probe_inputs(
        "int16", nkeys, 3, True, 40 + nkeys)
    t = torch.from_numpy
    keys = [t(k) for k in keys]
    folded, fspecs = CK._fold_keys(keys, specs)
    assert len(folded) == CK.JOIN_MAX_KEYS
    args = (t(slots), rcap, torch.tensor(count), t(mask),
            [t(c) for c in cols])
    a = CK.join_probe_plain(keys, specs, *args, cap=len(keys[0]),
                            want="anti")
    b = CK.join_probe_plain(folded, fspecs, *args, cap=len(keys[0]),
                            want="anti")
    assert torch.equal(a[0], b[0])
    assert all(torch.equal(x, y) for x, y in zip(a[1], b[1]))


def test_join_probe_cpu_takes_plain_version():
    """On CPU tensors the wrapper is the plain version and launches
    nothing; a tensor on another non-CUDA device is refused."""
    before = dict(CK.LAUNCHES)
    keys, specs, slots, rcap, count, mask, cols = _probe_inputs(
        "int32", 2, 4, True, 5)
    t = torch.from_numpy
    args = ([t(k) for k in keys], specs, t(slots), rcap, torch.tensor(count),
            t(mask), [t(c) for c in cols])
    got = CK.join_probe(*args, cap=len(keys[0]), want="semi")
    want = CK.join_probe_plain(*args, cap=len(keys[0]), want="semi")
    assert torch.equal(got[0], want[0])
    assert all(torch.equal(g, w) for g, w in zip(got[1], want[1]))
    assert CK.LAUNCHES == before
    with pytest.raises(ValueError):
        CK.join_probe([k.to("meta") for k in args[0]], specs,
                      args[2].to("meta"), rcap, args[4].to("meta"),
                      args[5].to("meta"), [], cap=len(keys[0]),
                      want="semi")


# ---------------------------------------------------------------------------
# compact_rows: the compaction barrier
# ---------------------------------------------------------------------------

_COMPACT_DTYPES = [np.bool_, np.int8, np.int16, np.int32, np.int64,
                   np.float32, np.float64]
#: case -> (cap, count (None: every row; a float: that share of cap), the
#: mask's live share (None: no mask), out_cap); 4099 and 8269 rows are no
#: multiple of the kernel's 8192-row tile
_COMPACT_CASES = {
    "no mask": (8269, 0.9, None, 8192),
    "count below cap": (4099, 0.5, 0.6, 4096),
    "no count": (4099, None, 0.3, 2048),
    "none live": (8269, 1.0, 0.0, 1024),
    "all live": (4099, None, 1.0, 8192),
    "overflow past out_cap": (8269, 0.8, 0.7, 1000),
    "out_cap above cap": (777, 0.9, 0.5, 2048),
    "empty": (0, 1.0, 0.5, 16),
}


def _compact_inputs(case, seed):
    """Columns of every dtype, NaN and the integer minimum among the live
    rows' values, a strided view and an expanded scalar among them."""
    cap, count, share, out_cap = _COMPACT_CASES[case]
    rng = np.random.default_rng(seed)
    cols = []
    for dt in _COMPACT_DTYPES:
        if dt == np.bool_:
            c = rng.random(cap) < 0.5
        elif np.issubdtype(dt, np.floating):
            c = rng.standard_normal(cap).astype(dt)
            c[rng.random(cap) < 0.1] = np.nan
        else:
            c = rng.integers(-100, 100, cap).astype(dt)
            c[rng.random(cap) < 0.1] = np.iinfo(dt).min
        cols.append(torch.from_numpy(c))
    cols.append(torch.from_numpy(rng.integers(0, 9, 2 * cap))[::2])
    cols.append(torch.tensor(7, dtype=torch.int32).expand(cap))
    count = None if count is None else torch.tensor(int(count * cap))
    mask = None if share is None else torch.from_numpy(
        rng.random(cap) < share)
    return count, mask, cols, cap, out_cap


def _compact_oracle(count, mask, cols, cap, out_cap):
    live = np.arange(cap) < (cap if count is None else int(count))
    if mask is not None:
        live &= mask.numpy()
    rows = np.flatnonzero(live)[:out_cap]
    out = []
    for c in cols:
        c = c.numpy()
        nil = False if c.dtype == np.bool_ else np.nan \
            if np.issubdtype(c.dtype, np.floating) else np.iinfo(c.dtype).min
        o = np.full(out_cap, nil, c.dtype)
        o[:len(rows)] = c[rows]
        out.append(o)
    return int(live.sum()), out


@pytest.mark.parametrize("case", sorted(_COMPACT_CASES))
def test_compact_rows_plain_vs_numpy(case):
    """compact_rows_plain (the torch chain the kernel replaces) against
    numpy, bit for bit: every column dtype, nils inside the live rows, no
    mask or no count, none and all rows live, ranks past out_cap dropped
    while nlive still counts them, ragged caps."""
    count, mask, cols, cap, out_cap = _compact_inputs(case, len(case))
    nlive, got = CK.compact_rows_plain(count, mask, cols, cap=cap,
                                       out_cap=out_cap)
    want_n, want = _compact_oracle(count, mask, cols, cap, out_cap)
    assert nlive.dtype == torch.int64 and nlive.dim() == 0
    assert int(nlive) == want_n
    if case == "overflow past out_cap":
        assert want_n > out_cap
    assert len(got) == len(cols)
    assert all(_same_bits(g, w) for g, w in zip(got, want))


def test_compact_rows_cpu_takes_plain_version():
    """On CPU tensors the wrapper is the plain version and launches
    nothing; bad types and shapes are refused on every device, and a
    tensor on another non-CUDA device is refused."""
    before = dict(CK.LAUNCHES)
    count, mask, cols, cap, out_cap = _compact_inputs("count below cap", 3)
    got = CK.compact_rows(count, mask, cols, cap=cap, out_cap=out_cap)
    want = CK.compact_rows_plain(count, mask, cols, cap=cap,
                                 out_cap=out_cap)
    assert torch.equal(got[0], want[0])
    assert all(_same_bits(g, w.numpy()) for g, w in zip(got[1], want[1]))
    assert CK.LAUNCHES == before

    def call(count=count, mask=mask, cols=cols, cap=cap):
        return CK.compact_rows(count, mask, cols, cap=cap, out_cap=out_cap)
    with pytest.raises(TypeError):
        call(cols=[cols[0].to(torch.uint8)])
    with pytest.raises(TypeError):
        call(mask=mask.to(torch.int8))
    with pytest.raises(ValueError):
        call(count=count.to(torch.int32))
    with pytest.raises(ValueError):
        call(cols=[cols[3][:-1]])               # another length
    with pytest.raises(ValueError):
        call(mask=torch.ones(2 * cap, dtype=torch.bool)[::2])
    with pytest.raises(ValueError):
        call(count=count.to("meta"), mask=mask.to("meta"),
             cols=[c.to("meta") for c in cols[:2]])


#: rows of the engine test's table: above 2^19, so that the lowering puts
#: a compaction under the group-by (capacity 2^20, first bucket 2^19)
_COMPACT_ENGINE_ROWS = (1 << 19) + 75_000


@pytest.mark.parametrize("cut", [20, 900])
def test_engine_compacts_under_the_group_by(cut, monkeypatch):
    """A filtered group-by over more than 2^19 rows is lowered with a
    compaction barrier; its answer equals numpy's, whether the live rows
    fit the first 2^19-row bucket (cut 20: ~2 %) or overflow it into the
    count-retry channel (cut 900: ~90 %), and every compaction is
    counted.  No capacity memo: the first lowering takes the first
    bucket."""
    monkeypatch.setenv("MTPU_TORCH_EXPAND_MEMO", "0")
    from monetdb_tpu_torch.engine import Engine
    from monetdb_tpu_torch.exec import fragment as TF
    import monetdb_tpu_torch as T
    rng = np.random.default_rng(cut)
    n = _COMPACT_ENGINE_ROWS
    k = rng.integers(0, 50, n).astype(np.int32)
    v = rng.integers(0, 1000, n).astype(np.int32)
    w = rng.integers(-10**9, 10**9, n).astype(np.int64)
    cat = T.Catalog()
    cat.add(T.Table.from_dict("t", {
        "k": T.Column.from_numpy(k, T.dtypes.I32, device="cpu"),
        "v": T.Column.from_numpy(v, T.dtypes.I32, device="cpu"),
        "w": T.Column.from_numpy(w, T.dtypes.I64, device="cpu")}))
    sql = (f"select k, count(*), sum(w), min(v) from t where v < {cut} "
           f"group by k order by k")
    stats0 = dict(TF.STATS)
    eng = Engine(cat)
    rows = list(eng.query(sql).rows)
    lowered = repr(eng._cached_plan(sql).fragment.rel_ir)
    m = v < cut
    want = [(g, int((k[m] == g).sum()), int(w[m][k[m] == g].sum()),
             int(v[m][k[m] == g].min())) for g in np.unique(k[m])]
    assert rows == want
    assert TF.STATS["compactions"] > stats0["compactions"]
    assert TF.STATS["compact_kernel"] == stats0["compact_kernel"]
    if cut == 900:
        # overflowed, re-lowered at the measured count: no barrier left
        assert TF.STATS["cap_retries"] > stats0["cap_retries"]
        assert "'compact'" not in lowered
    else:
        assert "'compact'" in lowered
