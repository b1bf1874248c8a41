"""The lowering's string-dictionary maps on the card (ops/dictmap.py): the
dictionaries' byte heaps, the routing between the device and the host
path, the two kernels' plain versions against the host's maps, and the
counters.  The tests marked ``cuda`` hold the kernels themselves
(``like_match``, ``substr_keys``) against the host's maps, and TPC-H at
SF0.1 on the card against the numpy oracle; they skip without a card.
This file imports no JAX, so on a machine with a card run

    python -m pytest tests/test_torch_dict_device.py -m cuda --noconftest -q
"""

import os

os.environ.setdefault("MTPU_TORCH_EXPAND_MEMO", "0")

import types  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from monetdb_tpu_torch.column import StrDict  # noqa: E402
from monetdb_tpu_torch.exec.fragment import STATS, _str_fn  # noqa: E402
from monetdb_tpu_torch.obs.profiler import PROFILER  # noqa: E402
from monetdb_tpu_torch.ops import cuda_kernels as CK  # noqa: E402
from monetdb_tpu_torch.ops import dictmap as DM  # noqa: E402
from monetdb_tpu_torch.ops.strfuncs import like_lut, like_program  # noqa

CUDA = torch.device("cuda")
ASCII = list("abcAB%_\\! x\n")
WIDE = ASCII + list("é日🙂")

#: (pattern, escape) pairs: wildcards, runs of %, escapes of % _ and
#: of the escape itself, a trailing escape, literal newlines, multi-byte
#: literals next to `_`
PATTERNS = [
    ("%", None), ("%%", None), ("", None), ("a", None), ("a%", None),
    ("%a", None), ("%a%", None), ("%a%b%", None), ("a%b", None),
    ("_", None), ("__", None), ("a_", None), ("_%", None), ("%_", None),
    ("%_a_%", None), ("a%%b", None), ("\\%%", "\\"), ("%\\_%", "\\"),
    ("a\\\\%", "\\"), ("ab\\", "\\"), ("!%a!_", "!"), ("%x", "!"),
    ("%\n", None), ("a\n_", None), ("%é%", None), ("_日%", None),
    ("%🙂_", None), ("AB%", None), ("%b_C%", None),
]


def _dictionary(seed: int, n: int, alphabet, longest: int) -> np.ndarray:
    """Sorted distinct strings of 0..longest characters of ``alphabet``."""
    rng = np.random.default_rng(seed)
    vals = {"".join(rng.choice(alphabet, rng.integers(0, longest + 1)))
            for _ in range(n)}
    return np.unique(np.array(sorted(vals), dtype=str))


def _like_cases(values: np.ndarray):
    ascii = "".join(values.tolist()).isascii()
    for pattern, escape in PATTERNS:
        for caseless in (False, True):
            # ILIKE takes the device path only over ASCII
            if caseless and not (ascii and pattern.isascii()):
                continue
            for negated in (False, True):
                yield pattern, escape, caseless, negated


def _check_like(values: np.ndarray, data, offsets) -> int:
    """Every pattern's device map (``like_match``, or its plain version
    for host tensors) against the host's table; returns the cases run."""
    sd = StrDict(values)
    n = 0
    for pattern, escape, caseless, negated in _like_cases(values):
        got = CK.like_match(data, offsets,
                            like_program(pattern, escape, caseless),
                            caseless=caseless,
                            dollar_nl=escape is not None or "_" in pattern,
                            negate=negated)
        want = like_lut(sd, pattern, negated, escape, caseless)
        assert got.dtype == torch.bool and len(got) == len(values)
        assert np.array_equal(got.cpu().numpy(), want), \
            (pattern, escape, caseless, negated)
        n += 1
    return n


#: (function, constant arguments) of _str_func that the device maps
SUBSTR = [("substring", [1, 2]), ("substring", [1, 5]), ("substring", [0, 3]),
          ("substring", [-2, 4]), ("substring", [3, 2]), ("substring", [2]),
          ("substring", [1, None]), ("left", [3]), ("left", [0]),
          ("left", [-1]), ("right", [2]), ("right", [0]), ("right", [9])]


def _host_remap(values: np.ndarray, name: str, args: list):
    f = _str_fn(name, args)
    mapped = np.array([f(str(v)) for v in values], dtype=object)
    uniq, codes = np.unique(mapped.astype(str), return_inverse=True)
    return codes.astype(np.int32), uniq


def _check_substr(values: np.ndarray, data, offsets) -> int:
    heap = StrDict(values).heap()
    for name, args in SUBSTR:
        start, count, right = DM.substr_spec(name, args, heap)
        keys = CK.substr_keys(data, offsets, start=start, count=count,
                              right=right)
        codes, uniq = DM.remap_keys(keys, start == 0 and not right)
        want_codes, want_uniq = _host_remap(values, name, args)
        assert codes.dtype == torch.int32, (name, args)
        assert np.array_equal(codes.cpu().numpy(), want_codes), (name, args)
        assert uniq.tolist() == want_uniq.tolist(), (name, args)
    return len(SUBSTR)


# ---------------------------------------------------------------------------
# the heap
# ---------------------------------------------------------------------------


def test_heap_layout_against_values():
    vals = np.array(["", "a", "héllo", "x\ny", "日本", "🙂", "z"], dtype=str)
    heap = StrDict(vals).heap()
    enc = [v.encode("utf-8") for v in vals.tolist()]
    assert bytes(heap.data.numpy()) == b"".join(enc)
    assert heap.data.dtype == torch.uint8 and heap.offsets.dtype == \
        torch.int32
    assert heap.offsets.tolist() == np.concatenate(
        [[0], np.cumsum([len(e) for e in enc])]).tolist()
    assert (heap.ascii, heap.nul_free, heap.fits) == (False, True, True)
    assert heap.max_len == max(map(len, enc)) == 6
    ascii = StrDict(np.array(["", "", "abc"], dtype=object)).heap()
    assert ascii.ascii and ascii.offsets.tolist() == [0, 0, 0, 3]
    assert bytes(ascii.data.numpy()) == b"abc"
    nul = StrDict(np.array(["a\0b", "c"], dtype=object)).heap()
    assert nul.ascii and not nul.nul_free
    empty = StrDict(np.empty(0, dtype=str)).heap()
    assert empty.offsets.tolist() == [0] and empty.data.numel() == 0
    assert empty.max_len == 0 and empty.nul_free


def test_heap_is_built_once_a_dictionary():
    sd = StrDict(np.array(["a", "b"], dtype=str))
    before = STATS["dict_heaps"]
    first = sd.heap()
    assert sd.heap() is first and STATS["dict_heaps"] == before + 1


def test_a_table_append_brings_a_new_dictionary_and_heap():
    from monetdb_tpu_torch.session import Session
    from monetdb_tpu_torch.storage import Database
    db = Database(device="cpu")
    s = Session(db)
    s.sql("create table t (a varchar(20), b int)")
    s.sql("insert into t values ('x', 1), ('y', 2)")
    old = db.catalog().tables["t"].columns["a"].sdict
    assert db.catalog().tables["t"].columns["a"].sdict is old
    old_heap = old.heap()
    s.sql("insert into t values ('a', 3)")
    new = db.catalog().tables["t"].columns["a"].sdict
    assert new is not old and new.heap() is not old_heap
    assert bytes(new.heap().data.numpy()) == b"axy"
    assert bytes(old_heap.data.numpy()) == b"xy"


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


def _big(n=DM.DEVICE_MIN_VALUES, suffix=""):
    return StrDict(np.array([f"v{i:07d}{suffix}" for i in range(n)],
                            dtype=str))


def test_routing_follows_device_size_pattern_and_flags():
    sd = _big()
    assert DM.like_plan(sd, "%1%", None, False, CUDA) is not None
    assert DM.like_plan(sd, "%1%", None, False, torch.device("cpu")) is None
    heap, prog, dollar_nl = DM.like_plan(sd, "v_1%", "!", True, CUDA)
    assert dollar_nl and prog.tolist() == like_program("v_1%", "!", True
                                                       ).tolist()
    assert DM.like_plan(sd, "%1%", None, False, CUDA)[2] is False
    assert DM.like_plan(sd, "%" * (CK.LIKE_MAX_OPS + 1), None, False,
                        CUDA) is None
    # ILIKE needs an all-ASCII heap and pattern
    assert DM.like_plan(sd, "%é%", None, True, CUDA) is None
    assert DM.like_plan(sd, "%é%", None, False, CUDA) is not None
    wide = _big(suffix="é")
    assert DM.like_plan(wide, "%1%", None, True, CUDA) is None
    assert DM.like_plan(wide, "%1%", None, False, CUDA) is not None
    # a NUL anywhere keeps every map on the host
    nul = StrDict(np.array([f"{i:05d}\0" for i in range(
        DM.DEVICE_MIN_VALUES)], dtype=object))
    assert DM.like_plan(nul, "%1%", None, False, CUDA) is None
    assert DM.substr_plan(nul, "left", [2], CUDA) is None
    # below the crossover the heap is never built
    small = _big(DM.DEVICE_MIN_VALUES - 1)
    before = STATS["dict_heaps"]
    assert DM.like_plan(small, "%1%", None, False, CUDA) is None
    assert DM.substr_plan(small, "left", [2], CUDA) is None
    assert STATS["dict_heaps"] == before


def test_substring_routing_fits_eight_bytes():
    sd = _big()                                       # 8 ASCII bytes
    assert DM.substr_plan(sd, "substring", [1, 2], CUDA)[1] == (0, 2, False)
    assert DM.substr_plan(sd, "substring", [3], CUDA)[1] == (2, -1, False)
    assert DM.substr_plan(sd, "left", [9], CUDA)[1] == (0, 9, False)
    assert DM.substr_plan(sd, "right", [2], CUDA)[1] == (0, 2, True)
    assert DM.substr_plan(sd, "upper", [], CUDA) is None
    assert DM.substr_plan(sd, "substring", [None, 2], CUDA) is None
    assert DM.substr_plan(sd, "substring", [1, 2],
                          torch.device("cpu")) is None
    long = _big(suffix="xy")                          # 10 ASCII bytes
    assert DM.substr_plan(long, "substring", [1], CUDA) is None
    assert DM.substr_plan(long, "substring", [3], CUDA)[1] == (2, -1, False)
    assert DM.substr_plan(long, "left", [8], CUDA) is not None
    assert DM.substr_plan(long, "left", [9], CUDA) is None
    wide = _big(suffix="é")                           # 10 bytes, 9 points
    assert DM.substr_plan(wide, "left", [2], CUDA) is not None
    assert DM.substr_plan(wide, "left", [3], CUDA) is None
    assert DM.substr_plan(wide, "right", [2], CUDA) is not None


def test_lowering_maps_on_the_host_on_the_cpu():
    from monetdb_tpu_torch.bench.tpch_load import load_tpch
    from monetdb_tpu_torch.bench.tpch_queries import QUERIES
    from monetdb_tpu_torch.engine import Engine
    eng = Engine(load_tpch(0.01, device="cpu"))
    before = dict(STATS)
    for q in (13, 22):
        assert list(eng.query(QUERIES[q]).rows)
    assert STATS["dict_values"] > before["dict_values"]
    assert STATS["dict_device_values"] == before["dict_device_values"]
    assert STATS["dict_heaps"] == before["dict_heaps"]


@pytest.mark.parametrize("q", [9, 13, 16, 20, 22])
def test_device_path_through_the_lowering_with_plain_kernels(monkeypatch,
                                                             q):
    """The device path of the lowering end to end on the CPU: routing
    told that the CPU is a card (and the crossover lowered to SF0.01's
    dictionaries), so the heaps upload to host tensors and the kernels'
    plain versions map them; rows equal the numpy oracle's and the host
    path's, and the values count as mapped on the device."""
    from monetdb_tpu_torch.bench import tpch_oracle
    from monetdb_tpu_torch.bench.tpch_gen import gen_tpch
    from monetdb_tpu_torch.bench.tpch_load import load_tables
    from monetdb_tpu_torch.bench.tpch_queries import QUERIES
    from monetdb_tpu_torch.engine import Engine
    data = gen_tpch(0.01)
    host = list(Engine(load_tables(data, device="cpu")).query(
        QUERIES[q]).rows)
    real = DM._heap
    monkeypatch.setattr(DM, "DEVICE_MIN_VALUES", 1000)
    monkeypatch.setattr(DM, "_heap", lambda sd, device: real(sd, CUDA))
    before = STATS["dict_device_values"]
    got = list(Engine(load_tables(data, device="cpu")).query(
        QUERIES[q]).rows)
    assert got == host
    want = tpch_oracle.decoded(q, tpch_oracle.ORACLES[q](data))
    assert tpch_oracle.rows_differ(got, want, 1e-12) is None
    # o_comment, p_name, c_phone have 1,500-15,000 values, s_comment 100
    assert (STATS["dict_device_values"] > before) == (q != 16)


# ---------------------------------------------------------------------------
# counters and the benchmark's reader
# ---------------------------------------------------------------------------


def test_device_values_count_as_dict_values_do():
    keys = ("dict_values", "dict_device_values")
    before = [STATS[k] for k in keys]
    with PROFILER.span("lower.dict", "dict_ns",
                       count=("dict_values", 5)) as sp:
        sp.add_count("dict_device_values", 5)
    assert [STATS[k] for k in keys] == [b + 5 for b in before]
    with PROFILER.span("lower.subquery", "subquery_ns"):
        with PROFILER.span("lower.dict", "dict_ns",
                           count=("dict_values", 7)) as sp:
            sp.add_count("dict_device_values", 7)
    assert [STATS[k] for k in keys] == [b + 5 for b in before]


def test_dict_device_share_reader():
    from qbench import harness
    read = harness.load_module("metrics", "dict_device_share.session").read

    def run(trace=object(), **counters):
        return types.SimpleNamespace(trace=trace, counters={
            f"fragment.{k}": v for k, v in counters.items()})
    assert read(run(dict_values=400, dict_device_values=300)) == 0.75
    assert read(run(None, dict_values=400, dict_device_values=300)) is None
    assert read(run(dict_values=0, dict_device_values=0)) is None
    assert read(run(dict_values=400)) is None
    assert read(run(dict_device_values=3)) is None


# ---------------------------------------------------------------------------
# the kernels' plain versions against the host's maps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("alphabet", ["ascii", "wide"])
@pytest.mark.parametrize("seed", [7, 2718281828])
def test_like_plain_matches_host(alphabet, seed):
    values = _dictionary(seed, 600, ASCII if alphabet == "ascii" else WIDE,
                         9)
    heap = StrDict(values).heap()
    assert _check_like(values, heap.data, heap.offsets) > 50


@pytest.mark.parametrize("alphabet", ["ascii", "wide"])
@pytest.mark.parametrize("seed", [11, 3141592653])
def test_substr_plain_matches_host(alphabet, seed):
    # at most 2 wide code points (8 bytes), so every map fits a key
    values = _dictionary(seed, 400, ASCII if alphabet == "ascii" else
                         list("aé日🙂"), 8 if alphabet == "ascii" else 2)
    heap = StrDict(values).heap()
    assert _check_substr(values, heap.data, heap.offsets) == len(SUBSTR)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return CUDA


def _on_card(values: np.ndarray):
    heap = StrDict(values).heap()
    return heap.data.to(CUDA), heap.offsets.to(CUDA)


@pytest.mark.cuda
@pytest.mark.parametrize("alphabet", ["ascii", "wide"])
@pytest.mark.parametrize("n", [0, 1, 5000, 200_000])
def test_like_kernel_matches_host(cuda_device, alphabet, n):
    values = _dictionary(n + 3, n, ASCII if alphabet == "ascii" else WIDE,
                         24)
    before = CK.LAUNCHES["like_match"]
    ran = _check_like(values, *_on_card(values))
    torch.cuda.synchronize()
    assert CK.LAUNCHES["like_match"] == before + ran


@pytest.mark.cuda
@pytest.mark.parametrize("alphabet", ["ascii", "wide"])
@pytest.mark.parametrize("n", [1, 5000, 150_000])
def test_substr_kernel_matches_host(cuda_device, alphabet, n):
    values = _dictionary(n + 5, n, ASCII if alphabet == "ascii" else
                         list("aé日🙂"), 8 if alphabet == "ascii" else 2)
    before = CK.LAUNCHES["substr_keys"]
    _check_substr(values, *_on_card(values))
    torch.cuda.synchronize()
    assert CK.LAUNCHES["substr_keys"] == before + len(SUBSTR)


@pytest.mark.cuda
def test_kernels_reject_bad_input(cuda_device):
    data, offs = _on_card(np.array(["ab", "c"], dtype=str))
    with pytest.raises(TypeError):
        CK.like_match(data.int(), offs, like_program("%"))
    with pytest.raises(ValueError):
        CK.like_match(data, offs.cpu(), like_program("%"))
    with pytest.raises(ValueError):
        CK.like_match(data, offs, np.zeros(CK.LIKE_MAX_OPS + 1, np.int16))
    with pytest.raises(ValueError):
        CK.substr_keys(data, offs, start=-1, count=2)
    with pytest.raises(ValueError):
        CK.substr_keys(data, offs, start=0, count=-1, right=True)


@pytest.fixture(scope="module")
def tpch_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from monetdb_tpu_torch.bench.tpch_gen import gen_tpch
    from monetdb_tpu_torch.bench.tpch_load import load_tables
    from monetdb_tpu_torch.engine import Engine
    data = gen_tpch(0.1)
    return data, Engine(load_tables(data, device=CUDA))


@pytest.mark.cuda
@pytest.mark.parametrize("q", range(1, 23))
def test_tpch_on_the_card_maps_dictionaries_on_the_card(cuda_device,
                                                        tpch_on_card, q):
    """TPC-H at SF0.1 on the card against the numpy oracle; the queries
    with LIKE or substring over a dictionary of DEVICE_MIN_VALUES values
    or more (o_comment, p_name, c_phone) map it on the card."""
    from monetdb_tpu_torch.bench import tpch_oracle
    from monetdb_tpu_torch.bench.tpch_queries import QUERIES
    data, eng = tpch_on_card
    before = STATS["dict_device_values"]
    got = list(eng.query(QUERIES[q]).rows)
    want = tpch_oracle.decoded(q, tpch_oracle.ORACLES[q](data))
    assert tpch_oracle.rows_differ(got, want, 1e-12) is None
    if q in (9, 13, 20, 22):
        assert STATS["dict_device_values"] > before
