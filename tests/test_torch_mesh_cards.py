"""monetdb_tpu_torch/bench/mesh_cards.py, the multi-card comparison of the
one-card Session with the default mesh's, driven here on CPU shards at
SF0.01 (its ``main`` needs two or more CUDA devices)."""

import os

os.environ.setdefault("MTPU_TORCH_EXPAND_MEMO", "0")

import time  # noqa: E402

import torch  # noqa: E402

from monetdb_tpu_torch.bench import mesh_cards as MC  # noqa: E402
from monetdb_tpu_torch.bench.tpch_load import load_tpch_db  # noqa: E402
from monetdb_tpu_torch.exec import fragment as TF  # noqa: E402
from monetdb_tpu_torch.parallel import row_mesh  # noqa: E402
from monetdb_tpu_torch.session import Session  # noqa: E402


def test_compare_holds_mesh_rows_to_one_device():
    db = load_tpch_db(0.01, device="cpu")
    devs = [torch.device("cpu")] * 4
    res = {"queries": {}, "errors": {}}
    s0 = TF.STATS["spmd_runs"]
    bad = MC.compare(Session(db), Session(db, mesh=row_mesh(devs)), devs,
                     (1, 6), 1, time.perf_counter() + 600, res)
    assert bad == 0 and not res["errors"]
    assert sorted(res["queries"]) == [1, 6]
    for v in res["queries"].values():
        assert v["rows_equal"] and v["counts"]["spmd_runs"] == 2
        assert v["one_card_median_ms"] > 0 and v["mesh_median_ms"] > 0
    assert TF.STATS["spmd_runs"] == s0 + 4


def test_compare_counts_a_query_past_its_deadline():
    res = {"queries": {}, "errors": {}}
    assert MC.compare(None, None, [], (3,), 1, time.perf_counter() - 1,
                      res) == 0
    assert res["errors"] == {3: "not run: time budget spent"}


def test_main_needs_two_cards():
    if torch.cuda.is_available() and torch.cuda.device_count() > 1:
        return                          # a multi-card host runs it for real
    assert MC.main([]) == 2
