"""Cells at sizes a CPU test holds: the configurations' scales cut, every
other setting as committed."""

import json
import os

from qbench import harness

#: per configuration, the keys a test changes
TINY = {"tpch-sf1": {"scale_factor": 0.01},
        "ssb-sf20": {"scale_factor": 0.01, "rows": {"lineorder": 30000}}}


def bench() -> dict:
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(workload: str) -> harness.Cell:
    b = bench()
    w = [w for w in b["workloads"] if w["name"] == workload][0]
    return harness.Cell(b, workload, TINY[w["config"]])


def workloads() -> list:
    return [w["name"] for w in bench()["workloads"]]
