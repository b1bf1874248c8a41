"""Cells at sizes a CPU test holds: the configurations' scales cut by
``qbench/tests/sizes/<config>.json``, every other setting as committed."""

import json
import os

from qbench import harness

SIZES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "sizes")


def bench() -> dict:
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def sizes(config: str) -> dict:
    """The keys a CPU test overrides in ``config``."""
    with open(os.path.join(SIZES, f"{config}.json")) as f:
        return json.load(f)


def cell(workload: str) -> harness.Cell:
    b = bench()
    w = [w for w in b["workloads"] if w["name"] == workload][0]
    return harness.Cell(b, workload, sizes(w["config"]))


def workloads() -> list:
    return [w["name"] for w in bench()["workloads"]]
