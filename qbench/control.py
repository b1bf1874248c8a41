"""The control of the comparison that decides ``correct``: the reference
computed in the precision below the one the configuration states, put in
the program's place, must come out not correct.

    python3 -m qbench.control --workload <name> --seeds <n>,<n>,...

For each seed: the cell's data from the seed, the reference's answers, the
control's answers (the reference module's ``control``), and the cell's
comparison of the control against the reference, once per query of the
mix.  Prints one JSON line a seed with the numbers compared, and exits 1
when the comparison passed the control on any seed.  Runs on the card when
there is one, else on the CPU (``--device`` to choose); the benchmark's own
runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from . import compare, harness


def read(cell: harness.Cell, seed: int, device) -> dict:
    """The numbers compared for the control of ``cell`` on ``seed``."""
    cfg = cell.cfg
    gen = harness.load_module("gen", cfg["generator"])
    ref = harness.load_module("reference", cfg["reference"])
    t = time.perf_counter()
    data = gen.generate(cfg, seed, device)
    want = ref.expected(data, cell.qids, device)
    got = ref.control(data, cell.qids, device, want=want)
    answers = []
    for q in cell.qids:
        a = harness.Answer(q)
        a.rows = got[q]
        answers.append(a)
    checks = compare.judge(answers, want, float(cfg["float_rel_limit"]))
    return {"workload": cell.name, "seed": seed, "device": str(device),
            "control_passed": checks.passed(),
            "checks": checks.as_dict(),
            "wrong_queries": sorted(checks.wrong_queries),
            "seconds": time.perf_counter() - t}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="qbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    import torch
    device = torch.device(args.device or (
        "cuda" if torch.cuda.is_available() else "cpu"))
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        cell = harness.Cell(json.load(f), args.workload)
    passed = False
    for s in args.seeds.split(","):
        out = read(cell, int(s), device)
        passed |= out["control_passed"]
        print(json.dumps(out), flush=True)
    return 1 if passed else 0


if __name__ == "__main__":
    sys.exit(main())
