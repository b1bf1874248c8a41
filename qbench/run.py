"""The benchmark's command: one run of one cell.

    python3 -m qbench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout that holds ``BENCHMARK.json``, ``qbench/``
and the program, ``monetdb_tpu_torch``, on a machine with the card(s) the
cell asks for.  Prints what it does on standard error, then the numbers
compared for ``correct`` beside their limits as its last lines there, and
one JSON object as the last line of standard output.  Exits 2 on bad
arguments, 4 without the program, 3 without the card(s) (it never falls
back to the CPU), 5 when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: module top-level names that must not be loaded (compared whole: the
#: port's name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "monetdb_tpu")
#: caches of the program's builds, at fixed paths inside the checkout
CACHE = os.path.join(ROOT, "qbench", "_cache")


def _log(msg: str) -> None:
    print(f"qbench: {msg}", file=sys.stderr, flush=True)


def forbidden_loaded() -> list:
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def _environment() -> None:
    """Build caches inside the checkout; a capacity memo of this run's own
    (the program reads it from ``MTPU_TORCH_EXPAND_MEMO``), so that a run's
    retries do not depend on the runs before it."""
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    import tempfile
    memo = os.path.join(tempfile.gettempdir(), "qbench_expand_memo.json")
    if os.path.exists(memo):
        os.remove(memo)
    os.environ["MTPU_TORCH_EXPAND_MEMO"] = memo


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="qbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    from qbench import harness
    cell = harness.Cell(bench, args.workload)
    try:
        import monetdb_tpu_torch  # noqa: F401
    except ImportError as exc:
        _log(f"the program is missing: {exc}")
        return 4
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        _log(f"needs {cell.chips} CUDA device(s); "
             f"{torch.cuda.device_count()} visible")
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    _log(f"{args.workload} seed {args.seed} on "
         f"{torch.cuda.get_device_name(device)}, {args.seconds} s, "
         f"trace {args.trace}")
    result, _checks = harness.run_cell(cell, args.seed, args.seconds,
                                      bool(args.trace), device, T_START,
                                      log=_log)
    bad = forbidden_loaded()
    if bad:
        _log(f"loaded, and must not be: {', '.join(bad)}")
        return 5
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
