"""Dataflow scheduler + resource admission — the host-side analog of the
reference's MAL dataflow engine.

Reference mapping:
  * DFLOWworker thread pool pulling runnable instructions
    (monetdb5/mal/mal_dataflow.c:247, q_dequeue :193)        ⟷ a shared
    ThreadPoolExecutor running independent Rel subtrees; torch's eager
    dispatch is thread-safe and every worker enqueues on the current
    CUDA stream, so results do not depend on the interleaving.
  * MALadmission_claim memory watermark (monetdb5/mal/mal_resource.c:117:
    delay instructions whose argument footprint exceeds the free pool,
    always admit when the pool is idle)                      ⟷ Admission:
    byte claims against a configurable pool with the same always-admit-
    when-idle rule (prevents deadlock on oversized claims).

The scheduler is engine-global (one pool per process, like the reference's
worker pool shared across sessions).
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence

from .. import config

__all__ = ["Admission", "run_parallel", "stats"]


class Admission:
    """Memory-watermark admission control (mal_resource.c MALadmission).

    claim(n) blocks until n bytes fit in the free pool — except when the
    pool is completely idle, where any claim is admitted (the reference's
    rule: a single instruction may always run, else big queries would
    deadlock)."""

    def __init__(self, pool: int):
        self.pool = pool
        self.free = pool
        self.active = 0
        self.delayed = 0          # stat: how often admission delayed a task
        self._cv = threading.Condition()

    def claim(self, n: int) -> int:
        with self._cv:
            if n > self.free and self.active > 0:
                self.delayed += 1
                while n > self.free and self.active > 0:
                    self._cv.wait(timeout=0.05)
            granted = min(n, self.pool)
            self.free -= granted
            self.active += 1
            return granted

    def release(self, granted: int) -> None:
        with self._cv:
            self.free += granted
            self.active -= 1
            self._cv.notify_all()


_LOCK = threading.Lock()
_POOL: Optional[ThreadPoolExecutor] = None
_ADMISSION: Optional[Admission] = None
_PARALLEL_RUNS = 0


def _ensure() -> tuple:
    global _POOL, _ADMISSION
    with _LOCK:
        if _POOL is None:
            _POOL = ThreadPoolExecutor(
                max_workers=max(int(config.get("dataflow_workers")), 2),
                thread_name_prefix="dflow")
        if _ADMISSION is None:
            _ADMISSION = Admission(int(config.get("mem_maxsize")))
    return _POOL, _ADMISSION


def run_parallel(thunks: Sequence[Callable], claims: Sequence[int]) -> List:
    """Run thunks concurrently under admission control; results in order.
    Exceptions propagate (first one wins), matching the reference's
    dataflow error plumbing (mal_dataflow.c q_enqueue of error state)."""
    global _PARALLEL_RUNS
    pool, adm = _ensure()

    def wrap(fn, n):
        granted = adm.claim(n)
        try:
            return fn()
        finally:
            adm.release(granted)

    _PARALLEL_RUNS += 1
    futs = [pool.submit(wrap, fn, n) for fn, n in zip(thunks, claims)]
    return [f.result() for f in futs]


def stats() -> dict:
    adm = _ADMISSION
    return {
        "parallel_runs": _PARALLEL_RUNS,
        "delayed": adm.delayed if adm else 0,
        "pool_bytes": adm.pool if adm else 0,
        "free_bytes": adm.free if adm else 0,
    }
