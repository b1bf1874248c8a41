"""Per-operator profiler — the reference's mal_profiler.c JSON event stream
(per-MAL-instruction start/done events with timings and arg sizes) plus the
per-kernel algorithm tag (MT_thread_setalgorithm) that TRACE surfaces so
users can see WHICH strategy a property-dispatched operator picked
(e.g. join: fetchjoin vs sortmerge; group: dense vs sort)."""

from __future__ import annotations

import contextlib
import json
import time
from typing import Any, Dict, List, Optional

__all__ = ["Profiler", "PROFILER", "profiled", "set_algorithm"]


class Profiler:
    def __init__(self):
        self.enabled = False
        self.events: List[Dict[str, Any]] = []
        self._algo: Optional[str] = None

    def start(self) -> None:
        self.enabled = True
        self.events = []

    def stop(self) -> List[Dict[str, Any]]:
        self.enabled = False
        return self.events

    def set_algorithm(self, algo: str) -> None:
        """Called by operator dispatch when it picks a strategy."""
        self._algo = algo

    @contextlib.contextmanager
    def op(self, name: str, **meta):
        if not self.enabled:
            yield
            return
        self._algo = None
        t0 = time.perf_counter()
        ev = {"op": name, "start_us": int(t0 * 1e6), **meta}
        yield
        ev["usec"] = int((time.perf_counter() - t0) * 1e6)
        if self._algo is not None:
            ev["algorithm"] = self._algo
        self.events.append(ev)

    def to_json(self) -> str:
        return "\n".join(json.dumps(e) for e in self.events)

    def summary(self) -> Dict[str, Dict[str, int]]:
        out: Dict[str, Dict[str, int]] = {}
        for e in self.events:
            s = out.setdefault(e["op"], {"calls": 0, "usec": 0})
            s["calls"] += 1
            s["usec"] += e.get("usec", 0)
        return out


PROFILER = Profiler()


def profiled(name: str, **meta):
    return PROFILER.op(name, **meta)


def set_algorithm(algo: str) -> None:
    PROFILER.set_algorithm(algo)
