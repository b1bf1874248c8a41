"""GDKtracer analog (gdk/gdk_tracer.{h,c}): leveled, per-component logging
into a bounded ring buffer with optional file adapter. Components are
grouped by layer as in gdk_tracer.h:53-134; levels CRITICAL..DEBUG;
runtime-adjustable per component (the reference exposes this through
logging.* SQL functions — here through set_level())."""

from __future__ import annotations

import collections
import sys
import time
from typing import Deque, Optional, Tuple

__all__ = ["Tracer", "TRC", "set_level", "LEVELS"]

LEVELS = {"critical": 0, "error": 1, "warning": 2, "info": 3, "debug": 4}

COMPONENTS = {
    # layer → components (gdk_tracer.h grouping, engine-mapped)
    "storage": {"wal", "manifest", "delta", "dict"},
    "exec": {"plan", "bind", "select", "join", "group", "aggr", "sort",
             "window", "calc"},
    "parallel": {"mesh", "shuffle"},
    "client": {"session", "result"},
}


class Tracer:
    def __init__(self, capacity: int = 8192):
        self.ring: Deque[Tuple[float, str, str, str]] = \
            collections.deque(maxlen=capacity)
        self.levels = {c: LEVELS["error"] for g in COMPONENTS.values()
                       for c in g}
        self.sink = None   # optional file object

    def set_level(self, component: str, level: str) -> None:
        if component == "all":
            for c in self.levels:
                self.levels[c] = LEVELS[level]
        else:
            self.levels[component] = LEVELS[level]

    def log(self, level: str, component: str, msg: str) -> None:
        if LEVELS[level] > self.levels.get(component, 1):
            return
        rec = (time.time(), level, component, msg)
        self.ring.append(rec)
        if self.sink is not None:
            print(f"{rec[0]:.6f} {level.upper()} [{component}] {msg}",
                  file=self.sink)

    # convenience per-level methods
    def critical(self, c, m):
        self.log("critical", c, m)

    def error(self, c, m):
        self.log("error", c, m)

    def warning(self, c, m):
        self.log("warning", c, m)

    def info(self, c, m):
        self.log("info", c, m)

    def debug(self, c, m):
        self.log("debug", c, m)

    def dump(self, n: int = 100):
        return list(self.ring)[-n:]


TRC = Tracer()


def set_level(component: str, level: str) -> None:
    TRC.set_level(component, level)
