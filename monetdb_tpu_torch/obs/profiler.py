"""Per-operator profiler — the reference's mal_profiler.c JSON event stream
(per-MAL-instruction start/done events with timings and arg sizes) plus the
per-kernel algorithm tag (MT_thread_setalgorithm) that TRACE surfaces so
users can see WHICH strategy a property-dispatched operator picked
(e.g. join: fetchjoin vs sortmerge; group: dense vs sort).

Beside the executor's operator events (``events``), the profiler times the
program's layers with *spans* (``span``): a named interval with an id, the
id of the span open around it on the same thread (``parent``) and the id of
the query it belongs to (``query``), stamped with ``time.time_ns()``, the
clock ``torch.profiler`` stamps its host events with and converts the
device's timestamps to.  Spans are plain host records: nothing goes into
``torch.profiler``'s trace.

Always, when a span that names a counter closes, its *self time* (its
duration less the time its counted descendants cover, in ns) is added to
that counter in ``exec.fragment.STATS``.  Inside a ``lower.subquery`` span
every counted span charges ``subquery_ns`` instead of its own counter, so
the counters of a query add up exactly to the durations of its root spans.
Only while recording (between ``start`` and ``stop``, or inside
``record``), closed spans are also kept in ``spans``; spans that name no
counter (the interpreter's relational nodes, the executor's operators) are
made only then."""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

__all__ = ["Profiler", "PROFILER", "profiled", "set_algorithm"]

_IDS = itertools.count(1)
#: query ids of roots that bring none (an ``Engine.query``): negative, so
#: that they never equal a ``sys.queue`` tag
_QUERY_IDS = itertools.count(-1, -1)
#: ``exec.fragment``'s (STATS, its lock), taken at the first charge
#: (``exec.fragment`` imports this module)
_COUNTERS = None
_NO_RECORDING = contextlib.nullcontext()


def _counters():
    global _COUNTERS
    from ..exec.fragment import _LOCK, STATS
    _COUNTERS = STATS, _LOCK
    return _COUNTERS


class Span:
    """One span; a context manager.  ``attrs`` are free attributes (the
    TRACE view of ``fragment.run`` reads them)."""

    __slots__ = ("name", "id", "parent", "query", "start_ns", "end_ns",
                 "tid", "attrs", "_prof", "_key", "_count", "_root", "_sub",
                 "_prev", "_up", "_covered")

    def __init__(self, prof: "Profiler", name: str, key: Optional[str],
                 count, root: bool, query, attrs: Dict[str, Any]):
        self._prof = prof
        self.name = name
        self._key = key
        self._count = () if count is None else (count,)
        self._root = root
        self.query = query
        self.attrs = attrs
        self._covered = 0

    def __enter__(self) -> "Span":
        local = self._prof._local
        top = getattr(local, "top", None)
        self.id = next(_IDS)
        self._prev = top
        if top is None:
            self.parent = None
            self._up = None
            self._sub = False
            if self._root and self.query is None:
                self.query = next(_QUERY_IDS)
        else:
            self.parent = top.id
            self._root = False
            if self.query is None:
                self.query = top.query
            self._up = top if top._key is not None else top._up
            self._sub = top._sub or top.name == "lower.subquery"
            if self._sub and self._key is not None:
                self._key, self._count = "subquery_ns", None
        local.top = self
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end = self.end_ns = time.time_ns()
        prof = self._prof
        prof._local.top = self._prev
        if self._key is not None:
            dur = end - self.start_ns
            stats, lock = _COUNTERS or _counters()
            with lock:
                stats[self._key] += dur - self._covered
                for key, n in self._count or ():
                    stats[key] += n
                if self._root:
                    stats["queries"] += 1
            if self._up is not None:
                self._up._covered += dur
        self._prev = self._up = None
        if prof.recording:
            self.tid = threading.get_native_id()
            prof.spans.append(self)
        return False

    def add_count(self, key: str, n: int) -> None:
        """Add ``n`` to the STATS counter ``key`` as well when the span
        closes, as ``count`` does (and, as it, not inside a
        ``lower.subquery``)."""
        if self._count is not None:
            self._count += ((key, n),)

    def view(self) -> Dict[str, Any]:
        """The span as a TRACE event of the reference's shape:
        ``{"op": name, **attrs, "usec": duration}``."""
        return {"op": self.name, **self.attrs,
                "usec": (self.end_ns - self.start_ns) // 1000}


class Profiler:
    def __init__(self):
        self.enabled = False
        self.events: List[Dict[str, Any]] = []
        self.spans: List[Span] = []
        #: spans are kept: ``start`` was called, or a ``record`` is open
        self.recording = False
        self._started = False
        self._open = 0
        self._lock = threading.Lock()
        self._local = threading.local()
        self._algo: Optional[str] = None

    def start(self) -> None:
        self.enabled = True
        self.events = []
        self.spans = []
        self._recorders(0, started=True)

    def stop(self) -> List[Dict[str, Any]]:
        self.enabled = False
        self._recorders(0, started=False)
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
        t0 = time.time_ns()
        ev = {"op": name, "start_us": t0 // 1000, **meta}
        with (self.span(name, **meta) if self.recording
              else contextlib.nullcontext()):
            yield
        ev["usec"] = (time.time_ns() - t0) // 1000
        if self._algo is not None:
            ev["algorithm"] = self._algo
        self.events.append(ev)

    # -- spans ---------------------------------------------------------------
    def span(self, name: str, key: Optional[str] = None, *, count=None,
             root: bool = False, query=None, **attrs) -> Span:
        """A span named ``name`` charging its self time to the STATS
        counter ``key`` (None: charges nothing).  ``count`` = (STATS key,
        n) is added as well when it closes.  A ``root`` span opened on a
        thread with no span open counts one ``queries`` and carries
        ``query`` (a fresh id if None); any span opened so carries
        ``query``, and one opened inside another carries its parent's."""
        return Span(self, name, key, count, root, query, attrs)

    def current(self) -> Optional[Span]:
        """The innermost span open on this thread."""
        return getattr(self._local, "top", None)

    def record(self, on: bool = True):
        """Keep spans while the returned context is open (a no-op context
        when ``on`` is false).  When the last recorder closes and
        ``start`` is not on, the kept spans are dropped."""
        return self._recording() if on else _NO_RECORDING

    @contextlib.contextmanager
    def _recording(self):
        self._recorders(1)
        try:
            yield
        finally:
            self._recorders(-1)

    def _recorders(self, delta: int, started: Optional[bool] = None) -> None:
        """Count ``delta`` more open recorders (and set whether ``start``
        is on), then whether spans are kept."""
        with self._lock:
            self._open += delta
            if started is not None:
                self._started = started
            self.recording = self._started or self._open > 0
            if not self.recording and delta:
                self.spans = []

    def last_child(self, parent: Optional[Span], name: str) -> Optional[Span]:
        """The latest kept span ``name`` opened directly inside ``parent``
        (None: at the top) on this thread."""
        pid = None if parent is None else parent.id
        tid = threading.get_native_id()
        for s in reversed(self.spans):
            if s.name == name and s.parent == pid and s.tid == tid:
                return s
        return None

    def chrome_events(self, base_ns: int = 0) -> List[Dict[str, Any]]:
        """The kept spans as Chrome trace complete ("X") events, ``ts`` in
        µs from ``base_ns``: with a ``torch.profiler`` export's
        ``baseTimeNanoseconds`` they join that export's ``traceEvents``."""
        pid = os.getpid()
        return [{"name": s.name, "ph": "X", "cat": "program", "pid": pid,
                 "tid": s.tid, "ts": (s.start_ns - base_ns) / 1000,
                 "dur": (s.end_ns - s.start_ns) / 1000,
                 "args": {"query": s.query, "id": s.id, "parent": s.parent,
                          **s.attrs}}
                for s in self.spans]

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
