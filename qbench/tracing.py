"""Spans and the device trace of a ``--trace 1`` run.

Spans come from the benchmark's own files: ``torch.profiler`` annotations
around each query (``q:<id>``) and the decode of its rows (``decode``),
and, while a traced run lasts, around the two calls into the program that
the harness wraps: building a ``CompiledFragment`` (``lower``, whose
``lower_ms`` the wrapper also records) and ``CompiledFragment.run``
(``interp``).  The device side is read from the profiler's own events:
kernels, copies and fills on the card (every device event but the
annotations' device-side copies; a kernel is one whose name does not start
with ``Memcpy`` or ``Memset``), on the same clock as the annotations.
Only ``name``, ``device_type``, ``start_ns`` and ``duration_ns`` of an
event are read.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

from . import stats

__all__ = ["Spans", "DeviceTrace", "read_trace"]

#: annotations that name what the host was doing
HOST_SPANS = ("lower", "interp", "decode")
WINDOW = "qbench.window"


def _ours(name: str) -> bool:
    return name == WINDOW or name in HOST_SPANS or name.startswith("q:")


def _on_device(e) -> bool:
    return str(e.device_type()).endswith("CUDA")




class Spans:
    """The program's lowering and interpreter calls wrapped in
    annotations; ``lowered`` collects each new fragment's ``lower_ms``.
    ``install`` replaces ``engine.CompiledFragment`` (the name both
    ``Engine.query`` and ``Engine.execute_plan`` construct) and the class's
    ``run``; ``remove`` puts both back."""

    def __init__(self):
        self.lowered: List[float] = []
        self._undo = []

    def install(self) -> None:
        import torch.profiler as P
        from monetdb_tpu_torch import engine
        cls = engine.CompiledFragment
        run = cls.run
        lowered = self.lowered

        def lower(*args, **kwargs):
            with P.record_function("lower"):
                frag = cls(*args, **kwargs)
            lowered.append(float(frag.lower_ms))
            return frag

        def interp(self, *args, **kwargs):
            with P.record_function("interp"):
                return run(self, *args, **kwargs)

        engine.CompiledFragment = lower
        cls.run = interp
        self._undo = [(engine, "CompiledFragment", cls), (cls, "run", run)]

    def remove(self) -> None:
        for obj, name, val in self._undo:
            setattr(obj, name, val)
        self._undo = []

    def take(self) -> Optional[float]:
        """Sum of the ``lower_ms`` recorded since the last call, or None
        when nothing was lowered."""
        if not self.lowered:
            return None
        total = sum(self.lowered)
        self.lowered.clear()
        return total


def annotate(name: str, on: bool):
    """A profiler annotation when ``on``, else nothing."""
    if not on:
        return contextlib.nullcontext()
    import torch.profiler as P
    return P.record_function(name)


class DeviceTrace:
    """What the trace of the traced passes says."""

    def __init__(self, window_s: float, busy_s: float, kernels: int,
                 device_ops: List[list], idle_gaps: List[list]):
        self.window_s = window_s
        self.busy_s = busy_s
        self.kernels = kernels
        self.device_ops = device_ops
        self.idle_gaps = idle_gaps


def _label(mid: int, spans: List[tuple]) -> str:
    """``<query>:<host span>`` of the annotations around the instant
    ``mid``: the query's, and of the host spans the innermost (the latest
    to start: a plan-time subquery runs inside ``lower``); ``other``
    inside a query but outside the wrapped calls, ``between`` outside
    every query."""
    query, inner, at = None, None, None
    for s, e, name in spans:
        if s <= mid < e:
            if name.startswith("q:"):
                query = name[2:]
            elif at is None or s > at:
                inner, at = name, s
    if query is None:
        return "between"
    return f"{query}:{inner or 'other'}"


def read_trace(events, top: int = 10) -> Optional[DeviceTrace]:
    """Reduce the profiler's raw events (``kineto_results.events()``)
    over the ``qbench.window`` annotation; None when the window or any
    device activity inside it is missing."""
    busy_iv, spans, win = [], [], []
    by_name: Dict[str, int] = {}
    for e in events:
        name = e.name()
        s = e.start_ns()
        t = s + e.duration_ns()
        if _on_device(e):
            if not _ours(name):          # the annotations' device copies
                busy_iv.append((s, t, name))
        elif name == WINDOW:
            win.append((s, t))
        elif _ours(name):
            spans.append((s, t, name))
    if not win:
        return None
    w0 = min(s for s, _t in win)
    w1 = max(t for _s, t in win)
    clipped = []
    kernels = 0
    for s, t, name in busy_iv:
        s, t = max(s, w0), min(t, w1)
        if t <= s:
            continue
        clipped.append((s, t))
        name = name[:160]
        by_name[name] = by_name.get(name, 0) + (t - s)
        kernels += not name.startswith(("Memcpy", "Memset"))
    busy_iv = clipped
    if not busy_iv:
        return None
    busy = stats.union_length(busy_iv)
    idle: Dict[str, int] = {}
    for s, t in stats.gaps(busy_iv, w0, w1):
        lab = _label((s + t) // 2, spans)
        idle[lab] = idle.get(lab, 0) + (t - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return DeviceTrace((w1 - w0) / 1e9, busy / 1e9, kernels,
                       [[k, v / 1e9] for k, v in ops],
                       [[k, v / 1e9] for k, v in gaps])
