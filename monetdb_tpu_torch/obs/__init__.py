"""Observability — the reference's tracing/profiling stack condensed:
GDKtracer leveled component logging (gdk/gdk_tracer.c), the per-instruction
JSON profiler event stream (monetdb5/mal/mal_profiler.c), and per-kernel
algorithm tags (MT_thread_setalgorithm, surfaced by TRACE — e.g.
gdk/gdk_join.c:2960 reporting which join strategy ran)."""

from .tracer import TRC, Tracer, set_level  # noqa: F401
from .profiler import Profiler, profiled, set_algorithm, PROFILER  # noqa: F401
