"""Engine configuration: the keys of the reference package's config.py that
the ported slice reads, with the same ``get``/``set``/``reset`` interface.

Values can be set programmatically or via environment variables prefixed
``MTPU_`` (e.g. ``MTPU_OVERFLOW_CHECKS=0``).
"""

from __future__ import annotations

import os
from typing import Any, Dict

_defaults: Dict[str, Any] = {
    # raise on integer/decimal overflow like the reference's BATcalc*
    # (gdk/gdk_calc_addsub.c ON_OVERFLOW macros)
    "overflow_checks": True,
    # lower whole plans into one fragment when supported (exec/fragment.py);
    # a plan the fragment rejects runs op-at-a-time (exec/executor.py)
    "fragment_exec": True,
    # smallest bucketed capacity of a device column (column.capacity_for)
    "min_capacity": 1024,
    # number of rows below which group-by takes the sort path unconditionally
    "small_sort_threshold": 1 << 14,
    # observability
    "trace": False,
    # GDKdebug-style runtime property assertions (BATassertProps,
    # gdk/gdk_bat.c): validate every operator output's claimed flags
    # (sorted/key/nonil/min/max); a wrong flag fails loudly instead of
    # silently picking a wrong fast path. Env: MTPU_ASSERT_PROPS=1.
    "assert_props": False,
    # dataflow scheduler (mal_dataflow.c DFLOWworker pool analog):
    # worker threads for independent plan subtrees; 0/1 = sequential
    "dataflow_workers": 4,
    # admission-control memory pool in bytes (mal_resource.c memorypool);
    # tasks whose estimated footprint exceeds the free pool are delayed
    "mem_maxsize": 4 << 30,
}

_values: Dict[str, Any] = {}


def get(key: str) -> Any:
    if key in _values:
        return _values[key]
    env = os.environ.get("MTPU_" + key.upper())
    if env is not None:
        d = _defaults[key]
        if isinstance(d, bool):
            return env not in ("0", "false", "no", "")
        return type(d)(env)
    return _defaults[key]


def set(key: str, value: Any) -> None:  # noqa: A001 - mirrors GDKsetenv
    if key not in _defaults:
        raise KeyError(f"unknown config key: {key}")
    _values[key] = value


def reset(key: str | None = None) -> None:
    if key is None:
        _values.clear()
    else:
        _values.pop(key, None)
