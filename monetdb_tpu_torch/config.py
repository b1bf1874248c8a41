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
    # smallest bucketed capacity of a device column (column.capacity_for)
    "min_capacity": 1024,
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
