"""Runtime column property assertions — the GDKdebug/`BATassertProps`
analog (reference gdk/gdk_bat.c BATassertProps; GDKdebug bitmask,
gdk/gdk.h).

Property flags (sorted/revsorted/key/nonil, minval/maxval) drive kernel
selection exactly as the reference's COLrec flags drive BATselect /
BATjoin strategy picks — a wrong flag silently picks a wrong fast path.
With ``config.assert_props`` on (env ``MTPU_ASSERT_PROPS=1``), every
operator output is validated against its claimed flags and a violation
raises :class:`PropertyError` loudly, naming the operator and flag.
"""

from __future__ import annotations

import numpy as np

from ..dtypes import Kind, is_nil_np

__all__ = ["PropertyError", "assert_col_props", "assert_frame_props"]


class PropertyError(AssertionError):
    """A column's claimed property flag contradicts its data."""


def _live_values(col):
    raw = col.data[: col.count].cpu().numpy()
    nil = is_nil_np(raw, col.typ)
    return raw, nil


def assert_col_props(col, where: str = "") -> None:
    """Validate ``col``'s property flags against its actual data.

    Mirrors BATassertProps' checks: tsorted/trevsorted monotonicity
    (nil sorts smallest, as the reference's sentinel order implies),
    tkey distinctness, tnonil, and min/max envelope correctness.
    """
    if col.count <= 0:
        return
    raw, nil = _live_values(col)
    ctx = f"{where}: " if where else ""
    if col.nonil and nil.any():
        raise PropertyError(
            f"{ctx}nonil column has {int(nil.sum())} nil(s) "
            f"(first at row {int(np.argmax(nil))})")
    if col.count > 1 and (col.sorted or col.revsorted or col.key):
        # compare in a nil-aware domain: nil < every value (integer nil
        # sentinels are already the type minimum; floats use nan → -inf)
        vals = raw
        if vals.dtype.kind == "f":
            vals = np.where(nil, -np.inf, vals)
        if col.sorted and not (vals[:-1] <= vals[1:]).all():
            i = int(np.argmax(vals[:-1] > vals[1:]))
            raise PropertyError(
                f"{ctx}sorted column decreases at row {i}: "
                f"{vals[i]!r} > {vals[i+1]!r}")
        if col.revsorted and not (vals[:-1] >= vals[1:]).all():
            i = int(np.argmax(vals[:-1] < vals[1:]))
            raise PropertyError(
                f"{ctx}revsorted column increases at row {i}: "
                f"{vals[i]!r} < {vals[i+1]!r}")
        if col.key:
            # key = all values distinct (multiple nils violate it, like
            # the reference's tkey)
            if len(np.unique(raw)) != col.count:
                raise PropertyError(f"{ctx}key column has duplicates")
    if (col.minval is not None or col.maxval is not None) and \
            raw.dtype.kind in "iuf":
        vals = raw[~nil]
        if len(vals):
            if col.minval is not None and vals.min() < col.minval:
                raise PropertyError(
                    f"{ctx}minval {col.minval!r} > actual min "
                    f"{vals.min()!r}")
            if col.maxval is not None and vals.max() > col.maxval:
                raise PropertyError(
                    f"{ctx}maxval {col.maxval!r} < actual max "
                    f"{vals.max()!r}")
    if col.typ.kind == Kind.STR and col.sdict is not None and \
            raw.dtype.kind in "iu":
        # dictionary codes must be in range (-1 = nil)
        bad = (raw >= len(col.sdict.values)) | (raw < -1)
        if bad.any():
            raise PropertyError(
                f"{ctx}string code out of dictionary range at row "
                f"{int(np.argmax(bad))}")


def assert_frame_props(frame, where: str = "") -> None:
    for (t, n), col in frame.cols.items():
        assert_col_props(col, f"{where} {t}.{n}")
