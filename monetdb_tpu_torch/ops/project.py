"""Projection / positional gather — the reference's BATproject family
(gdk/gdk_project.c:857 BATproject, :590 BATproject2, :880 BATprojectchain).

``project(oids, col)`` returns ``col[oids[i]]`` for each live oid; dead slots
(padding, oid == -1) map to the type's nil. Chains of projections collapse to
one gather of composed indices (the opt_projectionpath analog,
monetdb5/optimizer/opt_projectionpath.c) via :func:`project_chain`.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..column import Cand, Column, valid_mask
from ._tensor import nil_const
from .select import materialize

__all__ = ["project", "project_oids", "project_chain", "gather_nil"]


def gather_nil(oids, oid_count, values, nil=None):
    """values[oids] for the live prefix; dead slots (padding, oid < 0) → nil."""
    live = valid_mask(oids.shape[0], oid_count, oids.device) & (oids >= 0)
    safe = torch.where(live, oids, 0).long()
    if nil is None:
        nil = nil_const(values.dtype)
    return torch.where(live, values[safe], nil)


def project_oids(oids: torch.Tensor, oid_count: int, col: Column) -> Column:
    data = gather_nil(oids, oid_count, col.data)
    return Column(col.typ, data, oid_count, nonil=col.nonil,
                  sdict=col.sdict, key=False)


def project(cand_or_oids, col: Column) -> Column:
    """BATproject: gather col rows selected by a candidate (materializes the
    candidate if needed — one device read, like the reference's result BAT)."""
    if isinstance(cand_or_oids, Cand):
        c = materialize(cand_or_oids, col.cap, col.data.device)
        out = project_oids(c.oids, c.oid_count, col)
        # a projection through sorted candidates preserves sortedness
        if col.sorted:
            out = out.with_props(sorted=True)
        if col.revsorted:
            out = out.with_props(revsorted=True)
        return out
    oids, n = cand_or_oids
    return project_oids(oids, n, col)


def _compose(o1, n1, o2):
    """o_out[i] = o2[o1[i]] with -1 propagation."""
    live = valid_mask(o1.shape[0], n1, o1.device) & (o1 >= 0)
    safe = torch.where(live, o1, 0).long()
    return torch.where(live, o2[safe], -1)


def project_chain(oid_list: Sequence, col: Column) -> Column:
    """BATprojectchain: fold [(oids, count), ...] then gather once."""
    (o, n) = oid_list[0]
    for (o2, _n2) in oid_list[1:]:
        o = _compose(o, n, o2)
    return project_oids(o, n, col)
