"""Fused single-device benchmark fragments (flagship pipelines).

The reference package's bench/kernels.py (XLA-fused forms of the engine's
hot paths): Q6 = scan-filter + reduce at memory bandwidth; Q1 = filter +
dense-domain grouped aggregation (BATselect + BATgroup/BATgroupsum fused,
gdk/gdk_select.c + gdk_aggr.c).  They are also the per-shard bodies of
``parallel.sharded_q6`` / ``sharded_q1``.

On CUDA tensors Q1's grouped sums run in the hand-written kernels
(``ops/cuda_kernels.py``): six int32 columns in ``q1_grouped_sums``, any
other integer columns in ``seg_sum64`` (one launch a measure).  The plain
torch forms serve CPU tensors."""

from __future__ import annotations

import torch

from ..ops.cuda_kernels import q1_grouped_sums, seg_sum64

__all__ = ["q6_step", "q1_step"]


def q6_step(shipdate, disc, qty, extp, lo, hi, dlo, dhi, qmax):
    """Masked sum(extendedprice·discount) as a 0-d int64 tensor: the
    per-element product in extendedprice's dtype (int32 holds it for TPC-H
    domains), int64 accumulation."""
    m = ((shipdate >= lo) & (shipdate < hi)
         & (disc >= dlo) & (disc <= dhi) & (qty < qmax))
    prod = extp * disc.to(extp.dtype)
    return torch.where(m, prod, 0).to(torch.int64).sum()


def q1_step(code, shipdate, qty, extp, disc, tax, cutoff, *, domain: int = 8):
    """Filter + grouped sums over a dense group-code domain. Returns the
    associative partials (sum_qty, sum_base, sum_disc_price, sum_charge,
    sum_disc, count; int64[domain] each) that every Q1 output column —
    including the averages — derives from (gdk/gdk_aggr.c:1996 avg3).
    Rows with code outside [0, domain) or shipdate past cutoff do not
    count.  On a CUDA tensor the domain is at most the kernels' bound
    (``cuda_kernels.MAX_DOMAIN``)."""
    cols = (code, shipdate, qty, extp, disc, tax)
    if all(c.dtype == torch.int32 for c in cols):
        # the fused kernel forms the products in 64 bits
        return q1_grouped_sums(*(c.contiguous() for c in cols), int(cutoff),
                               domain=domain)
    m = (code >= 0) & (shipdate <= cutoff)
    dp = extp * (100 - disc)
    ch = dp * (100 + tax)
    sid = torch.where(m, code.to(torch.int64), domain)
    out = [seg_sum64(sid, v.to(torch.int64).contiguous(), domain=domain)
           for v in (qty, extp, dp, ch, disc)]
    return tuple(s for s, _c in out) + (out[0][1],)
