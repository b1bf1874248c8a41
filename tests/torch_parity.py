"""The comparison the port's parity tests hold its results to: a result of
the PyTorch port (monetdb_tpu_torch) against the JAX package's
(monetdb_tpu) for the same statement over the same data.

Names, types (by ``repr``), strings, decimals, integers, dates and counts
must be equal, and of the same Python type.  A float ``g`` of the port
must be a float within ``max(rtol * |w|, atol)`` of the JAX package's
``w``, or NaN where ``w`` is NaN.  The tolerance is the path's:

* ``FRAGMENT_RTOL`` (rel 1e-12) for the fragment Engine and ``Session``:
  both sides divide an exact integer sum by a power of ten and the count,
  but torch's CPU kernel divides by a scalar as a multiply by its
  reciprocal, so the last bit can differ;
* ``EXECUTOR_RTOL`` (rel 1e-9, ``EXECUTOR_ATOL`` 1e-300) for the
  op-at-a-time executor: var/stdev/corr sum squares by ``index_add_``,
  whose order is not XLA's.

Not a test module (pytest collects ``test_*.py`` only); it imports no JAX,
so a port module that must not load JAX may import it too.

Importing it limits torch to two CPU threads for the whole process.  The
suite runs on six xdist workers, and every worker imports every test
module: with torch's default of one thread a core, six workers' spinning
op threads oversubscribe the cores and stretch every port test.
"""

import math

import pytest
import torch

torch.set_num_threads(2)

FRAGMENT_RTOL = 1e-12
EXECUTOR_RTOL = 1e-9
EXECUTOR_ATOL = 1e-300


def assert_rows_close(got, want, rtol, atol=0.0):
    """Row lists ``got`` (the port's) and ``want`` (the JAX package's)
    equal under the rule above."""
    assert len(got) == len(want), (len(got), len(want))
    for grow, wrow in zip(got, want):
        assert len(grow) == len(wrow), (grow, wrow)
        for g, w in zip(grow, wrow):
            if isinstance(w, float):
                assert isinstance(g, float), (grow, wrow)
                assert g == w or (math.isnan(g) and math.isnan(w)) or \
                    abs(g - w) <= max(rtol * abs(w), atol), (grow, wrow)
            else:
                assert type(g) is type(w) and g == w, (grow, wrow)


def assert_same_result(got, want, rtol, atol=0.0):
    """Names, types and rows of two results (anything with ``names``,
    ``types`` and ``rows``)."""
    assert got.names == want.names
    assert list(map(repr, got.types)) == list(map(repr, want.types))
    assert_rows_close(list(got.rows), list(want.rows), rtol, atol)


@pytest.fixture
def executor_only():
    """``fragment_exec`` off in both packages for one test."""
    import monetdb_tpu.config as ref_config
    import monetdb_tpu_torch.config as config
    config.set("fragment_exec", False)
    ref_config.set("fragment_exec", False)
    yield
    config.reset("fragment_exec")
    ref_config.reset("fragment_exec")
