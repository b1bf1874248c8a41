"""monetdb_tpu_torch — the PyTorch + CUDA port of monetdb_tpu.

The same engine as the reference package ``monetdb_tpu`` (JAX on a TPU),
written for PyTorch on one NVIDIA H100: SQL in, rows out, through the
fused-fragment interpreter (exec/fragment.py) and hand-written CUDA kernels
(ops/cuda_kernels.py, csrc/).  Module paths and names mirror the reference
package so each part has an obvious counterpart.  This package imports
torch and numpy, never jax or monetdb_tpu.

Tensors live on the device the caller names (``load_tpch(sf, device=...)``,
``Column.from_numpy(..., device=...)``); the engine runs wherever its
catalog's tensors are.
"""

from . import config  # noqa: F401
from .column import Cand, Column, StrDict  # noqa: F401
from .dtypes import (BOOL, DATE, F32, F64, I8, I16, I32, I64, OID,  # noqa: F401
                     TIMESTAMP, SQLType, decimal, varchar)
from .table import Catalog, Table  # noqa: F401

__version__ = "0.1.0"
