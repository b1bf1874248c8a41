"""User-defined functions — the analog of the reference's embedded Python
UDFs (sql/backends/monet5/UDF/pyapi3/: zero-copy numpy over BATs; CREATE
FUNCTION ... LANGUAGE PYTHON { body }).

Contract (mirrors pyapi's vectorized calling convention):
  * the body is a Python function body; parameters are bound by name to
    numpy arrays covering the whole column batch (scalar args arrive as
    0-d/py scalars);
  * numeric columns arrive as their physical numpy arrays (int sentinel
    nils included — see dtypes nil_value), DECIMAL arrives as float64
    (descaled), DATE as datetime64[D], VARCHAR as object array with None;
  * the body must `return` an array-like (or scalar, broadcast) of the
    declared RETURNS type.
"""

from __future__ import annotations

import dataclasses
import textwrap
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from .dtypes import Kind, SQLType

__all__ = ["UDF", "compile_python_udf", "udf_to_host", "udf_from_host"]


@dataclasses.dataclass
class UDF:
    name: str
    fn: Callable
    ret_type: SQLType
    arg_names: List[str]
    arg_types: List[SQLType]
    body: Optional[str] = None      # SQL-created UDFs keep source for WAL


def compile_python_udf(name: str, arg_names: List[str],
                       arg_types: List[SQLType], ret_type: SQLType,
                       body: str) -> UDF:
    """CREATE FUNCTION ... LANGUAGE PYTHON { body } → UDF (pyapi3's
    _connection-less exec model; numpy is pre-imported like pyapi does)."""
    src = "def __udf__({}):\n{}".format(
        ", ".join(arg_names), textwrap.indent(textwrap.dedent(body), "    "))
    ns: Dict[str, object] = {"np": np, "numpy": np}
    exec(src, ns)                                   # noqa: S102
    return UDF(name.lower(), ns["__udf__"], ret_type, arg_names, arg_types,
               body)


def udf_to_host(col, typ: SQLType) -> np.ndarray:
    """Column on any device → the numpy array handed to UDF bodies.  The
    physical values are read-only, as the reference package's view of a
    JAX array is (on the CPU they share the column's memory)."""
    raw = col.to_numpy()
    if typ.kind != Kind.STR:
        raw.setflags(write=False)
    if typ.kind == Kind.DECIMAL:
        from .dtypes import is_nil_np
        out = raw.astype(np.float64) / (10.0 ** typ.scale)
        out[is_nil_np(raw, typ)] = np.nan
        return out
    if typ.kind == Kind.DATE:
        return raw.astype("datetime64[D]")
    return raw


def udf_from_host(res, n: int, ret_type: SQLType, device):
    """UDF return value → Column of the declared type on ``device``."""
    from .storage.columns import column_from_pyvalues
    if np.isscalar(res) or res is None:
        res = [res] * n
    vals = list(np.asarray(res, dtype=object)) if not isinstance(res, list) \
        else res
    if len(vals) != n:
        raise ValueError(
            f"UDF returned {len(vals)} values for {n} input rows")
    conv = []
    for v in vals:
        if v is None or (isinstance(v, float) and np.isnan(v)):
            conv.append(None)
        elif isinstance(v, np.generic):
            conv.append(v.item())
        elif isinstance(v, np.datetime64):
            conv.append(v.astype("datetime64[D]").astype("O"))
        else:
            conv.append(v)
    return column_from_pyvalues(conv, ret_type, device=device)
