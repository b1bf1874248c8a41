"""Plan execution: the fused-fragment interpreter (fragment.py) and the
op-at-a-time executor it falls back to (executor.py, with the dataflow
worker pool of dataflow.py)."""

from .executor import Executor, Frame, Scalar  # noqa: F401
