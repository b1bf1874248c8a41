"""Device operators — the GDK operator library of the reference
(select/calc/project/group/aggr/sort/join/window, date and string
functions) as plain functions on torch tensors, plus the hand-written CUDA
kernels (cuda_kernels.py) the fragment interpreter launches."""

from . import select, calc, project, group, aggr, sort, join, window  # noqa: F401
