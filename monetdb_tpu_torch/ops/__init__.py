"""Device operators the fragment interpreter uses: sort keys (sort.py),
arithmetic error types (calc.py) and the hand-written CUDA kernels
(cuda_kernels.py)."""
