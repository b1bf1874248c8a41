"""Plan execution: the fused-fragment interpreter (fragment.py).  The
op-at-a-time executor is not ported yet."""
