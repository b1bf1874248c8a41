"""Logical plans: bound expressions (exprs.py) and the relational tree
(logical.py) the binder produces and the fragment lowering consumes."""
