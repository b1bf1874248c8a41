"""Test harness — the reference's testing/ directory condensed: a
sqllogictest-compatible runner (testing/sqllogictest.py, 2223 .test files in
the reference tree) over Session."""

from .sqllogic import SqlLogicRunner, SqlLogicError  # noqa: F401
