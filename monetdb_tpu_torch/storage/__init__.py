"""Physical values ↔ device columns (columns.py).  The persistent store
(database, write-ahead log) is not ported yet."""
