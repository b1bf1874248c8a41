"""SQL front end: lexer, parser and binder (SQL text -> logical plan).

Copies of the reference package's host-only modules; the Session layer is
not ported yet."""
