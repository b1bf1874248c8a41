"""SQL front end: lexer, parser, binder, PSM, distribution DDL and system
relations (SQL text -> logical plan).  Copies of the reference package's
host-only modules; ``session.Session`` drives them over a ``Database``."""
