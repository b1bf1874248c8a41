"""Interactive SQL shell — the mclient analog
(clients/mapiclient/mclient.c: prompt loop, box-drawing table output,
backslash commands, -s one-shot statements).

Usage:
  python -m monetdb_tpu_torch [DBPATH]               embedded (monetdbe-style)
  python -m monetdb_tpu_torch --host H --port P      network (mapi-style)
  python -m monetdb_tpu_torch -s "select 1" [DBPATH] one-shot
  python -m monetdb_tpu_torch --device cpu [DBPATH]  embedded store on the
                                                     CPU (default: cuda)
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

__all__ = ["main", "format_table"]


def format_table(names: List[str], rows: List[tuple],
                 max_rows: int = 1000) -> str:
    """mclient's +---+ box format (mclient.c tabular rendering)."""
    shown = rows[:max_rows]
    cells = [[("NULL" if v is None else str(v)) for v in r] for r in shown]
    widths = [len(n) for n in names]
    for r in cells:
        for i, c in enumerate(r):
            widths[i] = max(widths[i], len(c))
    sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
    out = [sep,
           "|" + "|".join(f" {n:<{w}} " for n, w in zip(names, widths))
           + "|", sep]
    for r in cells:
        out.append("|" + "|".join(f" {c:<{w}} "
                                  for c, w in zip(r, widths)) + "|")
    out.append(sep)
    tail = f"{len(rows)} tuple{'s' if len(rows) != 1 else ''}"
    if len(rows) > max_rows:
        tail += f" ({max_rows} shown)"
    out.append(tail)
    return "\n".join(out)


class Shell:
    def __init__(self, executor):
        self.executor = executor    # callable: sql text → Result/int/None

    def run_statement(self, text: str, out=None) -> None:
        out = out or sys.stdout
        from .engine import Result
        try:
            res = self.executor(text)
        except Exception as ex:
            print(f"error: {ex}", file=out)
            return
        if isinstance(res, Result):
            print(format_table(res.names, res.rows), file=out)
        elif isinstance(res, int):
            print(f"{res} affected rows", file=out)
        else:
            print("operation successful", file=out)

    def run_backslash(self, line: str, out=None) -> bool:
        """mclient \\ commands; returns False on \\q."""
        out = out or sys.stdout
        cmd, _, arg = line.partition(" ")
        if cmd in ("\\q", "\\quit"):
            return False
        if cmd == "\\d":
            if arg:
                self.run_statement(
                    f"select name, type, number from sys.columns "
                    f"where \"table\" = '{arg.strip()}' order by number",
                    out)
            else:
                self.run_statement(
                    "select name, type, count from sys.tables "
                    "order by name", out)
        elif cmd == "\\dn":
            self.run_statement("select name from sys.tables where type = 0 "
                               "order by name", out)
        elif cmd == "\\env":
            self.run_statement("select * from sys.env", out)
        elif cmd == "\\?":
            print("\\d [table]  list tables / describe table\n"
                  "\\env        server environment\n"
                  "\\q          quit", file=out)
        else:
            print(f"unknown command {cmd} (try \\?)", file=out)
        return True

    def repl(self, instream=None, out=None) -> None:
        instream = instream or sys.stdin
        out = out or sys.stdout
        buf: List[str] = []
        while True:
            try:
                prompt = "sql> " if not buf else "...> "
                if instream is sys.stdin and sys.stdin.isatty():
                    line = input(prompt)
                else:
                    line = instream.readline()
                    if not line:
                        break
                    line = line.rstrip("\n")
            except (EOFError, KeyboardInterrupt):
                break
            if not buf and line.startswith("\\"):
                if not self.run_backslash(line, out):
                    break
                continue
            buf.append(line)
            joined = "\n".join(buf).strip()
            if joined.endswith(";") or (joined and not line):
                buf = []
                if joined:
                    self.run_statement(joined.rstrip(";"), out)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="monetdb_tpu_torch",
                                 description="SQL shell of the PyTorch port")
    ap.add_argument("database", nargs="?", default=None,
                    help="database directory (embedded mode)")
    ap.add_argument("--host", default=None)
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("-u", "--user", default=None)
    ap.add_argument("-P", "--password", default=None)
    ap.add_argument("-s", "--statement", action="append", default=None,
                    help="execute statement(s) and exit")
    ap.add_argument("--device", default="cuda",
                    help="device of the embedded store (default: cuda)")
    args = ap.parse_args(argv)

    if args.host is not None:
        from .server import Client
        client = Client(args.host, args.port, args.user, args.password)
        executor = client.sql
    else:
        from .session import Session
        from .storage import Database
        executor = Session(Database(args.database, device=args.device)).sql

    shell = Shell(executor)
    if args.statement:
        for stmt in args.statement:
            shell.run_statement(stmt)
        return 0
    shell.repl()
    return 0


if __name__ == "__main__":
    sys.exit(main())
