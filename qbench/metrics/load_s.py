"""``load_s``: seconds, by the benchmark's host clock, of the entry's open:
the program building its store or catalog from the generated arrays
(``Database.create_table`` and ``TableData.append`` behind the Session;
the column constructors and their property scans behind the Engine).
One phase of ``setup_s``; ``Run.setup_counters`` holds the program's
counters as they stood at the end of set-up."""


def read(run):
    return run.setup.get("load_s")
