"""``upload_s``: seconds the program spent uploading table versions to the
device during set-up: the self time of its ``load.upload`` spans (each
column's live rows copied to the card, the tail of its capacity filled
there, its property flags scanned there and read back),
``upload_ns / 1e9`` as ``Run.setup_counters`` holds it at the end of
set-up (the first query of a Session uploads every table)."""

from qbench.metrics.append_s import setup_sum


def read(run):
    ns = setup_sum(run, "upload_ns")
    return None if ns is None else ns / 1e9
