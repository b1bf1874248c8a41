"""``warmup_s``: seconds, by the benchmark's host clock, of the mix's
warm-up passes before the window: first lowerings, extension loads, the
Session's first table uploads and the dictionaries' byte heaps.  One phase
of ``setup_s``."""


def read(run):
    return run.setup.get("warmup_s")
