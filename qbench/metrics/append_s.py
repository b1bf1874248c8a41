"""``append_s``: seconds the program spent in its bulk appends during
set-up: the self time of its ``load.append`` spans (the constraint checks,
the WAL record, the numeric columns' cast or adoption) and of the
``load.dict`` spans inside them (the text columns' encode and dictionary
merge), ``(append_ns + load_dict_ns) / 1e9`` as ``Run.setup_counters``
holds them at the end of set-up.

Also ``setup_sum``, the reading that every metric of the load's counters
shares: None without the counters (a program that does not count its
load), with none of them charged, and without a device trace (a run on
the CPU, where no table goes to a card)."""


def setup_sum(run, *keys):
    """The sum of ``exec.fragment.STATS[key]`` for ``keys`` at the end of
    set-up; or None."""
    vals = [run.setup_counters.get(f"fragment.{k}") for k in keys]
    if run.trace is None or None in vals or not sum(vals):
        return None
    return sum(vals)


def read(run):
    ns = setup_sum(run, "append_ns", "load_dict_ns")
    return None if ns is None else ns / 1e9
