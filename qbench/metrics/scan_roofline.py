"""``scan_roofline``: the share (%) of the device's busy time in the
traced passes that reading the queries' columns once at the card's peak
memory bandwidth would take.  Bytes: the live rows of every column a
query names, at the column's width in the source schema, summed over the
queries the traced passes completed correctly.  Peak: ``qbench/peaks.json``
by the card's name.  None without a device trace or a known peak."""

import json
import os

_PEAKS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "peaks.json")


def read(run):
    with open(_PEAKS) as f:
        peak = json.load(f).get(run.device_kind)
    if run.trace is None or peak is None or run.trace.busy_s <= 0:
        return None
    done = [a for a in run.answers if a.traced and a.ok]
    if not done:
        return None
    need_s = sum(run.query_bytes(a.qid) for a in done) / \
        float(peak["hbm_bytes_per_s"])
    return 100.0 * need_s / run.trace.busy_s
