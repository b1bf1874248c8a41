"""``upload_link_share``: the upload's copies as a percentage of the host
link's peak, the roofline of the load's device-facing work: the bytes the
``load.upload`` spans copied to the device over the copies' own time,
``upload_bytes / (upload_copy_ns / 1e9)``, over ``LINK_PEAK``, as
``Run.setup_counters`` holds them at the end of set-up.  The program
times each host-to-device copy alone, by CUDA events around it; the flag
scans and the tail fills of the same span are not in that time."""

from qbench.metrics.append_s import setup_sum

#: bytes/s one direction of PCI Express 5.0 x16, the H100's host link:
#: 32 GT/s a lane x 16 lanes x 128/130 (encoding) / 8 bits = 63.0 GB/s
#: (PCI-SIG, PCI Express Base Specification, Revision 5.0, 2019)
LINK_PEAK = 63.0e9


def read(run):
    ns = setup_sum(run, "upload_copy_ns")
    nbytes = setup_sum(run, "upload_bytes")
    if ns is None or nbytes is None:
        return None
    return 100.0 * nbytes / (ns / 1e9) / LINK_PEAK
