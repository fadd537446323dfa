"""Weight transposes the kernel wrappers make inside a call (the
``transposes`` attribute of ``ivit.call``: the wrappers' ``transposes``
counters over the call), the median over the calls of the device-only
stretch; none where the program records no such attribute."""

import statistics

from gpubench import program_spans as ps

LAYER = "Kernel wrappers"
UNIT = "transposes"
MOVES = "img_per_s"


def read(run):
    found = ps.calls(run)
    if found is None or not all("transposes" in c.attrs for c in found):
        return None
    return statistics.median(c.attrs["transposes"] for c in found)
