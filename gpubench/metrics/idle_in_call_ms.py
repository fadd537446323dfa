"""Device idle a batch that lies inside the program's calls: the idle gaps
of the device-only stretch (no kernel and no copy running) intersected
with the intervals of its ``ivit.call`` spans, over its batches.  The card
waiting on the program's own enqueue, not on the loop's turnaround."""

from gpubench import program_spans as ps

LAYER = "Device"
UNIT = "ms"
MOVES = "img_per_s"


def read(run):
    found = ps.calls(run)
    if found is None:
        return None
    idle = sum(max(0.0, min(e, c.end) - max(s, c.start))
               for s, e in run.trace.idle_gaps() for c in found)
    return idle / run.trace.batches * 1e3
