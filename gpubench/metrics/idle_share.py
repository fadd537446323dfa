"""Share of the unprofiled window's wall time in which the device runs no
kernel and no memory copy: one minus the device's busy time a batch (the
union of its kernel and copy intervals over the profiled batches, traced
without the host's activity) times the window's batches a second.  The
busy time is the device's own and the wall is the unprofiled loop's, so
the profiler's cost to the host does not enter."""

LAYER = "Device"
UNIT = "%"
MOVES = "img_per_s"


def read(run):
    tr = run.trace
    if tr is None or tr.batches <= 0 or not tr.kernels:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.batches * run.img_per_s / run.batch)
