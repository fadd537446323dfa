"""Device kernels launched per forward, counted in the profiled stretch."""

LAYER = "Entry"
UNIT = "launches"
MOVES = "img_per_s"


def read(run):
    tr = run.trace
    if tr is None or not tr.kernels:
        return None
    return len(tr.kernels) / tr.batches
