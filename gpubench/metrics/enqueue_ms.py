"""Median host time of the ``Engine`` call until it returns, before the
harness waits for the logits: the harness's own span around the call, over
the unprofiled window."""

import statistics

LAYER = "Entry"
UNIT = "ms"
MOVES = "img_per_s"


def read(run):
    return statistics.median(run.enqueue_s) * 1e3 if run.enqueue_s else None
