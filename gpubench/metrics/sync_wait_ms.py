"""Median host time a call spent waiting for the card (the spans
``ivit.sync``: a host scalar made a device tensor, a pageable copy after
which torch waits for the stream, so for every kernel queued before it),
summed over the call, over the calls of the device-only stretch."""

from gpubench import program_spans as ps

LAYER = "Outside the kernels"
UNIT = "ms"
MOVES = "img_per_s"


def read(run):
    return ps.median_ms(run, lambda c: c.covered(lambda n: n == ps.SYNC))
