"""Median host time a call of the program's parameter walk (the span
``ivit.params``: ``params_to_torch`` over the whole spec tree on every
call), over the calls of the device-only stretch."""

from gpubench import program_spans as ps

LAYER = "Entry"
UNIT = "ms"
MOVES = "img_per_s"


def read(run):
    return ps.median_ms(run, lambda c: c.covered(lambda n: n == "ivit.params"))
