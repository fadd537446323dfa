"""Median host time a call inside the kernel wrappers (the spans
``ivit.kernel.*``, summed: checks, argument structs, per-call weight
transposes, table and kernel launches; less any wait for the card,
``ivit.sync``, inside them), over the calls of the device-only stretch."""

from gpubench import program_spans as ps

LAYER = "Kernel wrappers"
UNIT = "ms"
MOVES = "img_per_s"


def read(run):
    return ps.median_ms(run, lambda c: c.covered(lambda n: ps.is_kernel(n) or n == ps.SYNC)
                        - c.covered(lambda n: n == ps.SYNC))
