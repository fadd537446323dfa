"""Median host time a call of the engine's own torch ops outside the kernel
wrappers: the span ``ivit.call`` less its ``ivit.params``, ``ivit.input``,
``ivit.kernel.*`` and ``ivit.sync`` spans (embed, requants, windows,
merges, head, but not the waits for the card), over the calls of the
device-only stretch."""

from gpubench import program_spans as ps

LAYER = "Outside the kernels"
UNIT = "ms"
MOVES = "img_per_s"
LESS = frozenset({"ivit.params", "ivit.input", ps.SYNC})


def read(run):
    return ps.median_ms(run, lambda c: (c.end - c.start)
                        - c.covered(lambda n: n in LESS or ps.is_kernel(n)))
