"""Calls of ``swin_attn_block`` that ran its split-key window core (windows
of more than 64 tokens) inside a call (the ``wide_launches`` attribute of
``ivit.call``: the wrapper's ``wide_launches`` counter over the call), the
median over the calls of the device-only stretch; none where the program
records no such attribute."""

import statistics

from gpubench import program_spans as ps

LAYER = "Kernel wrappers"
UNIT = "launches"
MOVES = "img_per_s"


def read(run):
    found = ps.calls(run)
    if found is None or not all("wide_launches" in c.attrs for c in found):
        return None
    return statistics.median(c.attrs["wide_launches"] for c in found)
