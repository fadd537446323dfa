"""Calls of ``swin_attn_block`` on the token-order stream (windows read and
written through the kernel's row map, no roll or partition copy around the
call) inside a call (the ``token_order_launches`` attribute of
``ivit.call``: the wrapper's ``token_order_launches`` counter over the
call), the median over the calls of the device-only stretch; none where the
program records no such attribute."""

import statistics

from gpubench import program_spans as ps

LAYER = "Kernel wrappers"
UNIT = "launches"
MOVES = "img_per_s"


def read(run):
    found = ps.calls(run)
    if found is None or not all("token_order_launches" in c.attrs for c in found):
        return None
    return statistics.median(c.attrs["token_order_launches"] for c in found)
