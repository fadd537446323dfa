"""Device idle a batch while the innermost program span open on the host is
Swin's PatchMerging (``ivit.merge``: its LN waits for the card, which then
idles while the host launches the rest of the merge), over the calls of the
device-only stretch (``program_spans.idle_by_span``)."""

from gpubench import program_spans as ps

LAYER = "Device"
UNIT = "ms"
MOVES = "img_per_s"


def read(run):
    return ps.idle_in_ms(run, "ivit.merge")
