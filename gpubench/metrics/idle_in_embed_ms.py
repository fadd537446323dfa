"""Device idle a batch while the innermost program span open on the host is
the patch embedding (``ivit.embed``; on Swin its patch norm waits for the
card, which then idles while the host launches the rest), over the calls of
the device-only stretch (``program_spans.idle_by_span``)."""

from gpubench import program_spans as ps

LAYER = "Device"
UNIT = "ms"
MOVES = "img_per_s"


def read(run):
    return ps.idle_in_ms(run, "ivit.embed")
