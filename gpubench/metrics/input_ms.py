"""Median host time a call of the images' way onto the card and their
quantization (the span ``ivit.input``: ``torch.as_tensor(images).to(dev)``
and the input quant; a pageable host batch's copy lands here), over the
calls of the device-only stretch."""

from gpubench import program_spans as ps

LAYER = "Entry"
UNIT = "ms"
MOVES = "img_per_s"


def read(run):
    return ps.median_ms(run, lambda c: c.covered(lambda n: n == "ivit.input"))
