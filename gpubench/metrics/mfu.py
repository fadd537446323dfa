"""The whole forward's share of the chip's int8 peak: two operations for
each multiply-accumulate of every matrix product of one image's forward
(counted from the configuration's shapes, whatever precision the program
computes it in), times the img/s of the run's unprofiled window, over
1,979 TOP/s."""

from gpubench.roofline import INT8_OPS

LAYER = "Model step"
UNIT = "%"
MOVES = "img_per_s"


def read(run):
    if run.trace is None or not run.trace.kernels:
        return None
    return 100.0 * 2 * run.macs_per_image * run.img_per_s / INT8_OPS
