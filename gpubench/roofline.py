"""The chip's peaks and the roofline bound of a call.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its
700 W limit): 1,979 TOP/s int8 on the tensor cores and 3.35 TB/s of HBM3.
A call's bound is the larger of its operations over the first and its
bytes over the second, each input counted as read once and each output as
written once; the softmax and GELU chains are left out of the operations.
"""

from __future__ import annotations

from .trace import kernel_name

INT8_OPS = 1979e12
HBM_BYTES = 3.35e12


def bound_s(ops, nbytes):
    return max(ops / INT8_OPS, nbytes / HBM_BYTES)


def reader(kernel_calls, names, anchors):
    """A roofline metric's reader: the bound time of the calls
    ``kernel_calls(blocks)`` gives for one forward, times the profiled
    batches, over the device time of the kernels named ``names``.  It reads
    nothing unless each profiled forward launched one of ``anchors`` for
    each call it counts."""
    names, anchors = frozenset(names), frozenset(anchors)

    def read(run):
        tr = run.trace
        calls = kernel_calls(run.blocks)
        if tr is None or not calls:
            return None
        launched = [kernel_name(o.name) for o in tr.kernels]
        if sum(n in anchors for n in launched) != len(calls) * tr.batches:
            return None
        dev = sum(o.end - o.start for o, n in zip(tr.kernels, launched) if n in names)
        if dev <= 0:
            return None
        return 100.0 * tr.batches * sum(bound_s(o, b) for o, b in calls) / dev

    return read
