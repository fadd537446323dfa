"""The program's own spans of a traced run, by ``Engine`` call.

The program (``ivit_tpu_torch.utils.spans``) records spans only while a
``torch.profiler`` records, in its own process, stamped with
``time.time_ns()``, the clock the profiler stamps its events with.  So
after a traced run its buffer holds the spans of the two profiled
stretches and nothing else.  This module reads that buffer from the module
the program loaded (it imports nothing of the program, and builds and
calls nothing: where the program keeps no spans, as before it had any,
there is nothing to read) and keeps the calls of the device-only stretch:
those whose ``ivit.call`` span ends inside ``run.trace.window``.  No span
exists before that window, and the labelled stretch starts after it.

:func:`idle_by_span` gives the device's idle time inside those calls by the
innermost program span open on the host meanwhile: which stretch of the
program the card waited on.
"""

from __future__ import annotations

import dataclasses
import statistics
import sys

MODULE = "ivit_tpu_torch.utils.spans"
ROOT = "ivit.call"
KERNEL_PREFIX = "ivit.kernel."
SYNC = "ivit.sync"


@dataclasses.dataclass
class Call:
    start: float       # seconds, in the trace's clock
    end: float
    spans: list        # [(name, start, end)] of every span below the root, as opened
    attrs: dict        # the root's attributes

    def covered(self, keep) -> float:
        """Seconds of the call covered by its spans whose name ``keep``
        accepts: the union of their intervals, so nested spans count once."""
        total, reach = 0.0, float("-inf")
        for s, e in sorted((s, e) for n, s, e in self.spans if keep(n)):
            if e > reach:
                total += e - max(s, reach)
                reach = e
        return total


def records():
    """The program's recorded spans, or None where it has loaded no spans
    module."""
    mod = sys.modules.get(MODULE)
    return None if mod is None else mod.spans()


def calls(run):
    """The ``Engine`` calls of the device-only stretch, in order, or None
    unless exactly one is found for each of its profiled batches."""
    tr = run.trace
    recs = records()
    if tr is None or not recs:
        return None
    lo, hi = tr.window
    found = {}
    for r in recs:
        if r.name == ROOT and r.parent is None and r.end_ns is not None \
                and lo <= r.end_ns * 1e-9 <= hi:
            found[r.call] = Call(r.start_ns * 1e-9, r.end_ns * 1e-9, [], dict(r.attrs))
    if len(found) != tr.batches:
        return None
    for r in recs:
        if r.call in found and r.parent is not None and r.end_ns is not None:
            found[r.call].spans.append((r.name, r.start_ns * 1e-9, r.end_ns * 1e-9))
    return [found[c] for c in sorted(found)]


def median_ms(run, per_call):
    """The median over the stretch's calls of ``per_call(call)`` seconds, in
    ms; None where :func:`calls` finds none."""
    found = calls(run)
    if found is None:
        return None
    return statistics.median(per_call(c) for c in found) * 1e3


def is_kernel(name) -> bool:
    return name.startswith(KERNEL_PREFIX)


def idle_by_span(run):
    """The device's idle time a batch inside the stretch's calls, in ms, by
    the innermost span open on the host meanwhile (``ROOT`` where none
    below it is): ``{name: ms}``; None where :func:`calls` finds none."""
    found = calls(run)
    if found is None:
        return None
    out = {}
    gaps = run.trace.idle_gaps()
    for c in found:
        for gs, ge in gaps:
            lo, hi = max(gs, c.start), min(ge, c.end)
            if hi <= lo:
                continue
            cuts = sorted({lo, hi} | {t for _, s, e in c.spans for t in (s, e)
                                      if lo < t < hi})
            for a, b in zip(cuts, cuts[1:]):
                mid = (a + b) / 2
                # spans nest on the host's thread: the last opened that is
                # still open is the innermost
                name = next((n for n, s, e in reversed(c.spans) if s <= mid < e), ROOT)
                out[name] = out.get(name, 0.0) + b - a
    return {n: v / run.trace.batches * 1e3 for n, v in out.items()}


def idle_in_ms(run, name):
    """:func:`idle_by_span`'s time for the span ``name``, 0 where it was
    open with the card busy; None where no call has that span."""
    found = calls(run)
    if found is None or not any(n == name for c in found for n, _, _ in c.spans):
        return None
    return idle_by_span(run).get(name, 0.0)
