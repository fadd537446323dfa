"""The profiled stretch of a traced run, reduced to what the per-layer
metrics read: device operations with their times, the host's spans and
operations, the window, and the busy and idle time of the device.

The trace comes from ``torch.profiler`` (CUPTI) over a fixed number of
whole batches: the device's activity alone for what the device did, and a
second stretch with the host's operations for what the host was doing in
the device's idle gaps.  The device is busy where any kernel or memory copy runs:
the union of their intervals, so overlapping work counts once.
"""

from __future__ import annotations

import dataclasses

SPAN_PREFIX = "gpubench."


@dataclasses.dataclass
class Op:
    name: str
    start: float      # seconds, in the trace's own clock
    end: float


@dataclasses.dataclass
class Trace:
    kernels: list      # device kernels
    copies: list       # device memory copies and sets
    host: list         # host operations and the harness's spans
    window: tuple      # (start, end) of the profiled batches, seconds
    batches: int

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_intervals(self):
        """Union of the device's kernel and copy intervals inside the window."""
        lo, hi = self.window
        spans = sorted((max(o.start, lo), min(o.end, hi))
                       for o in self.kernels + self.copies if o.end > lo and o.start < hi)
        merged = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def idle_gaps(self):
        """[(start, end)] of the window where the device runs nothing."""
        gaps, t = [], self.window[0]
        for s, e in self.busy_intervals():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if self.window[1] > t:
            gaps.append((t, self.window[1]))
        return gaps

    def host_label(self, t):
        """What the host was doing at ``t``: the innermost host operation or
        harness span open then."""
        open_ = [o for o in self.host if o.start <= t < o.end]
        if not open_:
            return "host: outside any span"
        return min(open_, key=lambda o: o.end - o.start).name


def kernel_name(raw: str) -> str:
    """The identifier of a device kernel's (demangled) name: ``void
    ns::foo_kernel<8, 2>(int*, ...)`` -> ``foo_kernel``."""
    head = raw.replace("(anonymous namespace)::", "")
    head = head.split("(")[0].split("<")[0].strip()
    head = head.split()[-1] if head.split() else raw
    return head.split("::")[-1] or raw


def _event_fields(e):
    name = e.name()
    dev = str(e.device_type()).rsplit(".", 1)[-1].upper()
    start = e.start_ns() * 1e-9
    end = (e.end_ns() if hasattr(e, "end_ns") else e.start_ns() + e.duration_ns()) * 1e-9
    return name, dev, start, end


def from_profiler(prof, batches, wall=None) -> Trace:
    """Reduce a finished ``torch.profiler.profile`` to a :class:`Trace`.  Its
    window is the span of the ``gpubench.batch`` spans or, for a stretch
    traced without the host's activity, ``wall`` seconds of the host's clock
    from the first device operation."""
    kernels, copies, host = [], [], []
    for e in prof.profiler.kineto_results.events():
        name, dev, start, end = _event_fields(e)
        kind = str(e.activity_type()) if hasattr(e, "activity_type") else ""
        if dev == "CUDA" and (name.startswith(SPAN_PREFIX) or "annotation" in kind):
            continue            # a host span projected onto the device's timeline
        if dev == "CUDA":
            low = name.lower()
            (copies if low.startswith(("memcpy", "memset")) else kernels).append(
                Op(name, start, end))
        elif dev == "CPU":
            host.append(Op(name, start, end))
    batch_spans = [o for o in host if o.name == SPAN_PREFIX + "batch"]
    if batch_spans:
        window = (min(o.start for o in batch_spans), max(o.end for o in batch_spans))
    elif wall is not None:
        first = min((o.start for o in kernels + copies), default=0.0)
        window = (first, first + wall)
    else:
        raise RuntimeError("the profiled stretch holds no gpubench.batch span")
    return Trace(kernels, copies, host, window, batches)


def breakdown(trace: Trace, labels: Trace = None, top=10) -> dict:
    """The device operations that took most time (``trace``) and the longest
    idle gaps, each named by what the host was doing (``labels``, a trace
    with the host's spans; ``trace`` itself where none is given), in
    seconds as measured."""
    by_name = {}
    for ops, name in ((trace.kernels, kernel_name), (trace.copies, str)):
        for o in ops:
            key = name(o.name)
            by_name[key] = by_name.get(key, 0.0) + (o.end - o.start)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    labels = trace if labels is None else labels
    gaps = sorted(labels.idle_gaps(), key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[labels.host_label(s), e - s] for s, e in gaps]}
