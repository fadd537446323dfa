"""Measurement utilities (counterpart of ``ivit_tpu/utils/benchmarking.py``).

On the card every timing ends in ``torch.cuda.synchronize()`` or is read
from CUDA events, so the clock covers the device's work and not only the
host's launches; on the CPU the host clock is the device clock.
"""

from __future__ import annotations

import time
from typing import Callable


def _sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _device_of(tree):
    import torch
    if isinstance(tree, torch.Tensor):
        return tree.device
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for t in tree:
            dev = _device_of(t)
            if dev is not None:
                return dev
    return None


def time_inloop(step: Callable, carry0, n_iters: int = 50, n_timings: int = 3,
                warmup: int = 1):
    """Time ``step`` (carry -> carry) applied ``n_iters`` times back to back,
    each application taking the last one's output (a data dependency, as
    JAX's ``lax.scan`` carries it).  Returns seconds per application, the
    least over ``n_timings`` timings; on the card from CUDA events."""
    import torch
    dev = _device_of(carry0) or torch.device("cpu")
    cuda = dev.type == "cuda"

    def rep(carry):
        for _ in range(n_iters):
            carry = step(carry)
        return carry

    for _ in range(max(0, warmup)):
        rep(carry0)
    _sync(dev)
    best = float("inf")
    for _ in range(max(1, n_timings)):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            rep(carry0)
            end.record()
            torch.cuda.synchronize(dev)
            secs = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            rep(carry0)
            secs = time.perf_counter() - t0
        best = min(best, secs / n_iters)
    return best


def time_dispatch(fn: Callable, *args, iters: int = 10):
    """Wall-clock seconds per call including the host's dispatch (for
    end-to-end serving numbers): one warm call, then ``iters`` calls, the
    clock stopped after the device has finished them."""
    import torch
    dev = _device_of(list(args)) or torch.device("cpu")
    fn(*args)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    _sync(dev)
    return (time.perf_counter() - t0) / iters


def profile_device_ops(fn: Callable, *args, iters: int = 5):
    """Run ``fn`` ``iters`` times under ``torch.profiler`` (CUDA activity)
    and aggregate the device time by kernel name.

    Returns ``{name: {"us_per_iter", "calls_per_iter"}}`` over the events
    with device time, largest first.  Empty where the profiler reports no
    device time (no card, or no CUPTI): time with CUDA events then.
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    dev = _device_of(list(args)) or torch.device("cuda")
    fn(*args)
    _sync(dev)                           # first-call costs outside the trace
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn(*args)
        _sync(dev)
    agg = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0.0))
        if us > 0:
            agg[evt.key] = {"us_per_iter": us / iters,
                            "calls_per_iter": evt.count / iters}
    return dict(sorted(agg.items(), key=lambda kv: -kv[1]["us_per_iter"]))


def sol_table(ops: dict, flops_by_match: dict, peak_ops_per_sec: float):
    """Speed-of-light utilization per site.

    ``flops_by_match``: {site: (name_substrings, ops_per_iter)} -- an op event
    is charged to every site one of whose substrings its name contains.
    Returns {site: {"us", "tops", "sol"}} plus an ``_unmatched_us`` entry.
    """
    out = {}
    matched_names: set = set()
    for site, (subs, flops) in flops_by_match.items():
        us = 0.0
        for name, rec in ops.items():
            if any(s in name for s in subs):
                us += rec["us_per_iter"]
                matched_names.add(name)
        if us > 0:
            attained = flops / (us * 1e-6)
            out[site] = {"us": round(us, 1),
                         "tops": round(attained / 1e12, 1),
                         "sol": round(attained / peak_ops_per_sec, 3)}
    out["_unmatched_us"] = round(sum(
        rec["us_per_iter"] for name, rec in ops.items()
        if name not in matched_names), 1)
    return out


# Peak rates for speed-of-light accounting, from the H100 SXM data sheet:
# dense int8 tensor-core operations, f32 outside the tensor cores, HBM3
# bytes (per second; JAX's key names).
PEAKS = {
    "h100": {"int8_tops": 1979e12, "f32_flops": 67e12, "hbm_gbps": 3.35e12},
}


def chip_peaks(device=0):
    """The peaks of the card torch reports at ``device``, by its name;
    raises for a card with no entry in :data:`PEAKS`."""
    import torch
    name = torch.cuda.get_device_name(device)
    for key, peaks in PEAKS.items():
        if key in name.lower():
            return dict(peaks)
    raise ValueError(f"no peak rates for {name!r}; known: {sorted(PEAKS)}")
