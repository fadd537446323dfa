"""One run of one cell: set-up, the measured window, the traced stretch,
the check against the plain reference, and the result line.

The loop is closed with one batch in flight, as an offline user classifies:
take the next batch from the feed (a fresh tensor of seeded images, see
:class:`Feed`), call ``Engine(spec)`` on it, bring the logits to the host.
The clock is the host's.  The window runs for ``seconds`` and ends at the
last batch's logits; everything before it is set-up.  With ``trace`` a
fixed number of batches follows under ``torch.profiler``, and the
per-layer metrics are read from it.

Once the window has closed and the peak memory is read, the program's state
is freed and the plain reference recomputes, on the same device, a few
batches drawn from the seed among all the window's batches, from their
images; every logit of those batches is compared with the reference's,
exactly.
"""

from __future__ import annotations

import dataclasses
import gc
import os
import random
import statistics
import subprocess
import sys
import time

import numpy as np

from . import cells, program, specmaker
from . import trace as tr
from .reference.common import tensors

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ivit_tpu")


class NoDevice(RuntimeError):
    """No card, or fewer than the cell asks for."""


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name, the part before the first dot,
    is one of :data:`FORBIDDEN`, compared whole: ``ivit_tpu_torch`` is not
    ``ivit_tpu``."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


@dataclasses.dataclass
class Run:
    """What one run measured, as the per-layer readers see it: a reader
    added later finds here everything a cell's run knows (the
    configuration with the spec maker's flags, the traffic, each block's
    shapes), since the harness cannot be edited for it."""

    cfg: dict
    traffic: dict
    batch: int
    blocks: list
    macs_per_image: int
    img_per_s: float
    enqueue_s: list
    trace: object = None           # trace.Trace of the profiled stretch
    profiled_img_per_s: float = 0.0


def _percentile(values, q):
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


# torch's intra-op threads: a fixed count, whatever the machine's cores
HOST_THREADS = 2


def card_line():
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30, check=True).stdout.strip()
        return out.splitlines()[0] if out else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def _seed_int(seed):
    return int(seed) % 2**63


def _make_images(torch, traffic, cfg, seed, dev):
    """The pool of distinct batches, drawn from the seed on the device."""
    g = torch.Generator(device=dev).manual_seed(_seed_int(seed))
    s = cfg["img_size"]
    return torch.randn((traffic["pool_batches"], traffic["batch"], s, s, 3),
                       generator=g, device=dev, dtype=torch.float32)


class Feed:
    """The batches the loop hands the program, as a loader hands them: each
    holds ``batch`` images gathered from the pool by indices drawn from the
    seed, so no batch repeats the images of an earlier one in the same
    storage.  ``images_on`` "device": a fresh tensor gathered on the card,
    in the loop's own thread; "host": pageable CPU tensors, a ring of
    ``RING`` reused as a loader reuses its buffers, each refilled by one
    loader thread while the program reads another.  ``next()`` gives
    (indices into the pool, images); the images stay valid until the next
    call."""

    RING = 3

    def __init__(self, torch, pool, traffic, seed, dev):
        self.torch, self.batch = torch, traffic["batch"]
        self.pool = pool.reshape((-1,) + tuple(pool.shape[2:]))
        self.gen = torch.Generator(device=self.pool.device).manual_seed(
            _seed_int(seed) ^ 0x5EED)
        self.thread = None
        if traffic["images_on"] == "host":
            import queue
            import threading

            shape = (self.batch,) + tuple(self.pool.shape[1:])
            self.ring = [torch.zeros(shape, dtype=self.pool.dtype) for _ in range(self.RING)]
            self.free, self.ready = queue.Queue(), queue.Queue()
            for i in range(self.RING):
                self.free.put(i)
            self.held, self.stop = None, threading.Event()
            self.thread = threading.Thread(target=self._load, daemon=True)
            self.thread.start()

    def _indices(self):
        return self.torch.randint(0, self.pool.shape[0], (self.batch,), generator=self.gen,
                                  device=self.pool.device)

    def _load(self):
        import queue

        while not self.stop.is_set():
            try:
                i = self.free.get(timeout=0.1)
            except queue.Empty:
                continue
            idx = self._indices()
            self.torch.index_select(self.pool, 0, idx, out=self.ring[i])
            self.ready.put((idx, i))

    def next(self):
        if self.thread is None:
            idx = self._indices()
            return idx, self.pool.index_select(0, idx)
        if self.held is not None:
            self.free.put(self.held)
        idx, self.held = self.ready.get()
        return idx, self.ring[self.held]

    def images(self, idx, dev):
        """The pool's images at ``idx``, on ``dev`` (for the reference)."""
        return self.pool.index_select(0, idx.to(self.pool.device)).to(dev)

    def close(self):
        if self.thread is not None:
            self.stop.set()
            self.thread.join()
            self.thread = None


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _gap(torch, got, want, head_scale):
    """Largest |program - reference| of a batch's logits in units of the
    head's accumulator LSB (its per-class scale); inf where a logit is not
    finite or the shapes differ; and the number of images with a logit
    that differs."""
    if tuple(got.shape) != tuple(want.shape):
        return float("inf"), want.shape[0]
    d = (got.double() - want.double()).abs() / head_scale.double()
    d = torch.where(torch.isfinite(got.double()), d, torch.full_like(d, float("inf")))
    return float(d.max()), int((d != 0).any(dim=-1).sum())


def run_cell(name, seed, seconds, trace=False, *, device="cuda", overrides=None,
             wrap_engine=None, t0=None, root=cells.ROOT, log=sys.stderr):
    """Run the cell ``name`` once; returns the result dict (``checks``
    last).  ``overrides``: ``{"config": {...}, "traffic": {...}}`` merged
    into the cell's files (the CPU tests' cut sizes); ``wrap_engine``: a
    function of the built engine returning the callable to time (the
    tests' planted faults)."""
    t0 = time.perf_counter() if t0 is None else t0
    work, cfg, traffic = cells.cell(name, root)
    overrides = overrides or {}
    cfg = {**cfg, **overrides.get("config", {})}
    traffic = {**traffic, **overrides.get("traffic", {})}
    for k in program.PROGRAM_SWITCHES:
        os.environ.pop(k, None)

    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise NoDevice("torch.cuda.is_available() is false")
        if torch.cuda.device_count() < work["chips"]:
            raise NoDevice(f"{torch.cuda.device_count()} card(s); the cell asks "
                           f"for {work['chips']}")
        torch.cuda.reset_peak_memory_stats(dev)

    torch.set_num_threads(HOST_THREADS)
    spec_cfg, params = specmaker.make(cfg, seed)
    ref_mod = cells.reference(cfg)
    B = traffic["batch"]
    pool = _make_images(torch, traffic, cfg, seed, dev)
    if traffic["images_on"] == "host":
        pool = pool.cpu()
    feed = Feed(torch, pool, traffic, seed, dev)
    try:
        engine = program.build(spec_cfg, params, dev)
        call = wrap_engine(engine) if wrap_engine else engine
        for _ in range(traffic["warmup_calls"]):
            call(feed.next()[1]).cpu()
        _sync(torch, dev)
        gc.collect()
        gc.freeze()
        setup_s = time.perf_counter() - t0

        # --- the measured window ---------------------------------------------
        rng = random.Random(_seed_int(seed))
        k_check = traffic["check_batches"]
        sample = []                  # [(ordinal, pool indices, host logits)]
        lat, enq, ends = [], [], []
        n = 0
        start = time.perf_counter()
        end_at = start + seconds
        now = start
        while now < end_at:
            idx, x = feed.next()
            t_call = time.perf_counter()
            out = call(x)
            t_ret = time.perf_counter()
            host = out.cpu()
            now = time.perf_counter()
            lat.append(now - t_call)
            enq.append(t_ret - t_call)
            ends.append(now - start)
            # k_check batches drawn uniformly from all the window's (reservoir)
            if n < k_check:
                sample.append((n, idx, host))
            elif (j := rng.randrange(n + 1)) < k_check:
                sample[j] = (n, idx, host)
            n += 1
            del x, out
        window_s = now - start
        img_per_s = n * B / window_s
        memory_peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0

        run = Run(cfg=spec_cfg, traffic=traffic, batch=B,
                  blocks=ref_mod.blocks(spec_cfg, B),
                  macs_per_image=ref_mod.macs_per_image(spec_cfg),
                  img_per_s=img_per_s, enqueue_s=enq)
        labels = None
        if trace:
            run.trace, labels, run.profiled_img_per_s = _traced(
                torch, call, feed, traffic["trace_batches"], B, dev)
        path = program.path_report(engine)
        del call, engine
    finally:
        feed.close()
    gc.unfreeze()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # --- the check against the plain reference --------------------------------
    t_check = time.perf_counter()
    p_ref = tensors(params, dev)
    rows = traffic["check_rows_per_block"]
    worst, failed, checked = 0.0, 0, 0
    for _, idx, host in sorted(sample, key=lambda item: item[0]):
        x = feed.images(idx, dev)
        with torch.no_grad():
            want = torch.cat([ref_mod.forward(spec_cfg, p_ref, x[i:i + rows]).cpu()
                              for i in range(0, B, rows)])
        g, bad = _gap(torch, host, want, p_ref["head_scale"].cpu())
        worst, failed, checked = max(worst, g), failed + bad, checked + B
    check_s = time.perf_counter() - t_check
    correct = worst == 0.0 and checked > 0

    metrics = {}
    if trace:
        for m in cells.cell_metrics(name, "per_layer", root):
            value = cells.metric(m["name"], root).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        values = {"img_per_s": img_per_s, "batch_p95_ms": _percentile(lat, 95) * 1e3,
                  "setup_s": setup_s}
        for m in cells.cell_metrics(name, "end_to_end", root):
            # "<quantity>.<cells>": the quantity under a bound of its own
            value = values[m["name"].split(".")[0]]
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": work["chips"], "memory_peak_bytes": memory_peak}
    result = {"correct": bool(correct), "attempted": n * B,
              "failed": failed, "metrics": metrics,
              "device": device_info}
    if trace and run.trace is not None:
        device_info["busy_s"] = run.trace.busy_s()
        device_info["window_s"] = run.trace.window_s
        result["breakdown"] = tr.breakdown(run.trace, labels)
    card = card_line() if dev.type == "cuda" else "cpu"
    result["card"] = card
    result["checks"] = {"max_logit_gap_lsb": {"value": worst, "limit": 0.0}}

    print(f"cell {name} seed {seed}: path {path}", file=log)
    print(f"card {card}; setup_s {setup_s:.4f}; window {window_s:.4f} s, "
          f"{n} batches of {B}; torch threads {torch.get_num_threads()}", file=log)
    quarters = [int(np.searchsorted(ends, window_s * q / 4, side="right")) for q in range(5)]
    rates = [(b - a) * B / (window_s / 4) for a, b in zip(quarters, quarters[1:])]
    print("img/s by quarter of the window: " + ", ".join(f"{r:.1f}" for r in rates), file=log)
    print(f"batch latency ms: median {statistics.median(lat) * 1e3:.4f}, "
          f"p95 {_percentile(lat, 95) * 1e3:.4f}, samples {len(lat)}; "
          f"enqueue median {statistics.median(enq) * 1e3:.4f}", file=log)
    if trace and run.trace is not None:
        print(f"profiled {run.trace.batches} batches: {run.profiled_img_per_s:.4f} img/s "
              f"under the device-only profiler against {img_per_s:.4f} without", file=log)
    print(f"reference check of {len(sample)} batches {sorted(v[0] for v in sample)}, "
          f"{checked} images, took {check_s:.4f} s; {failed} images differ", file=log)
    print(f"check max_logit_gap_lsb {worst} limit 0", file=log)
    return result


def _traced(torch, call, feed, k, batch, dev):
    """``k`` whole batches, drawn before the profiler starts, twice under
    ``torch.profiler``: first with the device's activity alone (its
    kernels, copies and busy time, at little cost to the host), then with
    the host's operations and the harness's spans too, whose gaps are only
    labelled.  Returns (the device trace, the labelled trace, img/s over
    the first stretch)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = dev.type == "cuda"
    inputs = [feed.next()[1].clone() for _ in range(k)]
    _sync(torch, dev)
    with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
        start = time.perf_counter()
        for x in inputs:
            call(x).cpu()
        stretch = time.perf_counter() - start
    device = tr.from_profiler(prof, k, wall=stretch)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    _sync(torch, dev)
    with profile(activities=acts) as prof:
        for x in inputs:
            with record_function(tr.SPAN_PREFIX + "batch"):
                with record_function(tr.SPAN_PREFIX + "call"):
                    out = call(x)
                with record_function(tr.SPAN_PREFIX + "to_host"):
                    out.cpu()
    return device, tr.from_profiler(prof, k), k * batch / stretch
