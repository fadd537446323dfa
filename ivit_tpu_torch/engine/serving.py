"""Serving loop: continuous batching over the integer engine (counterpart
of ``ivit_tpu/engine/serving.py``).

A request queue with an atomic admission bound, a batcher thread that
assembles fixed-size batches (padding the tail after ``max_wait_ms``),
sheds requests older than ``deadline_ms`` at batch assembly, keeps up to
``inflight`` batches on the card, and resolves each request's future with
its logits.  :class:`~ivit_tpu_torch.engine.vit_int.Engine` runs the batch
(ViT or Swin by the spec's type, on the fused kernels by default).

On the card, where JAX has asynchronous dispatch, the batcher runs on the
stream that was current in the thread that built the server (the one the
engine's parameters were moved on; the kernel wrappers launch on the
current stream), copies each batch through a ring of ``inflight`` pinned
host buffers with ``non_blocking`` copies, records one CUDA event after a
batch's logits are copied back, reuses a buffer only after its event has
completed, and resolves a batch by waiting on its event alone.

Data-parallel serving (JAX's ``mesh`` / ``devices``, one process, as in
JAX): ``devices=`` builds ``make_mesh(dp=len(devices), tp=1)``, and one
``Engine`` replica runs on the first device of each data row of the mesh,
the parameters copied to it once.  The padded batch is split over the
replicas (``batch_size % dp`` raises, as JAX's batch sharding does); each
slice is launched on its device's current stream (the one current when
the server was built) through its slice of the slot's pinned buffers,
with an event a replica, and the logits come back in batch order.  A mesh
with ``tp > 1`` serves as JAX's does: parameters replicated, the batch
over the data axis.  Devices may repeat (``["cuda:0", "cuda:0"]``, or
``["cpu"] * 4``): two replicas then share a card.
"""

from __future__ import annotations

import collections
import contextlib
import queue as queue_mod
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..parallel.mesh import make_mesh
from .vit_int import Engine


def _settle(fut: Future, result=None, exc: Optional[BaseException] = None):
    """Resolve a request's future unless its client cancelled it."""
    try:
        if exc is None:
            fut.set_result(result)
        else:
            fut.set_exception(exc)
    except InvalidStateError:
        pass


class ServingMetrics:
    """Request and batch counts and latencies (ms, submit to result)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.latencies_ms: list = []
        self.batches = 0
        self.images = 0
        self.rejected = 0
        self.shed_count = 0
        self.started = time.perf_counter()

    def reject(self):
        with self.lock:
            self.rejected += 1

    def shed(self):
        with self.lock:
            self.shed_count += 1

    def record(self, batch_size: int, latencies_ms: Sequence[float]):
        with self.lock:
            self.batches += 1
            self.images += batch_size
            self.latencies_ms.extend(latencies_ms)
            if len(self.latencies_ms) > 100000:
                self.latencies_ms = self.latencies_ms[-50000:]

    def summary(self) -> dict:
        with self.lock:
            lat = np.asarray(self.latencies_ms) if self.latencies_ms else np.zeros(1)
            elapsed = time.perf_counter() - self.started
            return {
                "images": self.images,
                "batches": self.batches,
                "images_per_sec": self.images / max(elapsed, 1e-9),
                "latency_ms_p50": float(np.percentile(lat, 50)),
                "latency_ms_p95": float(np.percentile(lat, 95)),
                "latency_ms_p99": float(np.percentile(lat, 99)),
                "latency_ms_max": float(lat.max()),
                "rejected": self.rejected,
                "shed": self.shed_count,
            }


class QueueFull(RuntimeError):
    """Admission control: the serving queue is at ``max_queue``."""


class DeadlineExceeded(RuntimeError):
    """The request waited longer than ``deadline_ms`` before batching."""


class ServingEngine:
    """Continuous-batching server over a frozen integer engine spec.

    ``submit(image) -> Future[logits]`` (an [H, W, 3] float32 image; numpy
    logits [classes]).  ``device``: where the engine runs (default
    ``cuda``; raises without a card unless ``"cpu"``); ``kernels``: the
    engine path, as ``Engine`` takes it (JAX's ``pallas``), but ``None``
    is the fused kernels, as JAX's server hands ``pallas=None`` to
    ``engine_forward`` and not to the dispatch table.  ``max_queue``
    bounds the requests waiting to be batched (over it, ``submit`` raises
    :class:`QueueFull`); ``deadline_ms`` sheds a request that waited longer
    before batching (its future raises :class:`DeadlineExceeded`).
    ``mesh`` (a mesh of devices, ``parallel.make_mesh(..., devices=)``) or
    ``devices``: data-parallel replicas, one a data row (``device`` is
    then the first one's).
    """

    def __init__(self, spec, batch_size: int = 64, max_wait_ms: float = 5.0,
                 inflight: int = 2, device=None, kernels=True,
                 max_queue: Optional[int] = None,
                 deadline_ms: Optional[float] = None, mesh=None, devices=None):
        if mesh is None and devices is not None:
            mesh = make_mesh(dp=len(devices), tp=1, devices=devices)
        if mesh is not None:
            if mesh.distributed:
                raise ValueError("ServingEngine runs in one process: give it a "
                                 "mesh of devices (make_mesh(..., devices=))")
            if batch_size % mesh.dp:
                raise ValueError(f"batch_size {batch_size} is not divisible by "
                                 f"the mesh's data axis, dp={mesh.dp}")
            replicas = [resolve_device(mesh.devices[i, 0]) for i in range(mesh.dp)]
        else:
            replicas = [resolve_device(device)]
        self.mesh = mesh
        self.device = replicas[0]
        kernels = True if kernels is None else kernels
        self.engines = [Engine(spec, device=d, kernels=kernels) for d in replicas]
        self.engine = self.engines[0]
        self.spec = spec
        self.batch_size = batch_size
        self.max_wait_ms = max_wait_ms
        self.inflight = max(1, inflight)
        self.max_queue = max_queue
        self.deadline_ms = deadline_ms
        self.metrics = ServingMetrics()
        # Queue(maxsize) makes the bound atomic: put_nowait either takes a
        # slot or raises queue.Full (a qsize() check before put would race)
        self._queue: queue_mod.Queue = queue_mod.Queue(maxsize=max_queue or 0)
        self._stop = threading.Event()
        self._closing = threading.Lock()     # submit's check-then-put vs close
        # replica 0's forward (a test replaces it to inject a failure)
        self._fwd = self.engine
        img = spec.config.img_size
        self._img_shape = (img, img, 3)
        cuda = self.device.type == "cuda"
        shape_in = (batch_size,) + self._img_shape
        shape_out = (batch_size, spec.config.num_classes)
        self._host_in = [torch.zeros(shape_in, pin_memory=cuda) for _ in range(self.inflight)]
        self._host_out = [torch.zeros(shape_out, pin_memory=cuda)
                          for _ in range(self.inflight)]
        # an event a slot and a replica; each replica's device's stream
        self._events = [[torch.cuda.Event() if d.type == "cuda" else None
                         for d in replicas] for _ in range(self.inflight)]
        self._streams = [torch.cuda.current_stream(d) if d.type == "cuda" else None
                         for d in replicas]
        self._batcher = threading.Thread(target=self._run, daemon=True)
        self._batcher.start()

    # -- client API ---------------------------------------------------------

    def submit(self, image) -> Future:
        """Enqueue one [H, W, 3] float32 image; resolves to logits [C].
        Raises :class:`QueueFull` when the queue is at ``max_queue``."""
        image = np.asarray(image, dtype=np.float32)
        if image.shape != self._img_shape:
            raise ValueError(f"expected {self._img_shape}, got {image.shape}")
        fut: Future = Future()
        with self._closing:
            if self._stop.is_set():
                raise RuntimeError("ServingEngine closed")
            try:
                self._queue.put_nowait((image, fut, time.perf_counter()))
            except queue_mod.Full:
                self.metrics.reject()
                raise QueueFull(f"serving queue at max_queue={self.max_queue}") from None
        return fut

    def infer(self, images) -> np.ndarray:
        """Synchronous batch API."""
        futs = [self.submit(im) for im in images]
        return np.stack([f.result() for f in futs])

    def close(self):
        """Stop the batcher; no future is left unresolved.  In-flight
        batches are resolved by the batcher as it exits; requests still
        queued (and any submitted after) fail with ``RuntimeError``."""
        with self._closing:
            self._stop.set()
        self._batcher.join(timeout=60)
        self._drain_queue(RuntimeError("ServingEngine closed"))

    def _drain_queue(self, exc: BaseException):
        while True:
            try:
                _, fut, _ = self._queue.get_nowait()
            except queue_mod.Empty:
                return
            if not fut.cancel():
                _settle(fut, exc=exc)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- batcher ------------------------------------------------------------

    def _admit(self, item) -> bool:
        """Deadline check at batch assembly; sheds stale requests."""
        if self.deadline_ms is None:
            return True
        _, fut, t0 = item
        if (time.perf_counter() - t0) * 1e3 <= self.deadline_ms:
            return True
        self.metrics.shed()
        _settle(fut, exc=DeadlineExceeded(
            f"request older than deadline_ms={self.deadline_ms}"))
        return False

    def _collect(self):
        """Block for the first request, then fill up to ``batch_size`` or
        ``max_wait_ms``; requests past ``deadline_ms`` are shed."""
        items: list = []
        while not items:
            try:
                first = self._queue.get(timeout=0.1)
            except queue_mod.Empty:
                return None
            if self._admit(first):
                items.append(first)
        deadline = time.perf_counter() + self.max_wait_ms / 1e3
        while len(items) < self.batch_size:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                item = self._queue.get(timeout=remaining)
            except queue_mod.Empty:
                break
            if self._admit(item):
                items.append(item)
        return items

    def _run(self):
        self._loop()

    def _loop(self):
        pending: collections.deque = collections.deque()
        slot = 0
        try:
            while not self._stop.is_set():
                items = self._collect()
                if items is None:
                    while pending:
                        self._resolve(*pending.popleft())
                    continue
                try:
                    self._dispatch(slot, items)
                except Exception as exc:        # fail this batch, keep serving
                    for _, fut, _ in items:
                        _settle(fut, exc=exc)
                    continue
                pending.append((slot, items))
                slot = (slot + 1) % self.inflight
                while len(pending) >= self.inflight:
                    self._resolve(*pending.popleft())
            while pending:
                self._resolve(*pending.popleft())
        except BaseException as exc:
            # the batcher died: fail every stranded future, in flight and
            # queued, so that no client blocks forever
            for _, items in pending:
                for _, fut, _ in items:
                    _settle(fut, exc=exc)
            self._drain_queue(exc)
            raise

    def _dispatch(self, slot, items):
        """Stage a batch in the slot's pinned buffer, run each replica on
        its slice on its device's stream and queue the copy of its logits
        back; nothing here waits for the card but the slot's previous batch
        (already resolved, so a no-op)."""
        events, host = self._events[slot], self._host_in[slot]
        for event in events:
            if event is not None:
                event.synchronize()
        n = len(items)
        for i, (im, _, _) in enumerate(items):
            host[i].copy_(torch.from_numpy(im))
        host[n:].zero_()                       # the padded tail
        per = self.batch_size // len(self.engines)
        for r, (engine, stream, event) in enumerate(zip(self.engines, self._streams,
                                                         events)):
            rows = slice(r * per, (r + 1) * per)
            with (torch.cuda.stream(stream) if stream is not None
                  else contextlib.nullcontext()):
                x = host[rows].to(engine.device, non_blocking=True)
                logits = (self._fwd if r == 0 else engine)(x)
                self._host_out[slot][rows].copy_(logits, non_blocking=True)
                if event is not None:
                    event.record(stream)

    def _resolve(self, slot, items):
        try:
            for event in self._events[slot]:
                if event is not None:
                    event.synchronize()
            logits = self._host_out[slot].numpy().copy()
        except Exception as exc:               # fail this batch, keep serving
            for _, fut, _ in items:
                _settle(fut, exc=exc)
            return
        done = time.perf_counter()
        for i, (_, fut, _) in enumerate(items):
            _settle(fut, logits[i])
        self.metrics.record(len(items), [(done - t0) * 1e3 for _, _, t0 in items])
