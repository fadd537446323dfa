"""The port's continuous-batching server (``ivit_tpu_torch.engine.serving``),
mirroring ``tests/test_serving.py`` on the CPU (but its data-parallel mesh
test: the port serves on one device).

The specs are the port's own freezes of seeded, calibrated sims: a 64 px
ViT of depth 2 (``tests/test_engine.py``'s geometry) and the 56 px Swin of
``tests/test_swin_engine.py::build_swin``.  Served logits are held bitwise
to ``Engine(spec)`` on the same images: the integer engine computes each
image's row alone, so the batch an image lands in, its position there and
the padding beside it change none of its bits.  JAX's own test allows
``atol=1e-5`` for its data-parallel mesh; one device has nothing to
allow for.
"""

import sys
import threading
from concurrent.futures import CancelledError, Future

import numpy as np
import pytest
import torch

from ivit_tpu_torch.engine import Engine
from ivit_tpu_torch.engine.freeze import freeze_model
from ivit_tpu_torch.engine.serving import DeadlineExceeded, QueueFull, ServingEngine
from ivit_tpu_torch.engine.swin_int import freeze_swin_model
from ivit_tpu_torch.models import SwinTransformer, VisionTransformer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's small CPU forwards: Tier-1 runs
    six workers at once, and a pool per worker as wide as the machine
    oversubscribes its cores (every product here is exact, so the bits do
    not depend on the thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _calibrate(model, size, seed):
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for _ in range(2):
            model(torch.from_numpy(rng.normal(size=(2, size, size, 3)).astype(np.float32)),
                  running_stat=True)
    return model


@pytest.fixture(scope="module")
def vit_spec():
    return freeze_model(_calibrate(VisionTransformer(
        img_size=64, patch_size=16, embed_dim=64, depth=2, num_heads=2,
        num_classes=10, device="cpu", seed=0), 64, 0))


@pytest.fixture(scope="module")
def swin_spec():
    return freeze_swin_model(_calibrate(SwinTransformer(
        img_size=56, patch_size=4, embed_dim=32, depths=(2, 2), num_heads=(2, 4),
        window_size=7, num_classes=10, drop_path_rate=0.0, device="cpu", seed=0), 56, 1))


def _images(n, size=64, seed=0):
    return np.random.default_rng(seed).normal(size=(n, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("which", ["vit", "swin"])
def test_serving_matches_engine(which, vit_spec, swin_spec):
    spec, size = (vit_spec, 64) if which == "vit" else (swin_spec, 56)
    images = _images(10, size)
    want = Engine(spec, device="cpu")(torch.from_numpy(images)).numpy()
    with ServingEngine(spec, batch_size=4, max_wait_ms=20, device="cpu") as srv:
        got = srv.infer(images)
        m = srv.metrics.summary()
    np.testing.assert_array_equal(got, want)
    assert m["images"] == 10
    assert m["batches"] >= 3         # 10 requests / batch 4 -> >= 3 batches
    assert 0 < m["latency_ms_p50"] <= m["latency_ms_p95"] <= m["latency_ms_p99"]


def test_serving_single_request_padding(vit_spec):
    img = _images(1)[0]
    want = Engine(vit_spec, device="cpu")(torch.from_numpy(img[None])).numpy()[0]
    with ServingEngine(vit_spec, batch_size=8, max_wait_ms=1, device="cpu") as srv:
        out = srv.submit(img).result(timeout=120)
    assert out.shape == (10,)
    np.testing.assert_array_equal(out, want)


def test_serving_rejects_bad_shape(vit_spec):
    with ServingEngine(vit_spec, batch_size=2, device="cpu") as srv:
        with pytest.raises(ValueError):
            srv.submit(np.zeros((32, 32, 3), np.float32))


def test_serving_close_resolves_stranded_futures(vit_spec):
    """Shutdown must not strand clients: queued-but-unbatched requests are
    cancelled or failed, and submits after close raise at once."""
    srv = ServingEngine(vit_spec, batch_size=4, max_wait_ms=1, device="cpu")
    # stop the batcher first, so that requests queued now are never batched
    srv._stop.set()
    srv._batcher.join(timeout=30)
    assert not srv._batcher.is_alive()
    futs = []
    for img in _images(3):
        fut = Future()
        srv._queue.put((img, fut, 0.0))
        futs.append(fut)
    srv.close()
    for fut in futs:
        assert fut.done()
        if not fut.cancelled():
            with pytest.raises(RuntimeError):
                fut.result(timeout=0)
    with pytest.raises(RuntimeError):
        srv.submit(_images(1)[0])


def test_serving_batcher_exception_fails_batch(vit_spec):
    """A failing forward fails that batch's futures; the server keeps
    serving the requests after it."""
    with ServingEngine(vit_spec, batch_size=2, max_wait_ms=1, device="cpu") as srv:
        good_fwd = srv._fwd

        def bad_fwd(x):
            raise RuntimeError("injected device failure")

        srv._fwd = bad_fwd
        img = _images(1)[0]
        with pytest.raises(RuntimeError, match="injected"):
            srv.submit(img).result(timeout=120)
        srv._fwd = good_fwd
        out = srv.submit(img).result(timeout=120)
        assert np.isfinite(out).all()


def test_serving_admission_control(vit_spec):
    """max_queue bounds admission: over-limit submits raise QueueFull and
    are counted; admitted requests still complete correctly."""
    images = _images(12)
    want = Engine(vit_spec, device="cpu")(torch.from_numpy(images)).numpy()
    with ServingEngine(vit_spec, batch_size=4, max_wait_ms=200, device="cpu",
                       max_queue=3) as srv:
        futs, rejected = {}, 0
        for i, im in enumerate(images):
            try:
                futs[i] = srv.submit(im)
            except QueueFull:
                rejected += 1
        got = {i: f.result(timeout=60) for i, f in futs.items()}
        m = srv.metrics.summary()
    assert rejected >= 1                      # 12 offered into a 3-deep queue
    assert len(got) == 12 - rejected and m["rejected"] == rejected
    for i, g in got.items():
        np.testing.assert_array_equal(g, want[i])


def test_serving_admission_bound_is_atomic(vit_spec):
    """Eight threads submit against a stalled batcher: the queue never
    holds more than max_queue requests, exactly max_queue are admitted
    past the one in the batcher, and every admitted request is answered
    once the batcher runs again."""
    max_queue, threads, per_thread = 5, 8, 40
    entered, release = threading.Event(), threading.Event()
    with ServingEngine(vit_spec, batch_size=1, max_wait_ms=0, device="cpu",
                       max_queue=max_queue) as srv:
        good_fwd = srv._fwd

        def stalled_fwd(x):
            entered.set()
            assert release.wait(timeout=60)
            return good_fwd(x)

        srv._fwd = stalled_fwd
        first = srv.submit(_images(1)[0])
        assert entered.wait(timeout=60)        # the batcher holds one request
        admitted, rejected, peak = [], [], [0]
        lock = threading.Lock()
        img = _images(1, seed=1)[0]

        def client():
            for _ in range(per_thread):
                try:
                    fut = srv.submit(img)
                    with lock:
                        admitted.append(fut)
                except QueueFull:
                    with lock:
                        rejected.append(1)
                with lock:
                    peak[0] = max(peak[0], srv._queue.qsize())

        switch = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            workers = [threading.Thread(target=client) for _ in range(threads)]
            for w in workers:
                w.start()
            for w in workers:
                w.join(timeout=60)
            assert not any(w.is_alive() for w in workers)
        finally:
            sys.setswitchinterval(switch)
        assert peak[0] <= max_queue
        assert len(admitted) == max_queue
        assert len(rejected) == threads * per_thread - max_queue
        assert srv.metrics.summary()["rejected"] == len(rejected)
        srv._fwd = good_fwd
        release.set()
        for fut in [first] + admitted:
            assert np.isfinite(fut.result(timeout=60)).all()


def test_serving_deadline_sheds_stale_requests(vit_spec):
    """Requests older than deadline_ms at batch assembly are shed with
    DeadlineExceeded (or cancelled), not run."""
    images = _images(6)
    with ServingEngine(vit_spec, batch_size=4, max_wait_ms=5, device="cpu",
                       deadline_ms=1e9) as srv:
        assert srv.infer(images).shape[0] == 6    # an infinite deadline sheds none
        assert srv.metrics.summary()["shed"] == 0
    with ServingEngine(vit_spec, batch_size=4, max_wait_ms=5, device="cpu",
                       deadline_ms=0.0) as srv:
        futs = [srv.submit(im) for im in images]
        shed = 0
        for f in futs:
            try:
                f.result(timeout=60)
            except (DeadlineExceeded, CancelledError):
                shed += 1
        m = srv.metrics.summary()
    assert shed == 6 and m["shed"] == 6
    assert m["images"] == 0                   # nothing reached the engine


def test_serving_ops_path(vit_spec):
    """kernels="ops" (the standalone nonlinearity kernels' plain versions
    here) serves the engine's logits too."""
    images = _images(3)
    want = Engine(vit_spec, device="cpu", kernels="ops")(torch.from_numpy(images)).numpy()
    with ServingEngine(vit_spec, batch_size=4, max_wait_ms=5, device="cpu",
                       kernels="ops") as srv:
        np.testing.assert_array_equal(srv.infer(images), want)


def test_serving_defaults_to_cuda(vit_spec):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(vit_spec)
