"""The active mesh of ``ivit_tpu_torch.parallel.collectives`` is per
thread (a ``ContextVar``): a server's batcher thread, whose ``Engine``
enters ``use(None)`` for every batch, leaves a sharded forward running on
another thread its mesh.  With one process-wide mesh the batcher cleared
it: the forward's all-reduces became no-ops on one rank only, and its bits
changed or its ranks waited on each other.

* Two threads: A sits in ``use(m)`` while B enters and leaves ``use(None)``;
  A still sees ``m``, and after both exit (in either order) every thread
  sees None; ``timed()`` is per thread too.
* A 2-rank gloo world on the CPU: rank 0 serves 32 requests from a
  ``ServingEngine`` thread while both ranks run 4 tp-2 plain forwards of a
  64 px depth-2 synthetic DeiT-S-width spec; every tp-2 logit and every
  answer equals the single-device engine's bitwise.
"""

import os
import sys
import threading
import types

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import _torch_parallel_workers as W  # noqa: E402

from ivit_tpu_torch.engine import Engine  # noqa: E402
from ivit_tpu_torch.engine.synthetic import deit_small_config, synthetic_spec  # noqa: E402
from ivit_tpu_torch.parallel import collectives as coll  # noqa: E402
from ivit_tpu_torch.parallel import launch  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stub_mesh():
    return types.SimpleNamespace(distributed=True, dp=1, tp=2)


@pytest.mark.parametrize("a_exits_first", [True, False])
def test_active_mesh_is_per_thread(a_exits_first):
    m = _stub_mesh()
    a_in, b_in, b_out, a_out = (threading.Event() for _ in range(4))
    seen = {}

    def thread_a():
        with coll.use(m):
            a_in.set()
            b_in.wait(10)
            seen["a_beside_b"] = coll.active()
            if not a_exits_first:
                b_out.wait(10)
            seen["a_after_b"] = coll.active()
        a_out.set()
        seen["a_outside"] = coll.active()

    def thread_b():
        a_in.wait(10)
        with coll.use(None):
            b_in.set()
            seen["b_inside"] = coll.active()
            if a_exits_first:
                a_out.wait(10)
        b_out.set()
        seen["b_outside"] = coll.active()

    ts = [threading.Thread(target=f) for f in (thread_a, thread_b)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(20)
    assert not any(t.is_alive() for t in ts)
    assert seen["a_beside_b"] is m and seen["a_after_b"] is m
    assert seen["b_inside"] is None
    assert seen["a_outside"] is None and seen["b_outside"] is None
    assert coll.active() is None


def test_use_nests_and_a_new_thread_starts_without_a_mesh():
    m1, m2 = _stub_mesh(), _stub_mesh()
    seen = []
    with coll.use(m1):
        with coll.use(m2):
            assert coll.active() is m2
            t = threading.Thread(target=lambda: seen.append(coll.active()))
            t.start()
            t.join(10)
        assert coll.active() is m1
        with coll.use(types.SimpleNamespace(distributed=False)):
            assert coll.active() is None      # a mesh of devices acts on nothing
        assert coll.active() is m1
    assert coll.active() is None and seen == [None]


def test_timed_switch_is_per_thread():
    seen = []
    with coll.timed():
        assert coll._TIMED.get()
        t = threading.Thread(target=lambda: seen.append(coll._TIMED.get()))
        t.start()
        t.join(10)
    assert seen == [False] and not coll._TIMED.get()


def test_server_thread_beside_a_tp2_rank_keeps_the_bits(tmp_path):
    spec = synthetic_spec(deit_small_config(depth=2, img_size=64), seed=0)
    x = W.images(4, 64, 11)
    served = W.images(W.SERVED, 64, 12)
    res = launch.spawn(W.serve_beside_tp_rank, 2, devices=["cpu"] * 2,
                       init_file=str(tmp_path / "rendezvous"), args=(spec, x, served),
                       timeout=120)
    eng = Engine(spec, device="cpu", kernels=False)
    want = eng(x).numpy()
    for r, out in enumerate(res):
        assert len(out["tp"]) == W.TP_FORWARDS
        for got in out["tp"]:
            np.testing.assert_array_equal(got, want, err_msg=f"rank {r}")
    before, after = res[0]["answered"]
    assert before < W.SERVED, "the server had finished before the forwards began"
    np.testing.assert_array_equal(res[0]["served"], eng(served).numpy())
    assert res[1]["served"] is None
