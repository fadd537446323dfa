"""Spans inside the port's engine (``ivit_tpu_torch.utils.spans``), on the
CPU: the span tree of a call, nothing recorded without a profiler, the
same logits either way, the buffer's cap, the transposes counted on
``ivit.call``, the clock against the profiler's own events, ``f32``'s
wait for a device and the ``spanned`` decorator."""

import dataclasses
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from ivit_tpu_torch.engine import Engine, vit_int
from ivit_tpu_torch.engine.synthetic import (deit_small_config, swin_tiny_config,
                                              synthetic_spec, synthetic_swin_spec)
from ivit_tpu_torch.ops.kernels import block as kb
from ivit_tpu_torch.ops.kernels import nonlinear as knl
from ivit_tpu_torch.ops.quant import f32
from ivit_tpu_torch.utils import spans

DEPTH = 2


@pytest.fixture(autouse=True)
def empty_buffer():
    spans.clear()
    yield
    spans.clear()


def _vit():
    cfg = dataclasses.replace(deit_small_config(depth=DEPTH, img_size=32),
                              embed_dim=64, num_heads=2, num_classes=10)
    return synthetic_spec(cfg, seed=0), _images(32)


def _swin():
    cfg = swin_tiny_config(depths=(2, 2), img_size=56, embed_dim=32,
                           stage_heads=(1, 2), num_classes=10)
    return synthetic_swin_spec(cfg, seed=0), _images(56)


def _images(size, batch=2):
    return np.random.default_rng(1).normal(size=(batch, size, size, 3)).astype(np.float32)


MODELS = {"vit": _vit, "swin": _swin}
# the children of ``ivit.call``, in order: a wrapper span a half-block
BLOCK = {"vit": ["ivit.kernel.attn_block", "ivit.kernel.mlp_block"],
         "swin": ["ivit.kernel.swin_attn_block", "ivit.kernel.mlp_block"]}
TOP = {"vit": ["ivit.params", "ivit.input", "ivit.embed"] + BLOCK["vit"] * DEPTH
       + ["ivit.head"],
       "swin": ["ivit.params", "ivit.input", "ivit.embed"] + BLOCK["swin"] * 2
       + ["ivit.merge"] + BLOCK["swin"] * 2 + ["ivit.head"]}
# the spans below those: the LayerNorm + requant wrapper of the norms
# outside the blocks (the final norm; Swin's patch norm and merge)
LN = ["ivit.kernel.ln_requant"]
INNER = {"vit": {"ivit.head": LN},
         "swin": {"ivit.embed": LN, "ivit.merge": LN, "ivit.head": LN}}


def _profiled(fn, calls):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        outs = [fn() for _ in range(calls)]
    return outs, prof


def _children(recs, i):
    return [j for j, r in enumerate(recs) if r.parent == i]


@pytest.mark.parametrize("model", sorted(MODELS))
def test_the_span_tree_of_a_call(model):
    spec, x = MODELS[model]()
    eng = Engine(spec, device="cpu")
    _profiled(lambda: eng(x), 2)
    recs = spans.spans()
    roots = [i for i, r in enumerate(recs) if r.parent is None]
    assert [recs[i].name for i in roots] == ["ivit.call"] * 2
    assert len({recs[i].call for i in roots}) == 2
    assert spans.dropped() == 0
    for i, r in enumerate(recs):
        assert r.start_ns <= r.end_ns
        if r.parent is not None:
            p = recs[r.parent]
            assert r.parent < i and r.call == p.call
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns
    for i in roots:
        # on the CPU the wrappers run their plain versions: no transposes
        assert recs[i].attrs == {"transposes": 0}
        top = _children(recs, i)
        assert [recs[j].name for j in top] == TOP[model]
        # on the CPU no host scalar is copied to a device: nothing waits
        for j in top:
            inner = _children(recs, j)
            assert [recs[k].name for k in inner] == INNER[model].get(recs[j].name, [])
            assert all(_children(recs, k) == [] for k in inner)
        assert all(not r.attrs for r in recs if r.parent is not None)


def test_nothing_is_recorded_without_a_profiler():
    spec, x = _vit()
    Engine(spec, device="cpu")(x)
    assert spans.spans() == [] and spans.dropped() == 0
    assert spans.span("ivit.call", batch=1) is spans.OFF and not spans.OFF
    with spans.span("ivit.head") as s:
        s.set(index=0)
    assert s is spans.OFF and spans.spans() == []


@pytest.mark.parametrize("kernels", [True, False], ids=["fused", "plain"])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_logits_are_the_same_with_the_profiler_on(model, kernels):
    spec, x = MODELS[model]()
    eng = Engine(spec, device="cpu", kernels=kernels)
    want = eng(x)
    (got,), _ = _profiled(lambda: eng(torch.from_numpy(x)), 1)
    assert torch.equal(got, want)
    assert spans.spans()[0].name == "ivit.call"


def test_the_buffer_keeps_its_cap_and_counts_what_it_drops(monkeypatch):
    spec, x = _vit()
    eng = Engine(spec, device="cpu")
    _profiled(lambda: eng(x), 1)
    whole = [r.name for r in spans.spans()]
    spans.clear()
    monkeypatch.setattr(spans, "CAPACITY", 7)
    _profiled(lambda: eng(x), 1)
    kept = spans.spans()
    assert [r.name for r in kept] == whole[:7]
    assert spans.dropped() == len(whole) - 7
    assert all(r.parent is None or r.parent < i for i, r in enumerate(kept))
    spans.clear()
    assert spans.spans() == [] and spans.dropped() == 0


def test_call_counter_deltas_equal_the_wrappers_counters(monkeypatch):
    """On the CPU the wrappers run their plain versions and count nothing:
    counting stand-ins in their place count as a card's calls do."""
    spec, x = _vit()
    eng = Engine(spec, device="cpu")

    def counting(fn, per_call):
        def counted(*a, **kw):
            counted.transposes += per_call
            return fn(*a, **kw)
        counted.transposes = fn.transposes
        return counted
    for name, per_call in (("attn_block", 2), ("mlp_block", 1)):
        monkeypatch.setattr(kb, name, counting(getattr(kb, name), per_call))
    before = vit_int.weight_transposes()
    _profiled(lambda: eng(x), 2)
    roots = [r for r in spans.spans() if r.name == "ivit.call"]
    assert sum(r.attrs["transposes"] for r in roots) == vit_int.weight_transposes() - before
    assert [r.attrs["transposes"] for r in roots] == [3 * DEPTH] * 2


def test_spans_share_the_profilers_clock():
    """Each ``ivit.call`` against a ``record_function`` event around the
    call: inside it, and starting within 1 ms of it.  The first call of the
    profiling session is left out: on an x86 CPU its event started 0.5-6 ms before the
    code inside it runs, whatever that code is."""
    spec, x = _vit()
    eng = Engine(spec, device="cpu")

    def call():
        with record_function("test.call"):
            return eng(x)
    _, prof = _profiled(call, 4)
    events = sorted((e for e in prof.profiler.kineto_results.events()
                     if e.name() == "test.call"), key=lambda e: e.start_ns())
    roots = [r for r in spans.spans() if r.name == "ivit.call"]
    assert len(events) == len(roots) == 4
    for e, r in list(zip(events, roots))[1:]:
        assert e.start_ns() <= r.start_ns < e.start_ns() + 1_000_000
        assert r.end_ns <= e.end_ns()
    assert not [e.name() for e in prof.profiler.kineto_results.events()
                if e.name().startswith("ivit.")]


def test_each_thread_keeps_its_own_calls():
    spec, x = _vit()
    eng = Engine(spec, device="cpu")
    errors = []

    def work():
        try:
            eng(x)
        except Exception as e:          # reported below
            errors.append(e)

    with profile(activities=[ProfilerActivity.CPU]):
        threads = [threading.Thread(target=work) for _ in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    assert not errors and not any(t.is_alive() for t in threads)
    recs = spans.spans()
    roots = [r for r in recs if r.parent is None]
    assert [r.name for r in roots] == ["ivit.call"] * 3
    assert len({r.call for r in roots}) == 3
    for r in recs:
        if r.parent is not None:
            assert recs[r.parent].call == r.call
    per_call = {r.call: sum(s.call == r.call for s in recs) for r in roots}
    assert len(set(per_call.values())) == 1


def test_f32_spans_each_copy_of_a_host_value_to_a_device():
    """``f32`` of a host value on a device other than the CPU (here the meta
    device) is the wait ``ivit.sync``; on the CPU, or of a tensor, it is no
    span."""
    with profile(activities=[ProfilerActivity.CPU]):
        on_dev = f32(2.5, torch.device("meta"))
        on_cpu = [f32(2.5), f32(2.5, "cpu"), f32(2.5, torch.device("cpu")),
                  f32(torch.ones(2, dtype=torch.int32), "meta")]
        f32([1.0, 2.0], "meta")
    assert on_dev.device.type == "meta" and on_dev.dtype == torch.float32
    assert all(t.device.type == "cpu" and t.dtype == torch.float32 for t in on_cpu)
    assert [r.name for r in spans.spans()] == ["ivit.sync"] * 2
    f32(2.5, torch.device("meta"))
    assert len(spans.spans()) == 2


@pytest.mark.parametrize("fn", [kb.mlp_block, kb.attn_block, kb.swin_attn_block,
                                knl.shiftmax, knl.shift_gelu_requant, knl.ln_requant],
                         ids=lambda fn: fn.__name__)
def test_the_wrappers_keep_their_names_and_counters(fn):
    assert fn.__wrapped__.__name__ == fn.__name__ and fn.__doc__
    assert isinstance(fn.launches, int)
    assert isinstance(getattr(fn, "transposes", 0), int)


def test_spanned_records_a_call_only_under_a_profiler():
    @spans.spanned("test.work")
    def work(a, b=1):
        """Adds."""
        return a + b
    work.count = 0

    assert work(1, b=2) == 3 and spans.spans() == []
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("test.outer"):
            assert work(2) == 3
    assert work.__name__ == "work" and work.__doc__ == "Adds." and work.count == 0
    outer, inner = spans.spans()
    assert (outer.name, inner.name) == ("test.outer", "test.work")
    assert inner.parent == 0 and inner.call == outer.call
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
