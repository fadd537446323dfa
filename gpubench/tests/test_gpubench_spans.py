"""The readers of the program's spans on a hand-built run: the self-time
arithmetic, the waits for the card taken out, the intersection of the
device's idle gaps with the calls and their attribution to the innermost
span, the transposes of a call, and nothing read where the calls found are
not the profiled batches."""

import sys
import types

import pytest

from gpubench import cells, program_spans
from gpubench import trace as tr
from gpubench.harness import Run

READERS = ("params_walk_ms", "input_ms", "wrapper_host_ms", "outside_host_ms",
           "idle_in_call_ms", "sync_wait_ms", "idle_in_embed_ms", "idle_in_merge_ms",
           "idle_in_head_ms", "transposes_per_call")


def _records(calls):
    """Span records as the program keeps them, from ``[(call id, [(name,
    start s, end s, parent position in the call's list or None[, attrs])])]``."""
    recs = []
    for call, spans in calls:
        base = len(recs)
        for name, s, e, parent, *attrs in spans:
            recs.append(types.SimpleNamespace(
                name=name, start_ns=round(s * 1e9), end_ns=round(e * 1e9),
                parent=None if parent is None else base + parent, call=call,
                attrs=dict(*attrs)))
    return recs


def _call(t0, params, inp, attn, mlp, length):
    """One call at ``t0`` that made 2 transposes: the walk, the input, embed,
    an attention wrapper that waits for the card for half its time and an
    MLP wrapper, the head, whose first 0.2 s wait for the card; each number
    a duration in seconds."""
    t = t0 + params + inp
    head = t + 0.1 + attn + mlp
    return [("ivit.call", t0, t0 + length, None, {"transposes": 2}),
            ("ivit.params", t0, t0 + params, 0),
            ("ivit.input", t0 + params, t, 0),
            ("ivit.embed", t, t + 0.1, 0),
            ("ivit.kernel.attn_block", t + 0.1, t + 0.1 + attn, 0),
            ("ivit.sync", t + 0.1, t + 0.1 + attn / 2, 4),
            ("ivit.kernel.mlp_block", t + 0.1 + attn, head, 0),
            ("ivit.head", head, t0 + length, 0),
            ("ivit.sync", head, head + 0.2, 7)]


def _run(kernels, window=(10.0, 20.0), batches=2):
    trace = tr.Trace([tr.Op("k", s, e) for s, e in kernels], [], [], window, batches)
    return Run(cfg={}, traffic={}, batch=8, blocks=[], macs_per_image=1, img_per_s=1.0,
               enqueue_s=[], trace=trace)


@pytest.fixture
def program(monkeypatch):
    """A stand-in for the program's spans module, as the run leaves it."""
    mod = types.SimpleNamespace(recs=[])
    mod.spans = lambda: list(mod.recs)
    monkeypatch.setitem(sys.modules, program_spans.MODULE, mod)
    return mod


def _read(name, run):
    return cells.metric(name).read(run)


def test_readers_take_the_calls_of_the_device_only_stretch(program):
    # two calls in the window; a third, the labelled stretch's, after it
    program.recs = _records([
        (4, _call(10.5, 0.2, 0.1, 0.4, 0.6, 2.0)),
        (5, _call(13.0, 0.4, 0.3, 0.2, 0.6, 2.5)),
        (6, _call(21.0, 9.0, 9.0, 9.0, 9.0, 40.0))])
    # device busy [11, 12] and [13.5, 16]; the rest of the window idle
    run = _run([(11.0, 12.0), (13.5, 16.0)])
    assert len(program_spans.calls(run)) == 2
    got = {name: _read(name, run) for name in READERS}
    assert got["params_walk_ms"] == pytest.approx(300.0)      # median of 200, 400
    assert got["input_ms"] == pytest.approx(200.0)
    # the wrappers less the wait inside one: 1.0 - 0.2 = 0.8, 0.8 - 0.1 = 0.7
    assert got["wrapper_host_ms"] == pytest.approx(750.0)
    # the waits: 0.2 + 0.2, 0.1 + 0.2
    assert got["sync_wait_ms"] == pytest.approx(350.0)
    # call less walk, input, wrappers and waits: 2.0 - 1.5 = 0.5, 2.5 - 1.7 = 0.8
    assert got["outside_host_ms"] == pytest.approx(650.0)
    # idle [10, 11], [12, 13.5], [16, 20] inside [10.5, 12.5] and [13, 15.5]:
    # 0.5 + 0.5, then 0.5: 1.5 s over 2 batches
    assert got["idle_in_call_ms"] == pytest.approx(750.0)
    # by the innermost span: [10.5, 11] walk 0.2, input 0.1, embed 0.1, the
    # wrapper's wait 0.1; [12, 12.5] the head's wait 0.1, the head 0.4;
    # [13, 13.5] walk 0.4, input 0.1
    assert program_spans.idle_by_span(run) == pytest.approx(
        {"ivit.params": 300.0, "ivit.input": 100.0, "ivit.embed": 50.0,
         "ivit.sync": 100.0, "ivit.head": 200.0})
    assert got["idle_in_head_ms"] == pytest.approx(200.0)
    assert got["idle_in_embed_ms"] == pytest.approx(50.0)
    assert got["idle_in_merge_ms"] is None          # no call has a merge
    assert got["transposes_per_call"] == 2


def test_a_call_that_starts_before_the_window_counts_where_it_ends(program):
    # the first call starts its walk before the first device operation,
    # which opens the device-only window
    program.recs = _records([(0, _call(9.9, 0.3, 0.1, 0.4, 0.6, 2.0))])
    run = _run([(10.0, 11.0)], window=(10.0, 12.5), batches=1)
    assert _read("params_walk_ms", run) == pytest.approx(300.0)
    assert _read("idle_in_call_ms", run) == pytest.approx(900.0)  # [11, 11.9]


@pytest.mark.parametrize("case", ["no_module", "no_spans", "too_few", "too_many",
                                  "no_trace", "open_call"])
def test_readers_read_nothing_unless_each_batch_has_its_call(monkeypatch, program, case):
    calls = [(0, _call(10.5, 0.2, 0.1, 0.4, 0.6, 2.0)),
             (1, _call(13.0, 0.4, 0.3, 0.2, 0.6, 2.5))]
    program.recs = _records(calls)
    run = _run([(11.0, 12.0)])
    if case == "no_module":
        monkeypatch.delitem(sys.modules, program_spans.MODULE)
    elif case == "no_spans":
        program.recs = []
    elif case == "too_few":
        run.trace.batches = 3
    elif case == "too_many":
        run.trace.batches = 1
    elif case == "no_trace":
        run.trace = None
    else:
        program.recs[0].end_ns = None
    assert program_spans.calls(run) is None
    assert all(_read(name, run) is None for name in READERS)


def test_idle_outside_every_child_span_goes_to_the_call(program):
    # one Swin-like call: a merge wait the card idles through after, a stretch
    # between the spans, and a merge the card stays busy through
    program.recs = _records([(0, [("ivit.call", 10.0, 14.0, None, {"transposes": 24}),
                                  ("ivit.merge", 10.5, 11.5, 0),
                                  ("ivit.sync", 10.5, 11.0, 1),
                                  ("ivit.merge", 12.5, 13.0, 0)])])
    run = _run([(10.0, 11.0), (12.0, 14.0)], window=(10.0, 14.0), batches=1)
    # idle [11, 12]: the merge after its wait 0.5, then nothing below the call
    assert program_spans.idle_by_span(run) == pytest.approx(
        {"ivit.merge": 500.0, "ivit.call": 500.0})
    assert _read("idle_in_merge_ms", run) == pytest.approx(500.0)
    assert _read("idle_in_head_ms", run) is None
    assert _read("idle_in_call_ms", run) == pytest.approx(1000.0)
    assert _read("transposes_per_call", run) == 24
    assert _read("sync_wait_ms", run) == pytest.approx(500.0)


def test_a_program_that_counts_no_transposes_reads_none(program):
    program.recs = _records([(0, [("ivit.call", 10.0, 12.0, None)])])
    run = _run([(10.0, 11.0)], window=(10.0, 12.0), batches=1)
    assert _read("idle_in_call_ms", run) == pytest.approx(1000.0)
    assert _read("transposes_per_call", run) is None
    assert _read("sync_wait_ms", run) == 0.0
