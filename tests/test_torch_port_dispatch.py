"""The engine's path dispatch (``ivit_tpu_torch/engine/dispatch.py``), the
``Engine`` default, Swin's ``fuse_parts`` and the two path-compare scripts,
on the CPU against the JAX package.

* The tables: JAX's keys (``tests/test_engine.py::
  test_dispatch_tables_invariants``), every row's evidence the card's name
  and power limit and no TPU figure; ``static_choice`` and
  ``swin_stage_choice`` give JAX's report keys for the same config
  objects; a geometry the tables do not hold takes the fused kernels
  (``source == "default"``), where JAX's TPU heuristic would not.
* ``timed_choice`` on CPU callables of known cost: the faster wins, a tie
  goes to the fused path, JAX's report keys; ``resolve`` on the tables and
  on a probe, as ``Engine`` takes them on the card, to a path that
  launches a kernel (no probe and no unfused row where none does).
* ``Engine(spec, device="cpu")``: ``kernels=None`` is True, the choice the
  caller's, the logits JAX's ``engine_forward(pallas=False)``'s on the
  same port-made synthetic spec; ``ServingEngine`` maps None to True.
* ``swin_engine_forward(fuse_parts=)``, crossed with ``stage_paths``: the
  kernels each variant routes to (counted), the logits the plain engine's
  and JAX's ``swin_engine_forward(pallas=False)``'s.
* ``path_compare`` and ``swin_path_compare`` with ``--device cpu`` on a
  narrow 64 px ViT and a 56 px Swin (``str2model`` monkeypatched): JAX's
  keys, every mode bitwise.
"""

import dataclasses
import json
import re
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivit_tpu.engine import dispatch as jdispatch
from ivit_tpu.engine import swin_int as jswin
from ivit_tpu.engine.freeze import EngineConfig as JaxConfig
from ivit_tpu.engine.freeze import EngineSpec as JaxSpec
from ivit_tpu.engine.vit_int import engine_forward as jax_forward
from ivit_tpu.models import BitWidths as JaxBitWidths
import ivit_tpu_torch.models as tmodels
from ivit_tpu_torch.engine import (Engine, EngineConfig, ServingEngine, dispatch,
                                   swin_engine_forward)
from ivit_tpu_torch.engine.synthetic import (swin_tiny_config, synthetic_spec,
                                             synthetic_swin_spec)
from ivit_tpu_torch.models import BitWidths, SwinTransformer, VisionTransformer
from ivit_tpu_torch.ops.kernels import block as kb
from ivit_tpu_torch.scripts import path_compare, swin_path_compare

CARD = re.compile(r"NVIDIA H100[^,]*, \d+\.\d+ W")
SWIN_GEOM = dict(img_size=56, embed_dim=64, depths=(2, 2), stage_heads=(2, 4),
                 num_classes=10)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class VitCfg:
    embed_dim = 192


class SwinCfg:
    embed_dim = 96
    depths = (2, 2, 6, 2)


def _images(n, img, seed=3):
    return np.random.default_rng(seed).normal(size=(n, img, img, 3)).astype(np.float32)


def _jax_spec(spec):
    d = dataclasses.asdict(spec.config)
    d["bitwidths"] = JaxBitWidths(*spec.config.bitwidths.to_list())
    params = jax.tree.map(jnp.asarray, spec.params)
    if hasattr(spec.config, "depths"):
        return jswin.SwinEngineSpec(jswin.SwinEngineConfig(**d), params)
    return JaxSpec(JaxConfig(**d), params)


def _vit_spec(fam="ivit"):
    cfg = EngineConfig(img_size=64, patch_size=16, embed_dim=64, depth=2, num_heads=2,
                       mlp_ratio=4.0, num_classes=10, bitwidths=BitWidths(),
                       gelu_type=fam, softmax_type=fam, layernorm_type=fam)
    return synthetic_spec(cfg, seed=0)


def test_dispatch_tables_invariants():
    """JAX's table keys; each row a bool and an H100 figure with the card's
    power limit and the PERF.md section, no TPU figure."""
    assert set(dispatch.MEASURED) == set(jdispatch.MEASURED)
    assert set(dispatch.MEASURED_SWIN_STAGE) == set(jdispatch.MEASURED_SWIN_STAGE)
    rows = list(dispatch.MEASURED.items()) + list(dispatch.MEASURED_SWIN_STAGE.items())
    for key, row in rows:
        if isinstance(key, tuple):
            arch, dim = key
            assert arch in ("vit", "swin") and isinstance(dim, int)
        else:
            assert isinstance(key, int)
        assert set(row) == {"fused", "evidence"} and isinstance(row["fused"], bool)
        ev = row["evidence"]
        assert CARD.search(ev), ev
        assert "img/s" in ev and "PERF.md" in ev, ev
        assert not re.search(r"TPU|runs/|BENCH|\br\d\b", ev), ev
    assert not hasattr(dispatch, "TUNED") and not hasattr(dispatch, "kernel_tune")


def test_static_and_stage_choice_report_jax_keys():
    fused, rep = dispatch.static_choice(VitCfg())
    jfused, jrep = jdispatch.static_choice(VitCfg())
    assert isinstance(fused, bool) and set(rep) == set(jrep)
    assert rep["source"] == jrep["source"] == "static-table"
    assert rep["key"] == jrep["key"] == "('vit', 192)"
    assert fused == dispatch.MEASURED["vit", 192]["fused"]

    paths, rep = dispatch.swin_stage_choice(SwinCfg())
    jpaths, jrep = jdispatch.swin_stage_choice(SwinCfg())
    assert len(paths) == len(jpaths) == 4 and all(isinstance(p, bool) for p in paths)
    assert set(rep) == set(jrep) and rep["source"] == jrep["source"] == "swin-stage-table"
    assert set(rep["evidence"]) == set(jrep["evidence"]) == {"96", "192", "384", "768"}
    assert paths == tuple(dispatch.MEASURED_SWIN_STAGE[d]["fused"]
                          for d in (96, 192, 384, 768))


def test_absent_geometry_takes_the_fused_kernels():
    """Not JAX's heuristic ("fused iff C >= 256"), which sends C 100 and a
    64-wide Swin stage unfused."""
    class Narrow:
        embed_dim = 100

    class NarrowSwin:
        embed_dim = 32
        depths = (2, 2)

    fused, rep = dispatch.static_choice(Narrow())
    assert fused is True and rep["source"] == "default" and rep["key"] == "('vit', 100)"
    assert "no row" in rep["evidence"]
    assert jdispatch.static_choice(Narrow())[0] is False
    paths, rep = dispatch.swin_stage_choice(NarrowSwin())
    assert paths == (True, True) and "no row" in rep["evidence"]["64"]
    assert jdispatch.swin_stage_choice(NarrowSwin())[0] == (False, False)


def _sleeper(ms):
    """A CPU callable that takes ``ms`` milliseconds."""
    def fn(x):
        time.sleep(ms / 1e3)
        return x + 1
    return fn


def test_timed_choice_picks_the_faster_and_reports_jax_keys(monkeypatch):
    x = torch.zeros(4)
    fused, rep = dispatch.timed_choice(_sleeper(20), _sleeper(0), x, iters=3)
    assert fused is False and rep["t_fused_ms"] > rep["t_unfused_ms"]
    fused, rep = dispatch.timed_choice(_sleeper(0), _sleeper(20), x, iters=3)
    assert fused is True and rep["source"] == "timed-probe"
    _, jrep = jdispatch.timed_choice(lambda a: a + 1, lambda a: a + 2, jnp.zeros(4), iters=1)
    assert set(rep) == set(jrep)

    import ivit_tpu_torch.utils.benchmarking as bench
    monkeypatch.setattr(bench, "time_dispatch", lambda fn, x, iters: 0.5)
    fused, rep = dispatch.timed_choice(_sleeper(0), _sleeper(0), x)
    assert fused is True and rep["t_fused_ms"] == rep["t_unfused_ms"] == 500.0


def _maker(ms):
    """``resolve``'s probe: a maker whose True path runs ``ms[0]``
    milliseconds and unfused path ``ms[1]``, and its input."""
    return lambda k: _sleeper(ms[0] if k is True else ms[1]), torch.zeros(2)


@pytest.mark.parametrize("fam", ["ivit", "ibert", "ppoly", "float"])
def test_resolve_takes_only_paths_that_launch_a_kernel(fam, monkeypatch):
    """What ``Engine(spec)`` takes on the card: the tables, or the probe
    between the fused kernels and ``"ops"`` where ``"ops"`` launches a
    kernel (ivit); never the plain version.  Elsewhere the probe is
    skipped and a row that says unfused keeps the fused kernels."""
    vit = dataclasses.replace(_vit_spec().config, gelu_type=fam, softmax_type=fam)
    other = "ops" if fam == "ivit" else None
    assert dispatch.unfused_candidate(vit) == other
    kernels, stages, rep = dispatch.resolve(vit)
    assert kernels is True and stages is None and rep["source"] == "default"

    kernels, _, rep = dispatch.resolve(vit, _maker((20, 0)))   # the fused path slower
    if other:
        assert kernels == "ops" and rep["source"] == "timed-probe"
    else:
        assert kernels is True and rep["source"] == "default"
        assert rep["probe"].startswith("skipped")
    kernels, _, rep = dispatch.resolve(vit, _maker((0, 20)))
    assert kernels is True and rep["source"] == ("timed-probe" if other else "default")

    monkeypatch.setitem(dispatch.MEASURED, ("vit", 64), {"fused": False, "evidence": "e"})
    kernels, _, rep = dispatch.resolve(vit)
    assert rep["source"] == "static-table"
    assert kernels == (other or True) and ("note" in rep) == (other is None)


def test_resolve_swin_keeps_its_kernels(monkeypatch):
    """A Swin has no unfused path that launches a kernel: True with its
    table's stages, no probe, and every stage fused where the table would
    unfuse them all; a ViT with a float GELU takes "ops" (the ivit
    softmax's kernel)."""
    swin = swin_tiny_config()
    assert dispatch.unfused_candidate(swin) is None
    kernels, stages, rep = dispatch.resolve(swin)
    assert kernels is True and rep["source"] == "swin-stage-table"
    assert stages == dispatch.swin_stage_choice(swin)[0]
    kernels, stages2, rep = dispatch.resolve(swin, _maker((20, 0)))
    assert (kernels, stages2) == (True, stages) and rep["source"] == "swin-stage-table"
    assert rep["probe"].startswith("skipped")
    for dim in (96, 192, 384, 768):
        monkeypatch.setitem(dispatch.MEASURED_SWIN_STAGE, dim, {"fused": False,
                                                                "evidence": "e"})
    kernels, stages, rep = dispatch.resolve(swin)
    assert (kernels, stages) == (True, None) and "note" in rep

    mixed = dataclasses.replace(_vit_spec().config, gelu_type="float")
    kernels, _, rep = dispatch.resolve(mixed, _maker((0, 20)))
    assert kernels == "ops" and rep["source"] == "families"


def test_engine_default_on_cpu_is_the_fused_path_and_jax_bitwise():
    spec = _vit_spec()
    x = _images(3, 64)
    eng = Engine(spec, device="cpu")
    assert eng.kernels is True and eng.mlp_wt is not None and eng.fusion["fused_blocks"]
    assert eng.fusion["path_choice"] == {"source": "caller", "kernels": "None",
                                         "stage_paths": None}
    got = eng(x).numpy()
    want = np.asarray(jax.jit(lambda a: jax_forward(_jax_spec(spec), a, pallas=False))(
        jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)
    probed = Engine(spec, device="cpu", probe_images=x)      # no probe off the card
    assert probed.fusion["path_choice"]["source"] == "caller" and probed.kernels is True
    np.testing.assert_array_equal(probed(x).numpy(), want)
    ops = Engine(spec, device="cpu", kernels="ops")
    assert ops.mlp_wt is None and ops.fusion["path_choice"]["kernels"] == "'ops'"
    np.testing.assert_array_equal(ops(x).numpy(), want)

    swin = synthetic_swin_spec(swin_tiny_config(**SWIN_GEOM), seed=0)
    seng = Engine(swin, device="cpu", stage_paths=(False, True))
    assert seng.kernels is True and seng.fusion["fused_attn_stages"] == [False, True]
    assert seng.fusion["path_choice"] == {"source": "caller", "kernels": "None",
                                          "stage_paths": (False, True)}
    with pytest.raises(ValueError, match="kernels"):
        Engine(swin, device="cpu", kernels="ops")


def test_serving_engine_maps_none_to_the_fused_kernels():
    spec = _vit_spec("ibert")
    x = _images(4, 64)
    with ServingEngine(spec, batch_size=2, device="cpu", kernels=None) as srv:
        assert srv.engine.kernels is True
        assert srv.engine.fusion["path_choice"]["kernels"] == "True"
        got = srv.infer(x)
    np.testing.assert_array_equal(got, Engine(spec, device="cpu")(x).numpy())


@pytest.fixture(scope="module")
def swin_case():
    """A 56 px Swin at stage widths 64 and 128 (the second a multiple of
    128, where ``mlp_nopad`` still fuses), ivit; its plain logits and
    JAX's."""
    spec = synthetic_swin_spec(swin_tiny_config(**SWIN_GEOM), seed=0)
    x = _images(2, 56)
    plain = swin_engine_forward(spec, x, kernels=False, device="cpu").numpy()
    jax_out = np.asarray(jax.jit(lambda a: jswin.swin_engine_forward(
        _jax_spec(spec), a, pallas=False))(jnp.asarray(x)))
    np.testing.assert_array_equal(plain, jax_out)
    return spec, x, plain


class _Count:
    def __init__(self, monkeypatch, name):
        self.calls, fn = 0, getattr(kb, name)

        def spy(*a, **k):
            self.calls += 1
            return fn(*a, **k)
        monkeypatch.setattr(kb, name, spy)


@pytest.mark.parametrize("stages", [(True, False), (False, True)],
                         ids=["stage0", "stage1"])
@pytest.mark.parametrize("parts,attn,mlp", [
    (("attn",), (1, 1), (0, 0)),
    (("mlp",), (0, 0), (1, 1)),
    (("attn", "mlp_nopad"), (1, 1), (0, 0)),      # JAX: nopad alone fuses no MLP
    (("mlp", "mlp_nopad"), (0, 0), (0, 1)),       # width 64 is not a multiple of 128
    (("mlp", "mlp_nopad", "mlp_pad"), (0, 0), (1, 1)),
], ids=["attn", "mlp", "attn+nopad", "mlp+nopad", "mlp+nopad+pad"])
def test_swin_fuse_parts_route_and_match_plain_and_jax(swin_case, monkeypatch, parts,
                                                      attn, mlp, stages):
    spec, x, plain = swin_case
    n_attn, n_mlp = _Count(monkeypatch, "swin_attn_block"), _Count(monkeypatch, "mlp_block")
    got = swin_engine_forward(spec, x, kernels=True, device="cpu", stage_paths=stages,
                              fuse_parts=parts).numpy()
    np.testing.assert_array_equal(got, plain)
    assert n_attn.calls == 2 * sum(a and s for a, s in zip(attn, stages))
    assert n_mlp.calls == 2 * sum(m and s for m, s in zip(mlp, stages))


def test_swin_fuse_parts_refusals(swin_case):
    spec, x, _ = swin_case
    for parts in ("attn", ("attn", "mpl")):
        with pytest.raises(ValueError, match="fuse_parts"):
            swin_engine_forward(spec, x, device="cpu", fuse_parts=parts)


@pytest.fixture
def small_models(monkeypatch):
    """Every registered name builds a narrow model: a 64 px depth-2 ViT or
    a 56 px Swin of two stages; the float Swin at the same widths."""
    vit = dict(img_size=64, patch_size=16, embed_dim=64, depth=2, num_heads=2,
               num_classes=10)
    swin = dict(img_size=56, patch_size=4, embed_dim=64, depths=(2, 2),
                num_heads=(2, 4), window_size=7, num_classes=10)

    def factory(name):
        if name.startswith("swin"):
            return lambda **kw: SwinTransformer(**{**swin, **kw})
        return lambda **kw: VisionTransformer(**{**vit, **kw})
    monkeypatch.setattr(tmodels, "str2model", factory)
    import ivit_tpu_torch.models.vit_float as vf
    monkeypatch.setattr(vf, "float_swin_model", lambda name, **kw: vf.FloatSwinTransformer(
        **{**swin, **kw}, dtype=torch.float32))


def test_path_compare_script(small_models, capsys):
    lines = path_compare.main(["--device", "cpu", "--batch", "2", "--iters", "1",
                               "--check"])
    assert [json.loads(s) for s in capsys.readouterr().out.splitlines()] == lines
    assert lines[0] == {"card": "cpu", "model": "deit_tiny_patch16_224", "fam": "ivit",
                        "batch": 2}
    recs, checks = lines[1:4], lines[4:]
    assert [r["mode"] for r in recs] == ["blocks", "ops", "plain"]
    assert all(set(r) == {"mode", "ms_per_batch", "images_per_sec"} for r in recs)
    assert checks == [{"mode": m, "bitwise_equal_vs_blocks": True}
                      for m in ("blocks", "ops", "plain")]


def test_path_compare_passes(small_models, capsys):
    """``--passes 2``: the modes, then again in the reverse order, each line
    with its pass; every pass checked against the first pass's base."""
    lines = path_compare.main(["--device", "cpu", "--batch", "2", "--iters", "1",
                               "--modes", "blocks,plain", "--passes", "2", "--check"])
    assert [json.loads(s) for s in capsys.readouterr().out.splitlines()] == lines
    assert [(r["mode"], r["pass"]) for r in lines[1:] if "ms_per_batch" in r] == [
        ("blocks", 0), ("plain", 0), ("plain", 1), ("blocks", 1)]
    assert [c for c in lines if "bitwise_equal_vs_blocks" in c] == [
        {"mode": m, "bitwise_equal_vs_blocks": True, "pass": p}
        for m, p in (("blocks", 0), ("plain", 0), ("plain", 1), ("blocks", 1))]


def test_swin_path_compare_script(small_models, capsys):
    modes = ["fused", "fused_nopad", "attn", "mlp", "mlp_nopad", "unfused",
             "stages23", "stages123", "stages3", "dispatch", "bf16"]
    lines = swin_path_compare.main(["--device", "cpu", "--batch", "2", "--iters", "1",
                                    "--check", "--modes", ",".join(modes)])
    assert [json.loads(s) for s in capsys.readouterr().out.splitlines()] == lines
    assert lines[0]["card"] == "cpu" and lines[0]["batch"] == 2
    stage_line = lines[10]
    assert stage_line["mode"] == "dispatch" and stage_line["stage_paths"] == [True, True]
    assert stage_line["evidence"]["source"] == "swin-stage-table"
    recs = [r for r in lines[1:] if "ms_per_batch" in r]
    assert [r["mode"] for r in recs] == modes
    assert all(set(r) == {"mode", "ms_per_batch", "images_per_sec"} for r in recs)
    checks = [r for r in lines if "bitwise_equal_vs_fused" in r]
    assert [c["mode"] for c in checks] == modes[:-1]        # bf16 is not compared
    assert all(c["bitwise_equal_vs_fused"] for c in checks)
    cfg = swin_tiny_config(**SWIN_GEOM)
    assert swin_path_compare.stage_paths(cfg, "stages123") == (False, True)
    assert swin_path_compare.stage_paths(swin_tiny_config(), "stages23") == (
        False, False, True, True)
