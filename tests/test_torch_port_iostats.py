"""The port's IO statistics (``ivit_tpu_torch/utils/iostats.py``), the
engines' envelope audit and their fusion reports against the JAX
package's.

The port's own sims (64 px ViT: depth 2, embed 64, 2 heads; 56 px Swin:
depths (2, 2), embed 32), calibrated on two seeded batches, their
variables handed to JAX's models and their frozen specs to JAX's engines
(``variables_to_numpy``; the JAX package initialises nothing):

* ``attach_io_stats`` rows equal JAX's ``ivit_tpu.utils.iostats`` rows: the
  same layers in the same (sorted-path) order, the same extrema, scales,
  integer extrema and shapes; ``save_io_stats`` writes the text JAX's
  pandas ``to_csv`` writes; a ``.pkl`` path raises;
* ``audit_capture`` records of the port's plain engine equal JAX's
  ``engine_forward(pallas=False)`` / ``swin_engine_forward`` records
  (jitted, as JAX's ``analyze_io_stats`` runs them): the same sites in the
  same order, kinds, bounds, extrema and saturation shares; no hard-bound
  violation; no record without a capture;
* ``fusion_report`` / ``swin_fusion_report`` carry JAX's keys, and
  ``Engine.fusion`` holds them with the caller's choice.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivit_tpu.engine import swin_int as jswin
from ivit_tpu.engine import vit_int as jvit
from ivit_tpu.engine.freeze import EngineConfig as JaxConfig
from ivit_tpu.engine.freeze import EngineSpec as JaxSpec
from ivit_tpu.models import BitWidths as JaxBitWidths
from ivit_tpu.models import SwinTransformer as JaxSwin
from ivit_tpu.models import VisionTransformer as JaxViT
from ivit_tpu.utils import iostats as jio
from ivit_tpu_torch.engine import Engine
from ivit_tpu_torch.engine import swin_int as tswin
from ivit_tpu_torch.engine import vit_int as tvit
from ivit_tpu_torch.engine.freeze import freeze_model
from ivit_tpu_torch.models import SwinTransformer, VisionTransformer
from ivit_tpu_torch.models.convert import variables_to_numpy
from ivit_tpu_torch.utils import iostats as tio

VIT = dict(img_size=64, patch_size=16, embed_dim=64, depth=2, num_heads=2,
           num_classes=10)
SWIN = dict(img_size=56, patch_size=4, embed_dim=32, depths=(2, 2),
            num_heads=(2, 4), window_size=7, num_classes=10, drop_path_rate=0.0)
CASES = [("vit", "ivit"), ("vit", "ibert"), ("swin", "ivit"), ("swin", "ibert")]
IDS = [f"{k}-{f}" for k, f in CASES]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's small CPU forwards: Tier-1 runs
    six workers at once (the bits do not depend on the thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _images(kind, n=2, seed=5):
    img = 64 if kind == "vit" else 56
    return np.random.default_rng(seed).normal(size=(n, img, img, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def sims():
    """(kind, family) -> the port's calibrated sim."""
    out = {}
    for kind, fam in CASES:
        cls, geom = (VisionTransformer, VIT) if kind == "vit" else (SwinTransformer, SWIN)
        sim = cls(gelu_type=fam, softmax_type=fam, layernorm_type=fam, device="cpu",
                  seed=0, **geom)
        with torch.no_grad():
            for s in (0, 1):
                sim(torch.from_numpy(_images(kind, seed=s)), running_stat=True)
        out[kind, fam] = sim
    return out


def _jax_model(kind, fam):
    cls, geom = (JaxViT, VIT) if kind == "vit" else (JaxSwin, SWIN)
    return cls(gelu_type=fam, softmax_type=fam, layernorm_type=fam, **geom)


def _jax_spec(spec):
    d = dataclasses.asdict(spec.config)
    d["bitwidths"] = JaxBitWidths(*spec.config.bitwidths.to_list())
    params = jax.tree.map(jnp.asarray, spec.params)
    if isinstance(spec, tswin.SwinEngineSpec):
        return jswin.SwinEngineSpec(jswin.SwinEngineConfig(**d), params)
    return JaxSpec(JaxConfig(**d), params)


def _port_rows(sim, x):
    tio.clear_io_stats()
    tio.attach_io_stats(sim)(torch.from_numpy(x))
    return tio.get_io_stats()


class _JitApply:
    """A JAX model whose ``apply`` (the one call ``attach_io_stats`` makes) is
    jitted: eager flax costs 20-40 s a model here; the captured values are
    the eager ones, bitwise (checked against the port, which equals the
    eager sim)."""

    def __init__(self, model):
        self._apply = jax.jit(lambda v, a: model.apply(
            v, a, running_stat=False, capture_intermediates=True,
            mutable=["intermediates"]))

    def apply(self, variables, x, **_):
        return self._apply(variables, x)


def _jax_rows(kind, fam, sim, x):
    jio.clear_io_stats()
    variables = jax.tree.map(jnp.asarray, variables_to_numpy(sim))
    jio.attach_io_stats(_JitApply(_jax_model(kind, fam)), variables)(jnp.asarray(x))
    return [dict(r) for r in jio._LAYER_IO_STATS]


def test_io_stats_rows_and_csv_match_jax(sims, tmp_path):
    kind, fam = "vit", "ibert"
    sim, x = sims[kind, fam], _images(kind)
    got, want = _port_rows(sim, x), _jax_rows(kind, fam, sim, x)
    assert [r["layer"] for r in got] == [r["layer"] for r in want]
    assert len(got) > 40
    for g, w in zip(got, want):
        assert list(g) == list(w), w["layer"]
        for k, v in w.items():
            assert g[k] == v or (v != v and g[k] != g[k]), (w["layer"], k, g[k], v)
    tio.save_io_stats(str(tmp_path / "port.csv"))
    jio.save_io_stats(str(tmp_path / "jax.csv"))
    assert (tmp_path / "port.csv").read_text() == (tmp_path / "jax.csv").read_text()


def test_io_stats_swin_rows_in_jax_order(sims):
    """The Swin sim's rows: flax names (``layers_0_blocks_1/attn/qkv``), in
    the sorted-path order of JAX's walk (a module before its children)."""
    rows = _port_rows(sims["swin", "ivit"], _images("swin", n=1))
    layers = [r["layer"] for r in rows]
    assert layers == sorted(layers, key=lambda p: tuple(p.split("/")) + ("__call__",))
    assert {"layers_0_blocks_1/attn/qkv", "layers_0_downsample/reduction",
            "patch_embed/qact_before_norm"} <= set(layers)
    assert len(layers) == len(set(layers)) > 90


def test_io_stats_switch_and_pickle(sims, tmp_path):
    sim, x = sims["vit", "ivit"], _images("vit", n=1)
    tio.clear_io_stats()
    tio.disable_io_stats()
    try:
        tio.attach_io_stats(sim)(torch.from_numpy(x))
    finally:
        tio.enable_io_stats()
    assert tio.get_io_stats() == []
    rows = _port_rows(sim, x)
    assert rows and {r["type"] for r in rows} >= {"qkv", "act", "int_softmax", "qact_input"}
    with pytest.raises(ValueError, match="CSV only"):
        tio.save_io_stats(str(tmp_path / "io.pkl"))
    tio.clear_io_stats()
    assert tio.get_io_stats() == []


def _jax_audit(fwd, jspec, x):
    """JAX's engine under its taps, jitted as JAX's ``analyze_io_stats``
    runs it (the taps fire while tracing; their extrema are outputs):
    (logits, records with floats)."""
    meta = []

    @jax.jit
    def run(xx):
        with jvit.audit_capture() as recs:
            logits = fwd(jspec, xx, pallas=False)
        meta[:] = [{k: v for k, v in r.items() if k not in ("min", "max", "sat_frac")}
                   for r in recs]
        return logits, [{k: r[k] for k in ("min", "max", "sat_frac") if k in r}
                        for r in recs]

    logits, vals = jax.device_get(run(jnp.asarray(x)))
    return np.asarray(logits), [{**m, **{k: float(v) for k, v in n.items()}}
                                for m, n in zip(meta, vals)]


def _read(records):
    return [{k: (float(v) if isinstance(v, (torch.Tensor, jax.Array)) else v)
             for k, v in r.items()} for r in records]


@pytest.mark.parametrize("kind,fam", CASES, ids=IDS)
def test_audit_records_match_jax(sims, kind, fam):
    sim = sims[kind, fam]
    spec = freeze_model(sim) if kind == "vit" else tswin.freeze_swin_model(sim)
    x = _images(kind, seed=7)
    fwd, jfwd = ((tvit.engine_forward, jvit.engine_forward) if kind == "vit" else
                 (tswin.swin_engine_forward, jswin.swin_engine_forward))
    with tvit.audit_capture() as recs:
        got_logits = fwd(spec, x, kernels=False, device="cpu")
    assert tvit._AUDIT is None
    assert all(isinstance(r["min"], torch.Tensor) for r in recs)   # read lazily
    want_logits, want = _jax_audit(jfwd, _jax_spec(spec), x)
    np.testing.assert_array_equal(got_logits.numpy(), want_logits)
    got = _read(recs)
    assert [r["site"] for r in got] == [r["site"] for r in want]
    assert len(got) > 20
    for g, w in zip(got, want):
        assert g == w, (g, w)
    kinds = {r["kind"] for r in got}
    assert {"gemm_acc", "requant8"} <= kinds
    assert ("exp_sum" in kinds) == (fam == "ibert")
    assert ("ln_centered" in kinds) == (fam == "ivit")
    assert ("residual8" in kinds) == (kind == "vit")
    assert tvit.audit_violations([r for r in recs if "sat_frac" not in r]) == []
    # no capture: no record, the same logits
    assert torch.equal(fwd(spec, x, kernels=False, device="cpu"), got_logits)


def _cfg(kind, mix):
    gelu, softmax, ln = mix
    base = dict(gelu_type=gelu, softmax_type=softmax, layernorm_type=ln,
                bitwidths=JaxBitWidths())
    if kind == "vit":
        return tvit.EngineConfig(img_size=64, patch_size=16, embed_dim=64, depth=2,
                                 num_heads=2, mlp_ratio=4.0, num_classes=10, **base)
    return tswin.SwinEngineConfig(img_size=56, patch_size=4, embed_dim=32, depth=4,
                                  num_heads=2, mlp_ratio=4.0, num_classes=10,
                                  depths=(2, 2), stage_heads=(2, 4), **base)


def _jax_cfg(cfg):
    d = dataclasses.asdict(cfg)
    d["bitwidths"] = JaxBitWidths(*cfg.bitwidths.to_list())
    return (jswin.SwinEngineConfig if "depths" in d else JaxConfig)(**d)


MIXES = [("ivit", "ivit", "ivit"), ("ibert", "ibert", "ibert"), ("float", "ivit", "ivit"),
         ("ivit", "float", "ibert")]


@pytest.mark.parametrize("mix", MIXES, ids=["/".join(m) for m in MIXES])
def test_fusion_reports_match_jax(mix):
    cfg = _cfg("vit", mix)
    got, want = tvit.fusion_report(cfg, True), jvit.fusion_report(_jax_cfg(cfg), True)
    assert list(got) == list(want)
    assert bool(got["unfused_reasons"]) == bool(want["unfused_reasons"])
    if "float" in mix:
        # JAX's unfused branch would still take the Pallas Shiftmax /
        # ShiftGELU there; the port's runs the towers (its routing)
        assert not got["fused_blocks"] and not want["fused_blocks"]
        assert not got["fused_softmax"] and not got["fused_gelu"]
    else:
        assert got == {**want, "unfused_reasons": got["unfused_reasons"]}
    off = tvit.fusion_report(cfg, False)
    assert not off["fused_blocks"] and off["unfused_reasons"]
    ops = tvit.fusion_report(cfg, "ops")
    assert not ops["fused_blocks"] and ops["fused_softmax"] == (mix[1] == "ivit")

    cfg = _cfg("swin", mix)
    got = tswin.swin_fusion_report(cfg, True)
    want = jswin.swin_fusion_report(_jax_cfg(cfg), True)
    assert list(got) == list(want)
    for key in ("fused_window_attention", "fused_attn_stages", "lut_nonlinearities"):
        assert got[key] == want[key], key
    assert list(got["fused_mlp_stages"].values()) == list(want["fused_mlp_stages"].values())
    assert [k.split(" ")[0] for k in want["fused_mlp_stages"]] == list(got["fused_mlp_stages"])
    mixed = tswin.swin_fusion_report(cfg, True, stage_paths=(True, False))
    assert mixed["fused_attn_stages"][1] is False


def test_engine_fusion_attribute(sims):
    spec = freeze_model(sims["vit", "ivit"])
    for kernels in (True, "ops", False):
        eng = Engine(spec, device="cpu", kernels=kernels)
        assert eng.fusion["fused_blocks"] == (kernels is True)
        assert eng.fusion["path_choice"]["kernels"] == repr(kernels)
    swin = Engine(tswin.freeze_swin_model(sims["swin", "ibert"]), device="cpu",
                  stage_paths=(False, True))
    assert swin.fusion["fused_attn_stages"] == [False, True]
    assert swin.fusion["path_choice"]["stage_paths"] == (False, True)
