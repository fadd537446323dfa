"""The freeze-time table forms of the port's block kernels and engines, and
the fused integer-sqrt LayerNorm, bit-exact (tolerance 0).

* ViT (64 px specs: ivit, ibert, and a fitted ppoly model) and Swin (56
  px, with a shifted block that carries ``sm_sat``, ivit and ibert), each
  the port's sim calibrated and frozen by the port, whose spec the
  freeze tests hold to JAX's leaf for leaf: with ``IVIT_LUT`` set the
  port's fused plain path equals it with the switch unset, and with
  ``IVIT_XLA_LUT`` too its unfused engine does; the unfused table path
  equals JAX's ``engine_forward(pallas=False)`` under both switches, and
  the ivit ViT's fused path JAX's interpret-mode kernels under
  ``IVIT_LUT=1`` (as ``tests/test_lut.py`` runs them);
* a changed ``sm_lut`` / ``gelu_lut`` / ``sm_sat`` entry moves the port's
  table path as it moves JAX's, and away from the towers: the tables are
  read;
* the fused plain LN with ``use_int_sqrt`` equals the unfused engine's at
  the variances where I-BERT's integer sqrt and floor(sqrt) differ, and
  the integer sqrt's seed matches JAX's.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_port_engine import _images, _to_jax  # noqa: E402
from test_torch_port_swin import _to_jax as _swin_to_jax  # noqa: E402

import ivit_tpu.ops.pallas as ppkg  # noqa: E402
from ivit_tpu.engine import swin_int as jswin  # noqa: E402
from ivit_tpu.engine import vit_int as jvit  # noqa: E402
from ivit_tpu.ops import ibert as jib  # noqa: E402
from ivit_tpu_torch.engine import (engine_forward, freeze_swin_model,  # noqa: E402
                                   swin_engine_forward)
from ivit_tpu_torch.engine import vit_int as tvit  # noqa: E402
from ivit_tpu_torch.engine.convert import params_to_torch  # noqa: E402
from ivit_tpu_torch.engine.freeze import freeze_model  # noqa: E402
from ivit_tpu_torch.models import SwinTransformer, VisionTransformer  # noqa: E402
from ivit_tpu_torch.models.model_utils import freeze_model as fit_tables  # noqa: E402
from ivit_tpu_torch.ops import ibert as tib  # noqa: E402
from ivit_tpu_torch.ops.kernels import block as kb  # noqa: E402

PPOLY = "ppoly_backend_ibert"
VIT_FAMS = ["ivit", "ibert", "ppoly"]
SWIN_FAMS = ["ivit", "ibert"]
# ibert LN variances where I-BERT's integer sqrt and floor(sqrt) differ
INT_SQRT_VARS = [3, 15, 63, 80, 99]


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's CPU forwards: Tier-1 runs six
    workers at once (the integer paths' bits do not depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def lut_env(monkeypatch):
    """``set_lut(fused, unfused)``: the two switches, as JAX reads them."""
    def set_lut(fused, unfused=False):
        for name, on in (("IVIT_LUT", fused), ("IVIT_XLA_LUT", unfused)):
            if on:
                monkeypatch.setenv(name, "1")
            else:
                monkeypatch.delenv(name, raising=False)
    yield set_lut
    set_lut(False)


def _calibrate(model, img, seed=0):
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for _ in range(2):
            model(torch.from_numpy(rng.normal(size=(2, img, img, 3)).astype(np.float32)),
                  running_stat=True)
    return fit_tables(model)


@pytest.fixture(scope="module")
def vit():
    """The port's 64 px ViT sims (``tests/test_engine.py``'s geometry: depth
    2, embed 64, 2 heads; ppoly at depth 1, ibert LN, its tables fitted),
    calibrated on two seeded batches and frozen with their tables by the
    port's freeze, which gives JAX's leaves (``test_torch_port_freeze.py``,
    ``_ppoly.py``): (JAX spec, port spec) a family."""
    out = {}
    for fam, ln, depth in (("ivit", "ivit", 2), ("ibert", "ibert", 2),
                           (PPOLY, "ibert", 1)):
        model = VisionTransformer(img_size=64, patch_size=16, embed_dim=64,
                                  depth=depth, num_heads=2, num_classes=10,
                                  gelu_type=fam, softmax_type=fam,
                                  layernorm_type=ln, device="cpu", seed=0)
        spec = freeze_model(_calibrate(model, 64))
        assert spec.config.use_lut and "gelu_lut" in spec.params["blocks"][0]
        out[fam.split("_")[0]] = (_to_jax(spec), spec)
    return out


@pytest.fixture(scope="module")
def swin():
    """The port's 56 px Swin sims (``test_torch_port_swin_freeze.py``'s
    geometry: depths (2, 2), stage 0's second block shifted, carrying
    ``sm_sat``), ivit and ibert, calibrated and frozen by the port."""
    out = {}
    for fam in SWIN_FAMS:
        model = SwinTransformer(img_size=56, patch_size=4, embed_dim=32,
                                depths=(2, 2), num_heads=(2, 4), window_size=7,
                                num_classes=10, gelu_type=fam, softmax_type=fam,
                                layernorm_type=fam, device="cpu", seed=0)
        spec = freeze_swin_model(_calibrate(model, 56))
        assert spec.config.use_lut
        shifted = [b for (kind, _, sh), b in zip(spec.config.layout,
                                                 spec.params["blocks"])
                   if kind == "block" and sh > 0]
        assert shifted and all("sm_sat" in b for b in shifted)
        out[fam] = (_swin_to_jax(spec), spec)
    return out


def _jax(fwd, jspec, x, pallas):
    """JAX's logits, jitted as ``tests/test_lut.py`` runs them (the switches
    are read while tracing); the Pallas kernels in interpret mode."""
    ppkg.FORCE_INTERPRET = True
    try:
        return np.asarray(jax.jit(lambda a: fwd(jspec, a, pallas=pallas))(
            jnp.asarray(x)))
    finally:
        ppkg.FORCE_INTERPRET = False


class _Spy:
    """Counts the calls of a plain table form (and runs it)."""

    def __init__(self, monkeypatch, name):
        self.calls, fn = 0, getattr(kb, name)

        def spy(*a, **k):
            self.calls += 1
            return fn(*a, **k)
        monkeypatch.setattr(kb, name, spy)


def _spies(monkeypatch):
    return _Spy(monkeypatch, "softmax_lut"), _Spy(monkeypatch, "gelu_lut_int")


def _paths(fwd, spec, x, lut_env, monkeypatch):
    """{(kernels, switch on): logits} of the fused plain path and the unfused
    engine, the table forms off and on; the table forms ran where on."""
    out = {}
    for kernels in (True, False):
        for on in (False, True):
            lut_env(on, on)
            sm, gelu = _spies(monkeypatch)
            out[kernels, on] = fwd(spec, x, kernels=kernels, device="cpu").numpy()
            assert (sm.calls > 0 and gelu.calls > 0) == on, (kernels, on)
    lut_env(False)
    return out


@pytest.mark.parametrize("fam", VIT_FAMS)
def test_vit_lut_on_equals_off_and_jax(vit, fam, lut_env, monkeypatch):
    jspec, spec = vit[fam]
    x = _images(3, 64, seed=5)
    got = _paths(engine_forward, spec, x, lut_env, monkeypatch)
    want = got[False, False]
    for key, logits in got.items():
        _eq(logits, want)
    lut_env(True, True)
    _eq(_jax(jvit.engine_forward, jspec, x, pallas=False), want)


@pytest.mark.parametrize("fam", SWIN_FAMS)
def test_swin_lut_on_equals_off_and_jax(swin, fam, lut_env, monkeypatch):
    jspec, spec = swin[fam]
    x = _images(2, 56, seed=6)
    got = _paths(swin_engine_forward, spec, x, lut_env, monkeypatch)
    want = got[False, False]
    for key, logits in got.items():
        _eq(logits, want)
    lut_env(True, True)
    _eq(_jax(jswin.swin_engine_forward, jspec, x, pallas=False), want)


def test_vit_fused_lut_matches_jax_interpret(vit, lut_env):
    """The ivit ViT's fused plain path against JAX's Pallas kernels in
    interpret mode, both under ``IVIT_LUT=1`` (jitted, as
    ``tests/test_lut.py:_forward_lut_ab`` runs them)."""
    jspec, spec = vit["ivit"]
    assert jspec.config.sm_sum_i32
    x = _images(2, 64, seed=7)
    lut_env(True)
    want = _jax(jvit.engine_forward, jspec, x, pallas=True)
    _eq(engine_forward(spec, x, kernels=True, device="cpu").numpy(), want)


def _changed(jspec, spec, edits):
    """Copies of both specs with ``edits`` ({(block, leaf): fn}) applied to
    the same leaves."""
    jblocks = [dict(b) for b in jspec.params["blocks"]]
    tblocks = [dict(b) for b in spec.params["blocks"]]
    for (i, leaf), fn in edits.items():
        new = np.asarray(fn(np.array(jax.device_get(jblocks[i][leaf]), np.float32)),
                         np.float32)
        jblocks[i][leaf] = jnp.asarray(new)
        tblocks[i][leaf] = torch.from_numpy(new)
    return (dataclasses.replace(jspec, params={**jspec.params, "blocks": jblocks}),
            dataclasses.replace(spec, params={**spec.params, "blocks": tblocks}))


def _bump(i, by):
    def fn(t):
        t = t.copy()
        t.reshape(-1)[i] += by
        return t
    return fn


def test_changed_tables_are_read(vit, swin, lut_env):
    """One entry of block 0's ``sm_lut`` (the row max's exp) and of its
    ``gelu_lut`` (ShiftGELU's exp at the row max) halved, and a shifted Swin
    block's ``sm_sat`` raised to the row max's exp: the port's table paths
    equal JAX's on the changed spec, and differ from the towers."""
    x = _images(2, 64, seed=8)
    jspec, spec = _changed(*vit["ivit"], {
        (0, "sm_lut"): lambda t: _bump(0, -t[0] // 2)(t),
        (0, "gelu_lut"): lambda t: _bump(0, -t[0] // 2)(t)})
    lut_env(False)
    towers = engine_forward(spec, x, kernels=False, device="cpu").numpy()
    lut_env(True, True)
    want = _jax(jvit.engine_forward, jspec, x, pallas=False)
    for kernels in (False, True):
        _eq(engine_forward(spec, x, kernels=kernels, device="cpu").numpy(), want)
    assert (want != towers).any()

    js, ts = swin["ivit"]
    shifted = next(i for i, (kind, _, sh) in enumerate(js.config.layout)
                   if kind == "block" and sh > 0)
    top = float(ts.params["blocks"][shifted]["sm_lut"][0])    # the row max's exp
    js, ts = _changed(js, ts, {(shifted, "sm_sat"): lambda t: t * 0 + top})
    xs = _images(2, 56, seed=9)
    lut_env(False)
    towers = swin_engine_forward(ts, xs, kernels=True, device="cpu").numpy()
    lut_env(True)
    got = swin_engine_forward(ts, xs, kernels=True, device="cpu").numpy()
    assert (got != towers).any()
    # JAX's unfused engine keeps the towers on shifted blocks, its fused
    # kernels read sm_sat: the interpret-mode kernels are the reference
    _eq(got, _jax(jswin.swin_engine_forward, js, xs, pallas=True))


def _var_rows(c):
    """int8 rows of ``c`` channels whose ibert LN, shift 0, has the
    variances INT_SQRT_VARS (mean 0: ones, +-1, +-2, +-3 and +-1)."""
    rows = np.zeros((len(INT_SQRT_VARS), c), np.int8)
    rows[0, :3] = 1
    rows[1, :15] = 1
    rows[2, :63] = np.resize([1, -1], 63)
    rows[3, :20] = np.resize([2, -2], 20)
    rows[4, :9] = np.resize([3, -3], 9)
    rows[4, 9:27] = np.resize([1, -1], 18)
    return rows


def test_fused_int_sqrt_ln_matches_unfused(vit):
    """The fused plain half-blocks with ``use_int_sqrt`` against the unfused
    engine's (JAX's kernels ignore the flag), on rows whose LN variances
    are where the two sqrt forms differ; the LN outputs differ from
    floor(sqrt)'s there."""
    jspec, spec = vit["ibert"]
    cfg = dataclasses.replace(spec.config, layernorm_type="ibert_use-int-sqrt_true")
    assert tvit._use_int_sqrt(cfg)
    blk = params_to_torch(spec.params, "cpu")["blocks"][0]
    # shift 0, and LN multipliers an eighth of the freeze's, under which
    # these rows' LN outputs stay inside int8
    blk = {**blk, "ln1_shift": torch.tensor(0.0), "ln2_shift": torch.tensor(0.0),
           "m_ln1": blk["m_ln1"] / 8, "m_ln2": blk["m_ln2"] / 8}
    c = cfg.embed_dim
    x = torch.from_numpy(_var_rows(c))
    ln_args = (blk["ln2_bias_int"], blk["ln2_shift"], blk["m_ln2"], None)
    var = tib.exact_sq_sum(x.float() - torch.round(x.float().mean(-1, keepdim=True)))
    _eq(var[:, 0], INT_SQRT_VARS)
    int_ln = kb._ln8(x, "ibert", *ln_args, use_int_sqrt=True)
    assert (int_ln != kb._ln8(x, "ibert", *ln_args)).any(-1).all()
    _eq(int_ln, tvit._ln_requant(tvit._layernorm_int(
        cfg, x, blk["ln2_bias_int"], blk["ln2_shift"]), blk["m_ln2"], 8))

    mlp = tvit._mlp_fused(cfg, blk, x[None], True)
    _eq(mlp, tvit._mlp_unfused(cfg, blk, x[None], False))
    xa = torch.cat([x, x.flip(0)])[None]          # one image of 10 tokens
    _eq(tvit._attn_fused(cfg, blk, xa, True), tvit._attn_unfused(cfg, blk, xa, False))


def test_int_sqrt_seed_matches_jax():
    """The integer sqrt's bit-length seed (exact, :func:`floor_log2_rn`)
    gives JAX's roots near every power of two, where f32 ``log2`` rounds
    up to it, and on random variances; torch's CPU ``log2`` floors alike."""
    n = np.concatenate([2.0**k - np.arange(-64, 4096) for k in range(1, 34)]
                       + [np.random.default_rng(0).integers(1, 2**33, 20000)])
    n = np.unique(np.asarray(n[n >= 1], np.float32))
    _eq(tib.floor_log2_rn(torch.from_numpy(n)), torch.floor(torch.log2(torch.from_numpy(n))))
    _eq(tib.int_bitlength_sqrt(torch.from_numpy(n)), jib.int_bitlength_sqrt(jnp.asarray(n)))
