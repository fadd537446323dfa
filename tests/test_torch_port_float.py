"""The float family (the golden softmax and GELU with a quantized output) in
the port's ViT and Swin engines, against the JAX package.

JAX's engines run ``jax.nn.softmax`` / ``jax.nn.gelu(approximate=False)``
on the dequantized input, then floor and clip the result onto the integer
grid (``ivit_tpu/engine/vit_int.py:345-348, 431-434``); the port runs
``torch.softmax`` in f32 and ``F.gelu(approximate="none")`` with the same
floor and clip.  This is the one tolerance the port allows itself: torch's
and XLA's f32 ``exp`` / ``erf`` may differ in the last ulp, and the floor
then moves a quantized probability or GELU output by at most 1, on a few
elements.  So:

* the quantized probabilities (8 and 16 bits) and GELU outputs of the two
  frameworks differ by at most ``INT_TOL`` = 1, on at most ``INT_SHARE`` of
  the elements;
* the logits of the port's unfused engine and JAX's differ by at most
  ``LOGIT_TOL`` of the largest logit magnitude: a flipped probability or
  GELU output moves a few int8 activations downstream by one step, each of
  which moves a logit by a few steps of the head's output scale;
* every other path of the port runs the float family as JAX routes it, and
  is held to the port's unfused engine with tolerance 0: ``kernels=True``
  and ``"ops"`` take the unfused ViT forward, and a fused Swin stage fuses
  only the half-block whose nonlinearity has a kernel;
* the float LayerNorm still raises, in both engines.

The models: a 64 px ViT of depth 2 (``tests/test_engine.py``'s geometry)
and a one-stage 56 px Swin (``tests/test_swin_engine.py``'s stage 0, a
shifted block included), float softmax and GELU with the ivit LayerNorm,
frozen by JAX and calibrated on the batch of their init.
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
from test_torch_port_engine import _images, _to_port  # noqa: E402
from test_torch_port_swin import _to_port as _to_port_swin  # noqa: E402

from ivit_tpu.engine import freeze_model  # noqa: E402
from ivit_tpu.engine import swin_int as jswin  # noqa: E402
from ivit_tpu.engine import vit_int as jvit  # noqa: E402
from ivit_tpu.engine.freeze import EngineSpec as JaxSpec  # noqa: E402
from ivit_tpu.models import VisionTransformer  # noqa: E402
from ivit_tpu.models.swin import SwinTransformer  # noqa: E402
from ivit_tpu_torch.engine import Engine, engine_forward, swin_engine_forward  # noqa: E402
from ivit_tpu_torch.engine import vit_int as tvit  # noqa: E402
from ivit_tpu_torch.models import BitWidths  # noqa: E402

INT_TOL = 1           # a quantized probability or GELU output, in its steps
INT_SHARE = 1e-3      # of the elements that may differ at all
LOGIT_TOL = 0.05      # of the largest logit magnitude
FLOAT = dict(gelu_type="float", softmax_type="float", layernorm_type="ivit")


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _init(model, x0):
    return jax.jit(lambda a: model.init(jax.random.PRNGKey(0), a,
                                        running_stat=True))(jnp.asarray(x0))


@pytest.fixture(scope="module")
def vit():
    model = VisionTransformer(img_size=64, patch_size=16, embed_dim=64, depth=2,
                              num_heads=2, num_classes=10, **FLOAT)
    return freeze_model(model, _init(model, _images(4, 64, seed=0)))


@pytest.fixture(scope="module")
def swin():
    model = SwinTransformer(img_size=56, patch_size=4, embed_dim=32, depths=(2,),
                            num_heads=(2,), window_size=7, num_classes=10,
                            drop_path_rate=0.0, **FLOAT)
    return jswin.freeze_swin_model(model, _init(model, _images(2, 56, seed=0)))


def _close_ints(got, want):
    got, want = np.asarray(got, np.int64), np.asarray(want, np.int64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= INT_TOL
    assert (got != want).mean() <= INT_SHARE


def _close_logits(got, want):
    want = np.asarray(want)
    assert np.isfinite(want).all()
    assert np.abs(np.asarray(got) - want).max() <= LOGIT_TOL * np.abs(want).max()


# --- (a) the quantized softmax and GELU ------------------------------------------

@pytest.mark.parametrize("bits", [8, 16])
def test_float_softmax_and_gelu_match_jax(vit, bits):
    """Every int8 score over rows of 197 keys at the freeze's score scale,
    ``bits``-bit probabilities; the GELU + requant over every int8 input."""
    blk_np = jax.device_get(vit.params)["blocks"][0]
    jcfg = dataclasses.replace(vit.config, bitwidths=dataclasses.replace(
        vit.config.bitwidths, softmax=bits))
    cfg = dataclasses.replace(_to_port(vit).config, bitwidths=dataclasses.replace(
        BitWidths(), softmax=bits))
    blk = {k: torch.as_tensor(np.array(v)) for k, v in blk_np.items()}
    scores = np.random.default_rng(1).integers(-128, 128, (64, 2, 197, 197))
    scores = scores.astype(np.float32)
    want = jvit._softmax_int(jcfg, blk_np, jnp.asarray(scores), pallas=False)
    got = tvit._softmax_int(cfg, blk, torch.from_numpy(scores))
    assert got.dtype == (torch.int8 if bits == 8 else torch.int16)
    _close_ints(got.numpy(), want)
    x = np.tile(np.arange(-128, 128, dtype=np.float32), (16, 1))
    want = jvit._gelu_requant_int(jcfg, blk_np, jnp.asarray(x), 8, pallas=False)
    _close_ints(tvit._gelu_requant_int(cfg, blk, torch.from_numpy(x), 8).numpy(),
                want)


# --- (b) the engines -----------------------------------------------------------------

def test_float_vit_engine_matches_jax(vit):
    """The port's unfused ViT engine against JAX ``pallas=False`` within the
    logit bound; ``kernels=True`` and ``"ops"`` are its unfused forward."""
    x = _images(8, 64, seed=4)
    want = np.asarray(jax.jit(lambda p, a: jvit.engine_forward(
        JaxSpec(vit.config, p), a, pallas=False))(vit.params, jnp.asarray(x)))
    spec = _to_port(vit)
    got = engine_forward(spec, x, kernels=False, device="cpu")
    _close_logits(got.numpy(), want)
    for path in (True, "ops"):
        eng = Engine(spec, device="cpu", kernels=path)
        assert eng.mlp_wt is None                   # no fused MLP to feed
        _eq(eng(x), got)


def test_float_swin_engine_matches_jax(swin):
    """The port's unfused Swin engine against JAX ``pallas=False`` within
    the logit bound; ``kernels=True`` equals it; with an ivit GELU on the
    same leaves the fused stage runs the MLP half on its kernel and the
    float-softmax attention half unfused, and still equals the unfused
    engine."""
    x = _images(4, 56, seed=4)
    want = np.asarray(jax.jit(lambda p, a: jswin.swin_engine_forward(
        jswin.SwinEngineSpec(swin.config, p), a, pallas=False))(
            swin.params, jnp.asarray(x)))
    spec = _to_port_swin(swin)
    assert any(shift for _, _, shift in spec.config.layout)
    got = swin_engine_forward(spec, x, kernels=False, device="cpu")
    _close_logits(got.numpy(), want)
    _eq(Engine(spec, device="cpu")(x), got)
    mixed = type(spec)(dataclasses.replace(spec.config, gelu_type="ivit"),
                       spec.params)
    assert tvit.fused_halves(mixed.config) == (False, True)
    eng = Engine(mixed, device="cpu")
    assert eng.mlp_wt is not None
    _eq(eng(x), swin_engine_forward(mixed, x, kernels=False, device="cpu"))


def test_float_layernorm_still_raises(vit, swin):
    for spec, fwd, x in ((_to_port(vit), engine_forward, _images(1, 64)),
                         (_to_port_swin(swin), swin_engine_forward, _images(1, 56))):
        bad = type(spec)(dataclasses.replace(spec.config, layernorm_type="float"),
                         spec.params)
        with pytest.raises(NotImplementedError, match="no float LayerNorm"):
            Engine(bad, device="cpu", kernels=False)
        with pytest.raises(NotImplementedError, match="no float LayerNorm"):
            fwd(bad, x, kernels=False, device="cpu")
