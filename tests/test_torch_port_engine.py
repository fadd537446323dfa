"""The port's engine bit-exact against the JAX engine.

* 64 px, real JAX freezes (ibert, and ibert with the integer-sqrt LN): the
  port's unfused engine against JAX ``engine_forward(pallas=False)``, and
  the port's fused path (plain kernels on the CPU) against JAX
  ``engine_forward(pallas=True)`` in interpret mode;
* DeiT-S width at 224 px: a seeded synthetic spec, handed to both
  frameworks, through JAX's unfused engine and both port paths;
* the synthetic spec has the exact tree a JAX freeze emits.
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
from test_engine import build_calibrated  # noqa: E402

import ivit_tpu.ops.pallas as ppkg  # noqa: E402
from ivit_tpu.engine import freeze_model  # noqa: E402
from ivit_tpu.engine.freeze import EngineConfig as JaxConfig  # noqa: E402
from ivit_tpu.engine.freeze import EngineSpec as JaxSpec  # noqa: E402
from ivit_tpu.engine.vit_int import engine_forward as jax_forward  # noqa: E402
from ivit_tpu.models import BitWidths as JaxBitWidths  # noqa: E402
from ivit_tpu_torch.engine import EngineConfig, EngineSpec, engine_forward  # noqa: E402
from ivit_tpu_torch.engine.convert import params_to_torch  # noqa: E402
from ivit_tpu_torch.engine.synthetic import deit_small_config, synthetic_spec  # noqa: E402
from ivit_tpu_torch.models import BitWidths  # noqa: E402

LUT_KEYS = {"sm_lut", "gelu_lut"}


@pytest.fixture(scope="module")
def calibrated():
    return build_calibrated(np.random.default_rng(0), gelu="ibert",
                            softmax="ibert", ln="ibert", calib_batches=1)


def _jax_freeze(calibrated, ln):
    model, variables = calibrated
    return freeze_model(model.clone(layernorm_type=ln), variables)


def _to_port(jspec):
    d = dataclasses.asdict(jspec.config)
    d["bitwidths"] = BitWidths(*jspec.config.bitwidths.to_list())
    return EngineSpec(EngineConfig(**d),
                      params_to_torch(jax.device_get(jspec.params), "cpu"))


def _to_jax(spec):
    d = dataclasses.asdict(spec.config)
    d["bitwidths"] = JaxBitWidths(*spec.config.bitwidths.to_list())
    return JaxSpec(JaxConfig(**d), jax.tree.map(jnp.asarray, spec.params))


def _images(n, img, seed=1):
    return np.random.default_rng(seed).normal(size=(n, img, img, 3)).astype(np.float32)


@pytest.mark.parametrize("ln", ["ibert", "ibert_use-int-sqrt_true"])
def test_unfused_engine_matches_jax(calibrated, ln):
    jspec = _jax_freeze(calibrated, ln)
    x = _images(3, 64)
    want = np.asarray(jax_forward(jspec, jnp.asarray(x), pallas=False))
    got = engine_forward(_to_port(jspec), x, kernels=False, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("ln", ["ibert", "ibert_use-int-sqrt_true"])
def test_fused_engine_matches_jax_pallas(calibrated, ln):
    """JAX's fused engine (Pallas, interpret mode) against the port's.

    With ``use_int_sqrt`` the Pallas kernel takes floor(sqrt) all the same
    (``block.py:628-643``) and the port's fused wrapper refuses the flag, so
    that case holds JAX's fused output against the port's unfused engine:
    on this input no LN variance lands where the two sqrt forms differ."""
    jspec = _jax_freeze(calibrated, ln)
    x = _images(3, 64, seed=2)
    ppkg.FORCE_INTERPRET = True
    try:
        want = np.asarray(jax_forward(jspec, jnp.asarray(x), pallas=True))
    finally:
        ppkg.FORCE_INTERPRET = False
    got = engine_forward(_to_port(jspec), x, kernels=ln == "ibert", device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_deit_small_width_synthetic_matches_jax():
    spec = synthetic_spec(deit_small_config(depth=1), seed=0)
    x = _images(2, 224, seed=3)
    want = np.asarray(jax_forward(_to_jax(spec), jnp.asarray(x), pallas=False))
    unfused = engine_forward(spec, x, kernels=False, device="cpu")
    fused = engine_forward(spec, x, kernels=True, device="cpu")
    np.testing.assert_array_equal(unfused.numpy(), want)
    np.testing.assert_array_equal(fused.numpy(), want)
    assert np.isfinite(want).all() and want.std(axis=0).max() > 0


def _tree(params):
    out = {}
    for k, v in params.items():
        if k == "blocks":
            for kk, vv in v[0].items():
                out["blocks/" + kk] = vv
        elif isinstance(v, dict):
            for kk, vv in v.items():
                out[k + "/" + kk] = vv
        else:
            out[k] = v
    return {k: (np.asarray(v).dtype, np.asarray(v).shape)
            for k, v in out.items() if k.split("/")[-1] not in LUT_KEYS}


def test_synthetic_spec_has_the_freeze_tree(calibrated):
    jspec = _jax_freeze(calibrated, "ibert")
    want = _tree(jax.device_get(jspec.params))
    small = synthetic_spec(_to_port(jspec).config, seed=0)
    assert _tree(small.params) == want
    assert len(small.params["blocks"]) == len(jspec.params["blocks"])
    jc, sc = dataclasses.asdict(jspec.config), dataclasses.asdict(small.config)
    for k in ("bitwidths", "use_lut"):      # BitWidths types differ; no LUTs
        jc.pop(k), sc.pop(k)
    assert sc == jc

    # DeiT-S at depth 12: the same keys and dtypes, shapes at its widths
    full = synthetic_spec(deit_small_config(), seed=0)
    assert len(full.params["blocks"]) == 12
    dims = {64: 384, 192: 1152, 256: 1536, 17: 197, 10: 1000}
    scaled = {k: (dt, tuple(dims.get(d, d) for d in shp))
              for k, (dt, shp) in want.items()}
    assert _tree(full.params) == scaled
