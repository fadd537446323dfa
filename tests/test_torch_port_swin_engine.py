"""The port's Swin engine on real JAX freezes, bit-exact against the JAX
package (tolerance 0).

* the engine on JAX freezes of the geometry of ``tests/test_swin_engine.py``
  (56 px, embed 32, depths (2, 2), heads (2, 4), window 7: a shifted
  stage-0 block, a merge, a stage 1 with res = ws), for ivit, ibert and one
  mix: ``kernels=False`` against JAX ``pallas=False``, ``kernels=True``
  (the plain versions on the CPU) against JAX ``pallas=True`` in interpret
  mode, every ``stage_paths`` mask against the unfused engine;
* the artifact round trip both ways, and ``params_to_torch`` on the JAX
  Swin tree (lists of dicts with ``merge`` entries);
* the synthetic Swin spec has a JAX freeze's tree and layout.
"""

import dataclasses
import itertools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_swin_engine import build_swin  # noqa: E402
from test_torch_port_engine import LUT_KEYS, _images  # noqa: E402
from test_torch_port_loader import _assert_same_tree  # noqa: E402
from test_torch_port_swin import IBERT, IVIT, _eq, _to_port  # noqa: E402

import ivit_tpu.ops.pallas as ppkg  # noqa: E402
from ivit_tpu.engine import swin_int as jswin  # noqa: E402
from ivit_tpu.engine.export import load_engine as jax_load_engine  # noqa: E402
from ivit_tpu.engine.export import save_engine as jax_save_engine  # noqa: E402
from ivit_tpu_torch.engine import (Engine, SwinEngineSpec, load_engine,  # noqa: E402
                                   save_engine, swin_engine_forward)
from ivit_tpu_torch.engine.convert import params_to_torch  # noqa: E402
from ivit_tpu_torch.engine.synthetic import synthetic_swin_spec  # noqa: E402


# --- (d) the engine on real JAX freezes ----------------------------------------

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's CPU forwards: Tier-1 runs six
    workers at once, and a pool per worker as wide as the machine
    oversubscribes its cores (the integer paths' bits do not depend on the
    thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def freezes():
    """JAX freezes of calibrated 56 px Swins: ivit, ibert, and the ivit model
    frozen with the ibert LN (its LN sites calibrate no overflow shift)."""
    out = {}
    for fam in ("ivit", "ibert"):
        model, variables = build_swin(np.random.default_rng(0), gelu_type=fam,
                                      softmax_type=fam, layernorm_type=fam)
        out[(fam,) * 3] = jswin.freeze_swin_model(model, variables)
        if fam == "ivit":
            out[("ivit", "ivit", "ibert")] = jswin.freeze_swin_model(
                model.clone(layernorm_type="ibert"), variables)
    return out


def _jax_interpret(jspec, x, **kw):
    ppkg.FORCE_INTERPRET = True
    try:
        return np.asarray(jswin.swin_engine_forward(jspec, jnp.asarray(x), **kw))
    finally:
        ppkg.FORCE_INTERPRET = False


@pytest.mark.parametrize("mix", [IVIT, IBERT, ("ivit", "ivit", "ibert")],
                         ids=["ivit", "ibert", "ivit/ivit/ibert"])
def test_swin_engine_paths_match_jax(freezes, mix):
    jspec = freezes[mix]
    spec = _to_port(jspec)
    x = _images(2, 56, seed=6)
    want = np.asarray(jswin.swin_engine_forward(jspec, jnp.asarray(x), pallas=False))
    _eq(swin_engine_forward(spec, x, kernels=False, device="cpu").numpy(), want)
    _eq(swin_engine_forward(spec, x, kernels=True, device="cpu").numpy(),
        _jax_interpret(jspec, x, pallas=True))
    for mask in itertools.product((False, True), repeat=2):
        got = Engine(spec, device="cpu", stage_paths=mask)(x)
        _eq(got.numpy(), want)
    assert np.isfinite(want).all() and want.std(axis=0).max() > 0


# --- (e) artifacts --------------------------------------------------------------

def test_swin_artifact_round_trip(freezes, tmp_path):
    jspec = freezes[IBERT]
    ref = jax.device_get(jspec.params)
    assert any("merge" in b for b in ref["blocks"])
    _assert_same_tree(params_to_torch(ref, "cpu"), ref)

    jax_save_engine(jspec, str(tmp_path / "swin"))
    loaded = load_engine(str(tmp_path / "swin"), device="cpu")
    assert isinstance(loaded, SwinEngineSpec)
    assert dataclasses.asdict(loaded.config) == dataclasses.asdict(_to_port(jspec).config)
    assert loaded.config.layout == jspec.config.layout
    _assert_same_tree(loaded.params, ref)

    save_engine(loaded, str(tmp_path / "swin_port.npz"))
    back = jax_load_engine(str(tmp_path / "swin_port.npz"))
    assert back.config == jspec.config
    _assert_same_tree(params_to_torch(jax.device_get(back.params), "cpu"), ref)


# --- (f) the synthetic spec's tree ---------------------------------------------

def _tree(params):
    out = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}{k}/")
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, f"{prefix}{i}/")
        elif prefix.split("/")[-2] not in LUT_KEYS | {"sm_sat"}:
            out[prefix[:-1]] = (np.asarray(node).dtype, np.asarray(node).shape)

    walk(params, "")
    return out


@pytest.mark.parametrize("mix", [IVIT, IBERT], ids=["ivit", "ibert"])
def test_swin_synthetic_spec_has_the_freeze_tree(freezes, mix):
    jspec = freezes[mix]
    small = synthetic_swin_spec(_to_port(jspec).config, seed=0)
    assert _tree(small.params) == _tree(jax.device_get(jspec.params))
    assert small.config.layout == jspec.config.layout
    jc, sc = dataclasses.asdict(jspec.config), dataclasses.asdict(small.config)
    for k in ("bitwidths", "use_lut", "fast_poly", "sm_sum_i32"):
        jc.pop(k), sc.pop(k)        # BitWidths types; no LUTs; scale-gated
    assert sc == jc
