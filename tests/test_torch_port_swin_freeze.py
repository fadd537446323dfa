"""The port's ``freeze_swin_model`` against the JAX package's, and the
port's Swin sim ≡ engine chain.

At ``tests/test_swin_engine.py::build_swin``'s geometry (56 px, embed 32,
depths (2, 2), heads (2, 4): a shifted block in stage 0, the window
clamp in stage 1) the port's sim is seeded, calibrated on two batches of 2
images (the ppoly tables fitted by the port's ``fit_ppoly_tables``), and
its variables (``variables_to_numpy``) are handed to JAX's
``freeze_swin_model`` too:

* every spec leaf equal to JAX's (key, dtype, shape, value: ``mask_int``,
  ``rel_bias_addend``, ``sm_sat`` where written, the LUTs and ppoly
  tables) and the configs equal (``layout`` and the five gate flags), for
  ivit, ibert and ppoly (``ppoly_backend_ibert`` GELU and softmax, ivit
  LN);
* ``save_engine`` of the port's spec byte-equal to JAX's ``save_engine``
  of its own (the clock frozen: the ``.npz``'s zip headers carry it);
* the sim's logits equal to ``Engine(spec, device="cpu")`` with
  ``kernels=True`` (the kernels' plain versions) and ``False``, and to
  JAX's ``swin_engine_forward(pallas=False)`` on JAX's spec;
* ``swin_shift_sat`` equal to JAX's over a sweep of scales and mask
  minima, for ivit, ibert and ppoly;
* an unfitted ppoly Swin and an ``ape=True`` Swin refused;
* the reference's ``ape`` gap, recorded (ROADMAP Queue 3): JAX's freeze of
  an ``ape=True`` sim leaves the embedding out, so its engine's logits
  differ from that sim's.
"""

import dataclasses
import time

import jax
import numpy as np
import pytest
import torch

from ivit_tpu.engine import luts as jax_luts
from ivit_tpu.engine.export import save_engine as jax_save
from ivit_tpu.engine.swin_int import freeze_swin_model as jax_freeze
from ivit_tpu.engine.swin_int import swin_engine_forward as jax_forward
from ivit_tpu.models.swin import SwinTransformer as JaxSwin
from ivit_tpu_torch.engine import Engine, save_engine
from ivit_tpu_torch.engine.luts import swin_shift_sat
from ivit_tpu_torch.engine.swin_int import freeze_swin_model
from ivit_tpu_torch.models import SwinTransformer
from ivit_tpu_torch.models.convert import differing_leaves, variables_to_numpy
from ivit_tpu_torch.models.model_utils import freeze_model as fit_tables

GEOM = dict(img_size=56, patch_size=4, embed_dim=32, depths=(2, 2),
            num_heads=(2, 4), window_size=7, num_classes=10, drop_path_rate=0.0)
PPOLY = "ppoly_backend_ibert"
FAMILIES = [("ivit", "ivit", "ivit"), ("ibert", "ibert", "ibert"),
            (PPOLY, PPOLY, "ivit")]


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


def _images(rng, n=2):
    return torch.from_numpy(rng.normal(size=(n, 56, 56, 3)).astype(np.float32))


def _calibrated(gelu, softmax, ln, seed=0, fit=True, **kw):
    kw = {**GEOM, "gelu_type": gelu, "softmax_type": softmax, "layernorm_type": ln, **kw}
    model = SwinTransformer(device="cpu", seed=seed, **kw)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for _ in range(2):
            model(_images(rng), running_stat=True)
    if fit:
        fit_tables(model)
    return model, JaxSwin(**kw), rng


def _config(cfg):
    d = dataclasses.asdict(cfg)
    d["bitwidths"] = list(cfg.bitwidths.to_list())
    return d


@pytest.fixture(scope="module", params=FAMILIES, ids=["/".join(f) for f in FAMILIES])
def frozen(request):
    """(port model, its spec, JAX's spec of the same variables, rng)."""
    model, jm, rng = _calibrated(*request.param)
    return model, freeze_swin_model(model), jax_freeze(jm, variables_to_numpy(model)), rng


def test_freeze_matches_jax(frozen):
    _, spec, jspec, _ = frozen
    assert _config(spec.config) == _config(jspec.config)
    assert spec.config.layout == (("block", 0, 0), ("block", 0, 3), ("merge", 0, 0),
                                  ("block", 1, 0), ("block", 1, 0))
    assert differing_leaves(spec.params, jax.device_get(jspec.params)) == []
    shifted = spec.params["blocks"][1]
    assert shifted["mask_int"].shape == (4, 49, 49)
    assert shifted["rel_bias_addend"].shape == (2, 49, 49)
    # sm_sat is written exactly where the saturation gate passes
    sm_base = spec.config.base_type("softmax")
    assert ("sm_sat" in shifted) == (sm_base != "ppoly")
    assert not any("sm_sat" in b for i, b in enumerate(spec.params["blocks"]) if i != 1)


def test_saved_artifact_byte_equal(frozen, tmp_path, monkeypatch):
    _, spec, jspec, _ = frozen
    monkeypatch.setattr(time, "time", lambda: 1.7e9)
    save_engine(spec, str(tmp_path / "port"))
    jax_save(jspec, str(tmp_path / "jax"))
    for ext in (".npz", ".json"):
        assert ((tmp_path / f"port{ext}").read_bytes()
                == (tmp_path / f"jax{ext}").read_bytes()), ext


def test_engine_matches_sim(frozen):
    model, spec, jspec, rng = frozen
    x = _images(rng)
    with torch.no_grad():
        sim = model(x)
    for kernels in (True, False):
        got = Engine(spec, device="cpu", kernels=kernels)(x)
        assert got.shape == sim.shape and torch.isfinite(got).all()
        assert torch.equal(got, sim), kernels
    want = np.asarray(jax_forward(jspec, x.numpy(), pallas=False))
    np.testing.assert_array_equal(sim.numpy(), want)


@pytest.mark.parametrize("sm_base", ["ivit", "ibert", "ppoly"])
def test_swin_shift_sat_matches_jax(sm_base):
    results = []
    for s_attn in (0.002, 0.0053818272, 0.02, 0.0521371, 0.3, 1.5):
        for mask_min in (-3.0, -40.0, -250.0, -1000.0, -18581.0):
            s_exp_act = np.float32(0.7) if sm_base == "ibert" else None
            got = swin_shift_sat(sm_base, np.float32(s_attn), mask_min, s_exp_act)
            want = jax_luts.swin_shift_sat(sm_base, np.float32(s_attn), mask_min,
                                           s_exp_act)
            assert got[0] == want[0], (s_attn, mask_min)
            np.testing.assert_array_equal(np.float32(got[1]), np.float32(want[1]))
            results.append(got[0])
    # the sweep takes both branches, but ppoly never saturates
    assert (any(results) and not all(results)) if sm_base != "ppoly" else not any(results)


def test_unfitted_ppoly_refuses_to_freeze():
    model, _, _ = _calibrated(PPOLY, PPOLY, "ivit", fit=False, depths=(2,),
                              num_heads=(2,))
    with pytest.raises(ValueError, match="not fitted"):
        freeze_swin_model(model)


def test_ape_refused_and_reference_gap():
    """The port refuses to freeze an ``ape=True`` sim; the reference freezes
    one into an engine without the embedding, whose logits differ from
    the sim's (the first differing element is recorded in ROADMAP Queue
    3: ``[0, 0]`` at this geometry and seed).  The sim's logits are the
    port's, which equal JAX's sim on the ``ape`` branch
    (``tests/test_torch_port_swin_qat.py::test_ape_ranges_match_jax``)."""
    model, jm, rng = _calibrated("ivit", "ivit", "ivit", ape=True)
    with pytest.raises(ValueError, match="absolute_pos_embed"):
        freeze_swin_model(model)
    x = _images(rng)
    with torch.no_grad():
        sim = model(x).numpy()
    eng = np.asarray(jax_forward(jax_freeze(jm, variables_to_numpy(model)), x.numpy(),
                                 pallas=False))
    differ = np.argwhere(eng != sim)
    assert len(differ) > 0
    assert tuple(differ[0]) == (0, 0), differ[0]
