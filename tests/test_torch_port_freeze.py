"""The port's freeze (``ivit_tpu_torch.engine.freeze.freeze_model``)
against the JAX package's, and the port's own sim ≡ engine chain.

At ``tests/test_engine.py``'s 64 px geometry (depth 2, embed 64, 2 heads):
the port's sim is calibrated on two seeded batches and its variables
(``variables_to_numpy``) are handed to JAX's ``freeze_model`` too.

* every spec leaf equal to JAX's (key, dtype, shape, value; the LUTs
  included) and the configs equal (the gate flags included), for the
  families of ``test_engine.py:31-36`` and the INT16 bitwidths (the ppoly
  family's freeze and fit are in ``test_torch_port_ppoly.py``, on its
  fitted model);
* ``save_engine`` of the port's spec byte-equal to JAX's ``save_engine`` of
  its own (the clock frozen: the ``.npz``'s zip headers carry the time);
* inside the port, sim -> freeze -> ``Engine(device="cpu")``: the logits of
  ``kernels=False``, ``True`` (the kernels' plain versions; not with the
  integer-sqrt LN too) and ``"ops"`` bitwise equal
  to the sim's (JAX's ``test_engine_matches_sim``); the INT16
  configuration within JAX's own bound (``test_engine.py:144``: the sim
  keeps a one-hot 2**15 probability that the engine saturates);
* an unfitted ppoly site refuses to freeze.
"""

import dataclasses
import time

import jax
import numpy as np
import pytest
import torch

from ivit_tpu.engine import freeze_model as jax_freeze
from ivit_tpu.engine.export import save_engine as jax_save
from ivit_tpu.models import BitWidths as JaxBitWidths
from ivit_tpu.models import VisionTransformer as JaxViT
from ivit_tpu_torch.engine import Engine, save_engine
from ivit_tpu_torch.engine.freeze import freeze_model
from ivit_tpu_torch.models import VisionTransformer
from ivit_tpu_torch.models.convert import variables_to_numpy

GEOM = dict(img_size=64, patch_size=16, embed_dim=64, depth=2, num_heads=2,
            num_classes=10)
INT16 = "8,8,8,8,16,8,16,8"
FAMILIES = [  # (gelu, softmax, ln, bitwidths)
    ("ivit", "ivit", "ivit", "8"),
    ("ibert", "ibert", "ibert", "8"),
    ("ivit", "ibert", "ivit", "8"),
    ("ibert", "ivit", "ibert_use-int-sqrt_true", "8"),
    ("ivit", "ivit", "ivit", INT16),
]
IDS = ["/".join(f[:3]) + f"@{f[3]}" for f in FAMILIES]


def _images(rng, n=4):
    return torch.from_numpy(rng.normal(size=(n, 64, 64, 3)).astype(np.float32))


def _calibrated(gelu, softmax, ln, bits, seed=0):
    kw = dict(GEOM, gelu_type=gelu, softmax_type=softmax, layernorm_type=ln)
    model = VisionTransformer(bitwidths=bits, device="cpu", seed=seed, **kw)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for _ in range(2):
            model(_images(rng), running_stat=True)
    return model, JaxViT(bitwidths=JaxBitWidths.from_spec(bits), **kw), rng


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    if isinstance(tree, list):
        return {k2: v2 for i, v in enumerate(tree) for k2, v2 in _flat(v, f"{prefix}{i}/").items()}
    return {prefix[:-1]: np.asarray(tree)}


def _config(cfg):
    d = dataclasses.asdict(cfg)
    d["bitwidths"] = list(cfg.bitwidths.to_list())
    return d


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


@pytest.fixture(scope="module", params=FAMILIES, ids=IDS)
def frozen(request):
    """(port model, its spec, JAX's spec of the same variables, rng)."""
    model, jm, rng = _calibrated(*request.param)
    spec = freeze_model(model)
    jspec = jax_freeze(jm, variables_to_numpy(model))
    return model, spec, jspec, rng


def test_freeze_matches_jax(frozen):
    _, spec, jspec, _ = frozen
    assert _config(spec.config) == _config(jspec.config)
    got, want = _flat(spec.params), _flat(jax.device_get(jspec.params))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    assert {"sm_lut", "gelu_lut"} <= set(spec.params["blocks"][0])


def test_saved_artifact_byte_equal(frozen, tmp_path, monkeypatch):
    _, spec, jspec, _ = frozen
    monkeypatch.setattr(time, "time", lambda: 1.7e9)
    save_engine(spec, str(tmp_path / "port"))
    jax_save(jspec, str(tmp_path / "jax"))
    for ext in (".npz", ".json"):
        assert ((tmp_path / f"port{ext}").read_bytes()
                == (tmp_path / f"jax{ext}").read_bytes()), ext


def test_engine_matches_sim(frozen):
    model, spec, _, rng = frozen
    x = _images(rng)
    with torch.no_grad():
        sim = model(x)
    for kernels in (False, True, "ops"):
        got = Engine(spec, device="cpu", kernels=kernels)(x)
        assert got.shape == sim.shape and torch.isfinite(got).all()
        if spec.config.bitwidths.softmax == 16:
            bound = 1e-5 * sim.abs().max() + 1e-6
            assert (got - sim).abs().max() < bound, kernels
        else:
            assert torch.equal(got, sim), kernels


def test_unfitted_ppoly_refuses_to_freeze():
    model, _, _ = _calibrated("ppoly_backend_ibert", "ivit", "ibert", "8")
    with pytest.raises(ValueError, match="not fitted"):
        freeze_model(model)
