"""The port's checkpoints (``ivit_tpu_torch.train.checkpoint``, its msgpack
codec ``train/serialization.py``) against the JAX package's.

* the codec's bytes equal flax's ``serialization.to_bytes`` on a trainer
  state (clip + AdamW + ``MultiSteps``, the EMA) and on a tree of every
  leaf type and size class the encoder has (numpy scalars, Python scalars,
  strings of 31 and 32 bytes, maps of 15 and 16 keys, arrays of 0 to 70,000
  bytes, bool and int64 arrays), also with leaves chunked
  (``MAX_CHUNK_SIZE`` lowered in both); each side reads the other's bytes;
* JAX's ``save_checkpoint`` after a JAX train step -> the port's
  ``load_checkpoint`` into a fresh sim's state: every tensor equal to JAX's
  (params, quant_stats, opt_state, step, ema_params), the meta equal;
* the port's ``save_checkpoint`` -> JAX's ``load_variables`` and
  ``load_checkpoint`` with the JAX trainer's template: every array equal,
  and the file byte-equal to the one JAX writes for the same state;
* resume: a JAX step, JAX's save, the port's load, then a second step in
  both (ViT, 64 px, depth 2), compared as ``tests/test_torch_port_train.py``
  compares one step: quant_stats bitwise equal to an eager JAX calibration
  step, gradients within ``GRAD_RTOL``, params within ``2 * lr``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization as flax_ser

from ivit_tpu.models import VisionTransformer as JaxViT
from ivit_tpu.train import checkpoint as jckpt
from ivit_tpu.train import steps as jsteps
from ivit_tpu.train import trainer as jtrainer
from ivit_tpu_torch.models import VisionTransformer
from ivit_tpu_torch.models.convert import (_torch_name, differing_leaves,
                                           variables_to_numpy)
from ivit_tpu_torch.train import checkpoint as tckpt
from ivit_tpu_torch.train import optim
from ivit_tpu_torch.train import serialization as tser
from ivit_tpu_torch.train import steps as tsteps
from ivit_tpu_torch.train import trainer as ttrainer

VIT = dict(img_size=64, patch_size=16, embed_dim=64, depth=2, num_heads=2,
           num_classes=10)
GRAD_RTOL = 1e-4
LR = 1e-3
CFG = dict(lr=LR, weight_decay=0.05, clip_grad=1.0, epochs=2, num_classes=10,
           batch_size=4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's CPU forwards (Tier-1 runs six
    workers at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return optim.tree_map(lambda t: t.detach().cpu().numpy().copy(), tree)


def _paths(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], path + (k,))
    else:
        yield path, np.asarray(tree)


def _jax_record():
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p), lambda g, s, p=None: (g, g))


def _port_record():
    """The port's twin of ``_jax_record``: its state is the last gradients
    (so the two states have one layout)."""
    return optim.GradientTransformation(
        lambda p: optim.tree_map(torch.zeros_like, p),
        lambda g, s, p=None: (g, optim.tree_map(torch.clone, g)))


def _txs(**kw):
    cfg = dict(CFG, **kw)
    jtx = jtrainer.build_optimizer(jtrainer.TrainConfig(**cfg), 4)[0]
    ttx = ttrainer.build_optimizer(ttrainer.TrainConfig(**cfg), 4)[0]
    return optax.chain(_jax_record(), jtx), optim.chain(_port_record(), ttx)


def _sim(seed=0):
    return VisionTransformer(device="cpu", seed=seed, **VIT)


@pytest.fixture(scope="module")
def jax_step():
    """A calibrated sim's variables, JAX's train step (jitted, recording the
    gradients) and the JAX state after one step on a seeded batch."""
    rng = np.random.default_rng(0)
    sim = _sim()
    tsteps.make_calibration_step(sim)(rng.normal(size=(2, 64, 64, 3)).astype(np.float32))
    v = variables_to_numpy(sim)
    jtx, _ = _txs()
    state0 = {"params": v["params"], "quant_stats": v["quant_stats"],
              "opt_state": jtx.init(v["params"]), "step": jnp.zeros((), jnp.int32)}
    step = jax.jit(jsteps.make_train_step(JaxViT(**VIT), jtx, 10))
    batches = [{"image": rng.normal(size=(4, 64, 64, 3)).astype(np.float32),
                "label": rng.integers(0, 10, 4)} for _ in range(2)]
    state1, _ = step(state0, batches[0], jax.random.PRNGKey(0))
    return {"step": step, "batches": batches, "state1": jax.device_get(state1)}


def _codec_tree(rng):
    return {
        "arrays": {f"a{n}": rng.normal(size=n).astype(np.float32)
                   for n in (0, 1, 3, 4, 15, 16, 64, 17500)},
        "ints": np.arange(-3, 40, dtype=np.int64).reshape(43, 1),
        "mask": np.array([True, False, True]),
        "scalars": {"f32": np.float32(1.5), "i32": np.int32(-7),
                    "step": np.zeros((), np.int32)},
        "python": {"none": None, "t": True, "f": False, "float": 0.1,
                   **{f"i{k}": v for k, v in enumerate(
                       (0, 127, 128, 255, 256, 65535, 65536, 2**32, -1, -32, -33,
                        -128, -129, -32768, -32769, -2**31 - 1))}},
        "s": {"x" * 31: "y" * 32, "z" * 255: "w" * 256},
        "map15": {str(i): i for i in range(15)},
        "map16": {str(i): i for i in range(16)},
    }


def test_codec_bytes_equal_flax(jax_step, monkeypatch):
    state = dict(jax_step["state1"])
    jtx = jtrainer.build_optimizer(jtrainer.TrainConfig(**dict(
        CFG, eff_batch_size=8)), 4)[0]
    state["opt_state"] = jtx.init(state["params"])
    state["ema_params"] = jax.tree.map(np.copy, state["params"])
    for tree in (flax_ser.to_state_dict(jax.device_get(state)),
                 _codec_tree(np.random.default_rng(1))):
        want = flax_ser.to_bytes(tree)
        got = tser.to_bytes(tree)
        assert got == want
        assert differing_leaves(tser.msgpack_restore(want),
                                flax_ser.msgpack_restore(want)) == []
        assert differing_leaves(flax_ser.msgpack_restore(got), tree) == []
    # chunked leaves: at most 64 bytes a piece in both encoders
    monkeypatch.setattr(flax_ser, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(tser, "MAX_CHUNK_SIZE", 64)
    tree = _codec_tree(np.random.default_rng(2))
    want = flax_ser.to_bytes(tree)
    assert tser.to_bytes(tree) == want
    assert differing_leaves(tser.msgpack_restore(want), tree) == []


def test_jax_checkpoint_loads_into_port(jax_step, tmp_path):
    state1 = jax_step["state1"]
    ema = jax.tree.map(lambda p: p * np.float32(0.5), state1["params"])
    jckpt.save_checkpoint(str(tmp_path / "jax"), state1, epoch=3, best_acc1=0.25,
                          model_config={"model": "vit"}, args={"lr": LR},
                          ema_params=ema)
    sim = _sim(seed=5)                      # other weights: the load must set them
    _, ttx = _txs()
    state, meta = tckpt.load_checkpoint(str(tmp_path / "jax"),
                                        tsteps.init_train_state(sim, ttx))
    assert meta == jckpt.load_meta(str(tmp_path / "jax"))
    want = flax_ser.to_state_dict(dict(state1, ema_params=ema))
    assert differing_leaves(want, _np_tree(state)) == []
    assert differing_leaves(state1["params"], variables_to_numpy(sim)["params"]) == []
    assert int(state["step"]) == 1


def _check_step(state_np, sim, state, jnew, batch):
    """The port's step (already taken) against JAX's from the same state."""
    v = {"params": state_np["params"], "quant_stats": state_np["quant_stats"]}
    eager_qs = jax.device_get(jsteps.make_calibration_step(JaxViT(**VIT))(
        v["params"], v["quant_stats"], batch["image"]))
    assert differing_leaves(eager_qs, _np_tree(state["quant_stats"])) == []
    grads = dict(_paths(jnew["opt_state"][0]))
    tgrads = {n: p.grad for n, p in sim.named_parameters()}
    want_params = dict(_paths(jnew["params"]))
    got_params = dict(_paths(_np_tree(state["params"])))
    for path, g in grads.items():
        t = tgrads[_torch_name(path)]
        t = np.zeros_like(g) if t is None else t.numpy()
        np.testing.assert_allclose(t, g, rtol=0, atol=GRAD_RTOL * np.abs(g).max(),
                                   err_msg="/".join(path))
        diff = np.abs(got_params[path] - want_params[path])
        assert diff.max() <= 2 * LR + 2 * np.spacing(np.abs(want_params[path]).max())


def test_resume_equivalence_and_port_checkpoint_reads_in_jax(jax_step, tmp_path):
    state1 = jax_step["state1"]
    jckpt.save_checkpoint(str(tmp_path / "jax"), state1, epoch=0, best_acc1=0.0,
                          model_config={})
    sim = _sim(seed=7)
    _, ttx = _txs()
    state, _ = tckpt.load_checkpoint(str(tmp_path / "jax"),
                                     tsteps.init_train_state(sim, ttx))
    batch = jax_step["batches"][1]
    jnew, jmet = jax_step["step"](state1, batch, jax.random.PRNGKey(1))
    jnew = jax.device_get(jnew)
    state, met = tsteps.make_train_step(sim, ttx, 10)(state, batch)
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]), rtol=GRAD_RTOL)
    _check_step(state1, sim, state, jnew, batch)
    assert int(state["step"]) == int(jnew["step"]) == 2

    # the port's checkpoint of its state, read by JAX
    ema = ttrainer.init_ema(state["params"])
    path = str(tmp_path / "port")
    tckpt.save_checkpoint(path, state, epoch=1, best_acc1=0.5,
                          model_config={"model": "vit"}, ema_params=ema, is_best=True)
    got = jckpt.load_variables(path)
    assert differing_leaves(got, _np_tree({"params": state["params"],
                                           "quant_stats": state["quant_stats"]})) == []
    template = jax.tree.map(np.zeros_like, jnew)
    restored, meta = jckpt.load_checkpoint(path, template)
    want = _np_tree(dict(state, ema_params=ema))
    assert differing_leaves(flax_ser.to_state_dict(restored), want) == []
    assert meta["epoch"] == 1 and meta["keys"] == sorted(want)
    # and the same bytes as JAX writes for this state
    jax_state = flax_ser.from_state_dict(template, _np_tree(state))
    jckpt.save_checkpoint(str(tmp_path / "jax2"), jax_state, epoch=1, best_acc1=0.5,
                          model_config={"model": "vit"},
                          ema_params=flax_ser.from_state_dict(template["params"],
                                                              _np_tree(ema)))
    for name in ("state.msgpack", "meta.json"):
        with open(tmp_path / "port" / name, "rb") as a, \
                open(tmp_path / "jax2" / name, "rb") as b:
            assert a.read() == b.read(), name
    with open(tmp_path / "best" / "meta.json") as f:
        assert json.load(f)["epoch"] == 1


def test_load_refuses_a_mismatched_state(jax_step, tmp_path):
    jckpt.save_checkpoint(str(tmp_path / "jax"), jax_step["state1"], epoch=0,
                          best_acc1=0.0, model_config={})
    _, ttx = _txs(eff_batch_size=8)          # MultiSteps: another layout
    with pytest.raises(ValueError, match="checkpoint keys"):
        tckpt.load_checkpoint(str(tmp_path / "jax"),
                              tsteps.init_train_state(_sim(), ttx))
    wide = VisionTransformer(device="cpu", **dict(VIT, embed_dim=96, num_heads=2))
    _, ttx = _txs()
    with pytest.raises(ValueError, match="checkpoint float32"):
        tckpt.load_checkpoint(str(tmp_path / "jax"), tsteps.init_train_state(wide, ttx))
