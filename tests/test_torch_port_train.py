"""The port's train step, optimizer and trainer parts
(``ivit_tpu_torch.train``) against the JAX package's.

* ``cross_entropy`` (int and soft targets) and the eval step's loss,
  top-1 / top-5 (ties to the lower index, as ``jax.lax.top_k``) and count,
  the JAX step run on the port sim's logits;
* one train step from the same calibrated state and batch, ViT at 64 px
  depth 2 (Swin: ``tests/test_torch_port_train_swin.py``), drop rates 0,
  the trainer's optimizer (clip, masked weight decay): the
  gradients within ``GRAD_RTOL`` of each tensor's largest (the two
  backward passes sum in other orders), the quant_stats bitwise equal to
  an eager JAX calibration step on the same params and batch (the JAX step
  runs jitted, and under ``jit`` XLA:CPU contracts a residual range's
  ``x + identity`` into an FMA), the params within ``2 * lr`` of JAX's
  (Adam normalises: a near-zero gradient whose sign differs moves a
  weight by up to ``2 * lr``) and within ``1e-3 * lr`` wherever the JAX
  gradient's magnitude is above ``100 * GRAD_RTOL`` of its tensor's
  largest;
* the optimizer on identical gradients (JAX's, as numpy) for 3 steps:
  AdamW with the decay mask bitwise equal to eager optax (``mu``, ``nu``,
  the counts, the params); with the clip, whose global norm sums each leaf
  in torch's order and not XLA's, and under ``MultiSteps`` 2, which optax
  runs inside ``lax.cond`` so that XLA compiles the inner update and
  contracts its ``a * b + c`` into FMAs: the counts bitwise, ``mu`` /
  ``nu`` / the accumulator within ``FMA_ULPS`` ulps of each leaf's
  largest magnitude and the params within two ulps plus ``FMA_ULPS`` ulps
  of ``lr`` times a unit step; the port's
  ``MultiSteps`` bitwise equal to its own chain on the mean gradients;
* the schedule: warmup values and the peak bitwise, every count within an
  ulp of the cosine (XLA:CPU's f32 ``cos`` is not correctly rounded; the
  port's is) and one of the value, the
  bias corrections ``1 - b**count`` bitwise against optax's jitted
  ``tree_bias_correction``;
* ``weight_decay_mask`` leaf for leaf against JAX's on DeiT-Ti and Swin-T
  (``tests/test_trainer.py:92``), and the masked leaves unmoved under a
  huge decay (``:137``);
* ``Mixup`` and ``repeated_aug_indices`` bitwise for a seeded
  ``np.random.Generator``; the model-EMA update bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ivit_tpu.models import VisionTransformer as JaxViT
from ivit_tpu.models.swin import SwinTransformer as JaxSwin
from ivit_tpu.train import data as jdata
from ivit_tpu.train import steps as jsteps
from ivit_tpu.train import trainer as jtrainer
from ivit_tpu_torch.models import SwinTransformer, VisionTransformer, str2model
from ivit_tpu_torch.models.convert import (_torch_name, differing_leaves,
                                           variables_to_numpy)
from ivit_tpu_torch.train import data as tdata
from ivit_tpu_torch.train import optim
from ivit_tpu_torch.train import steps as tsteps
from ivit_tpu_torch.train import trainer as ttrainer

VIT = dict(img_size=64, patch_size=16, embed_dim=64, depth=2, num_heads=2,
           num_classes=10)
SWIN = dict(img_size=56, patch_size=4, embed_dim=32, depths=(2,), num_heads=(2,),
            window_size=7, num_classes=10, drop_path_rate=0.0)
GRAD_RTOL = 1e-4
FMA_ULPS = 8
LR = 1e-3
CFG = dict(lr=LR, weight_decay=0.05, clip_grad=1.0, epochs=2, num_classes=10,
           warmup_epochs=1, warmup_lr=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's CPU forwards: Tier-1 runs six
    workers at once (the integer paths' bits do not depend on the thread
    count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return optim.tree_map(lambda t: t.detach().cpu().numpy().copy(), tree)


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def _paths(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], path + (k,))
    else:
        yield path, np.asarray(tree)


def _state_dict(jax_state):
    from flax import serialization
    return serialization.to_state_dict(jax.device_get(jax_state))


# ---------------------------------------------------------------------------
# losses and the eval step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["hard", "soft"])
def test_cross_entropy_matches_jax(kind):
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(6, 10)) * 3).astype(np.float32)
    if kind == "hard":
        labels = rng.integers(0, 10, 6)
    else:
        labels = rng.dirichlet(np.ones(10), 6).astype(np.float32)
    want = float(jsteps.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), 10))
    got = float(tsteps.cross_entropy(torch.from_numpy(logits),
                                     torch.from_numpy(labels), 10))
    np.testing.assert_allclose(got, want, rtol=1e-6)


class _FixedLogits:
    """A stand-in model whose ``apply`` returns given logits, for JAX's eval
    step."""

    def __init__(self, logits):
        self.logits = logits

    def apply(self, variables, image, running_stat=False):
        return jnp.asarray(self.logits)


def test_eval_step_matches_jax():
    rng = np.random.default_rng(1)
    sim = VisionTransformer(device="cpu", **VIT)
    x = rng.normal(size=(6, 64, 64, 3)).astype(np.float32)
    tsteps.make_calibration_step(sim)(x)
    labels = rng.integers(0, 10, 6)
    got = tsteps.make_eval_step(sim, 10)({"image": x, "label": labels})
    with torch.no_grad():
        logits = sim(torch.from_numpy(x)).numpy()
    want = jsteps.make_eval_step(_FixedLogits(logits), 10)(
        None, {"image": x, "label": jnp.asarray(labels)})
    for k in ("top1", "top5", "count"):
        assert float(got[k]) == float(want[k]), k
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-6)
    # ties: the lower index ranks first, as lax.top_k ranks it
    tied = np.zeros((3, 10), np.float32)
    tied[:, 7] = 1.0
    lab = np.array([7, 3, 5])
    want5 = np.any(np.asarray(jax.lax.top_k(jnp.asarray(tied), 5)[1])
                   == lab[:, None], axis=-1)
    got5 = tsteps.top5_correct(torch.from_numpy(tied), torch.from_numpy(lab)).numpy()
    np.testing.assert_array_equal(got5, want5)
    assert got5.tolist() == [True, True, False]


# ---------------------------------------------------------------------------
# one train step against JAX
# ---------------------------------------------------------------------------

def _record():
    """An optax transformation whose state is the gradients it was given."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p), lambda g, s, p=None: (g, g))


def _calibrated(kind, rng, size):
    sim = (VisionTransformer(device="cpu", **VIT) if kind == "vit"
           else SwinTransformer(device="cpu", **SWIN))
    tsteps.make_calibration_step(sim)(rng.normal(size=(2, size, size, 3))
                                      .astype(np.float32))
    jm = JaxViT(**VIT) if kind == "vit" else JaxSwin(**SWIN)
    return sim, jm


def check_train_step(kind):
    """One step of the port against JAX's jitted ``make_train_step`` from the
    same calibrated state and batch (``kind``: "vit" or "swin")."""
    rng = np.random.default_rng(2)
    size = 64 if kind == "vit" else 56
    sim, jm = _calibrated(kind, rng, size)
    v = variables_to_numpy(sim)
    batch = {"image": rng.normal(size=(4, size, size, 3)).astype(np.float32),
             "label": rng.integers(0, 10, 4)}

    jtx, _, _ = jtrainer.build_optimizer(jtrainer.TrainConfig(**CFG), 4)
    jtx = optax.chain(_record(), jtx)
    jstate = {"params": v["params"], "quant_stats": v["quant_stats"],
              "opt_state": jtx.init(v["params"]), "step": jnp.zeros((), jnp.int32)}
    jnew, jmet = jax.jit(jsteps.make_train_step(jm, jtx, 10))(
        jstate, batch, jax.random.PRNGKey(0))
    jnew = jax.device_get(jnew)
    eager_qs = jax.device_get(jsteps.make_calibration_step(jm)(
        v["params"], v["quant_stats"], batch["image"]))

    ttx, _, _ = ttrainer.build_optimizer(ttrainer.TrainConfig(**CFG), 4)
    state = tsteps.init_train_state(sim, ttx)
    state, met = tsteps.make_train_step(sim, ttx, 10, log_grad_norm=True)(
        state, batch, torch.Generator().manual_seed(0))

    assert int(state["step"]) == 1
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]), rtol=GRAD_RTOL)
    assert float(met["acc"]) == float(jmet["acc"])
    assert differing_leaves(eager_qs, _np_tree(state["quant_stats"])) == []

    grads = dict(_paths(jnew["opt_state"][0]))
    tgrads = {n: p.grad for n, p in sim.named_parameters()}
    assert len(grads) == len(tgrads)
    new_params = dict(_paths(_np_tree(state["params"])))
    for path, g in grads.items():
        t = tgrads[_torch_name(path)]
        t = np.zeros_like(g) if t is None else t.numpy()      # LN bias: detached
        np.testing.assert_allclose(t, g, rtol=0, atol=GRAD_RTOL * np.abs(g).max(),
                                   err_msg="/".join(path))
        want = np.asarray(dict(_paths(jnew["params"]))[path])
        diff = np.abs(new_params[path] - want)
        assert diff.max() <= 2 * LR + 2 * np.spacing(np.abs(want).max()), path
        strong = np.abs(g) > 100 * GRAD_RTOL * np.abs(g).max()
        assert (diff[strong] <= 1e-3 * LR).all(), path
    assert float(met["grad_norm"]) > 0


def test_vit_train_step_matches_jax():
    check_train_step("vit")


def test_frozen_ranges_step_keeps_quant_stats():
    """``running_stat=False`` (the trainer's calibration epochs): the ranges
    stay as they are while the weights move."""
    rng = np.random.default_rng(3)
    sim, _ = _calibrated("vit", rng, 64)
    tx, _, _ = ttrainer.build_optimizer(ttrainer.TrainConfig(**CFG), 4)
    state = tsteps.init_train_state(sim, tx)
    before = _np_tree(state)
    step = tsteps.make_train_step(sim, tx, 10)
    batch = {"image": rng.normal(size=(2, 64, 64, 3)).astype(np.float32),
             "label": np.array([1, 2])}
    state, met = step(state, batch, running_stat=False)
    assert np.isfinite(float(met["loss"]))
    assert differing_leaves(before["quant_stats"], _np_tree(state["quant_stats"])) == []
    assert differing_leaves(before["params"], _np_tree(state["params"])) != []


# ---------------------------------------------------------------------------
# the optimizer on identical gradients
# ---------------------------------------------------------------------------

def _tree(rng):
    # fc2's 2**17 elements take torch's vectorized CPU math, whose f32 sqrt
    # is not correctly rounded (the optimizer's roots are ``sqrt_rn``)
    return {"blocks_0": {"fc1": {"kernel": rng.normal(size=(16, 8)),
                                 "bias": rng.normal(size=8)},
                         "fc2": {"kernel": rng.normal(size=(256, 512))},
                         "norm1": {"scale": rng.normal(size=8)}},
            "cls_token": rng.normal(size=(1, 1, 8)),
            "head": {"kernel": rng.normal(size=(8, 4))}}


def _grads(rng, params, scales):
    return [optim.tree_map(lambda p: (rng.normal(size=p.shape) * s).astype(np.float32),
                           params) for s in scales]


def _run(cfg_kw, params, grads):
    """(eager optax, port) after the gradients: optimizer states and params."""
    jtx, _, _ = jtrainer.build_optimizer(jtrainer.TrainConfig(**cfg_kw), 3)
    ttx, _, _ = ttrainer.build_optimizer(ttrainer.TrainConfig(**cfg_kw), 3)
    jp = jax.tree.map(jnp.asarray, params)
    js = jtx.init(jp)
    tp = optim.tree_map(torch.tensor, params)
    ts = ttx.init(tp)
    for g in grads:
        u, js = jtx.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, u)
        tu, ts = ttx.update(optim.tree_map(torch.tensor, g), ts, tp)
        with torch.no_grad():
            optim.apply_updates(tp, tu)
    return (_state_dict(js), jax.device_get(jp)), (_np_tree(ts), _np_tree(tp))


@pytest.mark.parametrize("clip,accum", [(None, 1), (1.0, 1), (1.0, 2)])
def test_optimizer_matches_optax_on_same_gradients(clip, accum):
    rng = np.random.default_rng(4)
    params = optim.tree_map(lambda a: a.astype(np.float32), _tree(rng))
    # clipped (norm far above 1), not clipped, clipped again
    grads = _grads(rng, params, (3.0, 0.01, 2.0) if accum == 1
                   else (3.0, 0.01, 2.0, 1e-6))
    kw = dict(CFG, clip_grad=clip, batch_size=8, eff_batch_size=8 * accum)
    (jst, jp), (tst, tp) = _run(kw, params, grads)
    states = dict(_paths(jst))
    assert states.keys() == dict(_paths(tst)).keys()
    exact = clip is None and accum == 1
    for path, got in _paths(tst):
        want = states[path]
        assert got.dtype == want.dtype and got.shape == want.shape, path
        if exact or got.dtype != np.float32:
            np.testing.assert_array_equal(got, want, err_msg="/".join(path))
        else:
            bound = FMA_ULPS * np.spacing(np.float32(np.abs(want).max()))
            assert np.abs(got - want).max() <= bound, path
    for path, got in _paths(tp):
        want = dict(_paths(jp))[path]
        if exact:
            np.testing.assert_array_equal(got, want, err_msg="/".join(path))
        else:          # two ulps of the weight and FMA_ULPS of lr * a unit step
            bound = 2 * np.spacing(np.abs(want)) + FMA_ULPS * np.float32(LR) * 2.0**-23
            assert (np.abs(got - want) <= bound).all(), path
    if accum == 1:
        assert int(states[("0", "0", "count") if clip is None else
                          ("1", "0", "count")]) == 3
    else:
        assert int(states[("gradient_step",)]) == 2
        assert int(states[("mini_step",)]) == 0
        # the port's MultiSteps is its own chain on the mean gradients
        inner = ttrainer.build_optimizer(ttrainer.TrainConfig(**kw), 3)[0].inner_opt
        tp_chain = optim.tree_map(torch.tensor, params)
        ts = inner.init(tp_chain)
        for g0, g1 in zip(grads[0::2], grads[1::2]):
            mean = optim.tree_map(lambda a, b: torch.tensor(a + (b - a) / np.float32(2)),
                                  g0, g1)
            u, ts = inner.update(mean, ts, tp_chain)
            with torch.no_grad():
                optim.apply_updates(tp_chain, u)
        assert differing_leaves(tp, _np_tree(tp_chain)) == []


def test_schedule_matches_optax():
    cfg = jtrainer.TrainConfig(lr=5e-4, warmup_epochs=3, warmup_lr=1e-6, epochs=30)
    _, jsched, _ = jtrainer.build_optimizer(cfg, 50)
    _, tsched, _ = ttrainer.build_optimizer(ttrainer.TrainConfig(
        lr=5e-4, warmup_epochs=3, warmup_lr=1e-6, epochs=30), 50)
    counts = np.arange(0, 1600, dtype=np.int32)
    want = np.asarray(jax.vmap(jsched)(jnp.asarray(counts)))
    got = np.array([tsched(int(c)) for c in counts], np.float32)
    warm = counts <= 150                        # warmup, the peak at 150
    np.testing.assert_array_equal(got[warm], want[warm])
    assert got[150] == np.float32(5e-4)
    # the cos: XLA's f32 cos against the correctly rounded one, an ulp of
    # |cos| <= 1 (2**-24 of peak after the 0.5 * (1 + cos) scaling, at most)
    # and the value's own rounding
    bound = np.float32(5e-4) * 2.0**-24 + np.spacing(np.abs(want))
    assert (np.abs(got - want) <= bound).all()
    assert (got != want).any()                   # the ulps are there to bound
    np.testing.assert_array_equal(got[1500:], want[1500:])     # the end: lr / 15
    assert (got[1500:] == got[1500]).all()
    np.testing.assert_allclose(got[1500], 5e-4 / 15, rtol=1e-6)
    for decay in (0.9, 0.999):
        ones = jnp.ones((), jnp.float32)
        counts = range(1, 300)
        want_bc = np.array([optax.tree.bias_correction(ones, decay, jnp.int32(c))
                            for c in counts], np.float32)          # 1 / (1 - b**c)
        got_bc = np.float32(1.0) / np.array(
            [optim.bias_correction(decay, c) for c in counts], np.float32)
        np.testing.assert_array_equal(got_bc, want_bc)


# ---------------------------------------------------------------------------
# trainer parts
# ---------------------------------------------------------------------------

def _mask_pairs(name, **kw):
    sim = str2model(name)(device="cpu", num_classes=10, **kw)
    params = variables_to_numpy(sim)["params"]
    want = dict(_paths(jtrainer.weight_decay_mask(params)))
    got = dict(_paths(ttrainer.weight_decay_mask(params)))
    return want, got


def test_weight_decay_mask_matches_jax():
    want, got = _mask_pairs("deit_tiny_patch16_224")
    assert got == want
    kernels = [p for p, m in got.items() if m]
    assert all(p[-1] == "kernel" for p in kernels) and len(kernels) >= 4 * 12
    assert not got[("cls_token",)] and not got[("pos_embed",)]
    want, got = _mask_pairs("swin_tiny_patch4_window7_224", drop_path_rate=0.0)
    assert got == want
    tables = [m for p, m in got.items() if p[-1] == "relative_position_bias_table"]
    assert tables and not any(tables)


def test_decay_masks_applied():
    """With a huge weight decay and zero gradients, the masked leaves must
    not move and every kernel must (``tests/test_trainer.py:137``)."""
    sim = VisionTransformer(device="cpu", **VIT)
    tx, _, _ = ttrainer.build_optimizer(ttrainer.TrainConfig(
        weight_decay=1.0, lr=1e-2, epochs=1, num_classes=10), 10)
    state = tsteps.init_train_state(sim, tx)
    grads = optim.tree_map(torch.zeros_like, state["params"])
    updates, _ = tx.update(grads, state["opt_state"], state["params"])
    for path, u in _paths(_np_tree(updates)):
        moved = float(np.abs(u).max())
        if "cls_token" in path or "pos_embed" in path or u.ndim <= 1:
            assert moved == 0.0, path
        elif path[-1] == "kernel":
            assert moved > 0.0, path


@pytest.mark.parametrize("mixup,cutmix,prob", [(0.8, 1.0, 1.0), (0.8, 0.0, 1.0),
                                               (0.0, 1.0, 1.0), (0.8, 1.0, 0.3)])
def test_mixup_and_repeated_aug_match_jax(mixup, cutmix, prob):
    images = np.random.default_rng(5).normal(size=(8, 32, 32, 3)).astype(np.float32)
    labels = np.random.default_rng(6).integers(0, 10, 8)
    kw = dict(mixup_alpha=mixup, cutmix_alpha=cutmix, prob=prob,
              label_smoothing=0.1, num_classes=10)
    for seed in range(4):
        want = jdata.Mixup(**kw)(images, labels, np.random.default_rng(seed))
        got = tdata.Mixup(**kw)(images, labels, np.random.default_rng(seed))
        for w, g in zip(want, got):
            assert w.dtype == g.dtype
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(
        tdata.repeated_aug_indices(30, np.random.default_rng(7)),
        jdata.repeated_aug_indices(30, np.random.default_rng(7)))
    ds, jds = tdata.SyntheticDataset(8, 32, 10, 3), jdata.SyntheticDataset(8, 32, 10, 3)
    for i in range(len(ds)):
        (a, la), (b, lb) = ds.get(i), jds.get(i)
        assert la == lb and np.array_equal(a, b)


def test_ema_update_matches_jax():
    rng = np.random.default_rng(8)
    params = optim.tree_map(lambda a: a.astype(np.float32), _tree(rng))
    moved = optim.tree_map(lambda a: (a + rng.normal(size=a.shape)).astype(np.float32),
                           params)
    d = 0.99996
    want = jax.tree.map(lambda e, p: e * d + (1 - d) * p,
                        jax.tree.map(jnp.asarray, params),
                        jax.tree.map(jnp.asarray, moved))
    ema = ttrainer.init_ema(optim.tree_map(torch.tensor, params))
    ttrainer.update_ema(ema, optim.tree_map(torch.tensor, moved), d)
    assert differing_leaves(jax.device_get(want), _np_tree(ema)) == []
