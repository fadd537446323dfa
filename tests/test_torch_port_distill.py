"""The port's distillation (``ivit_tpu_torch.train.distill``) and its float
teacher (``ivit_tpu_torch.models.vit_float``) against the JAX package's.

* ``distillation_loss`` for none, soft and hard against JAX's, and
  ``tests/test_distill.py``'s assertions (teacher == student: the soft
  term is 0, the loss half the base);
* the float ViT (64 px, depth 2) and Swin (56 px, depths (2, 2), a shifted
  block and a merge) in f32 on parameters JAX initialized and carried
  across: logits within ``FLOAT_RTOL`` of the largest.  Both compute the
  same f32 graph, but not to the bit: XLA:CPU and torch sum the products
  of the matmuls and the LayerNorm means in other orders, and their f32
  ``erf``, ``exp`` (softmax) and ``rsqrt`` may differ in the last ulp: a
  few ulps a layer (measured: 1.1e-6 of the largest logit for the ViT,
  1.9e-7 for the Swin);
* the same parameters drawn by the port's seeded init have flax's scales
  (``lecun_normal``: std ``1/sqrt(fan_in)``; embeddings 0.02);
* ``make_teacher_fn``: a frozen teacher (no gradient reaches it) on the
  student's device; a train step with a teacher takes the distillation
  term; the float models run on the card unless asked for the CPU.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivit_tpu.models.vit_float import FloatSwinTransformer as JaxFloatSwin
from ivit_tpu.models.vit_float import FloatVisionTransformer as JaxFloatViT
from ivit_tpu.train.distill import distillation_loss as jax_distill
from ivit_tpu_torch.models import VisionTransformer
from ivit_tpu_torch.models.convert import variables_to_torch
from ivit_tpu_torch.models.vit_float import (FloatSwinTransformer,
                                             FloatVisionTransformer, float_model,
                                             float_swin_model)
from ivit_tpu_torch.train import steps as tsteps
from ivit_tpu_torch.train import trainer as ttrainer
from ivit_tpu_torch.train.distill import distillation_loss, make_teacher_fn

VIT = dict(img_size=64, patch_size=16, embed_dim=64, depth=2, num_heads=2,
           num_classes=10)
SWIN = dict(img_size=56, patch_size=4, embed_dim=32, depths=(2, 2), num_heads=(2, 4),
            window_size=7, num_classes=10)
FLOAT_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's CPU forwards (Tier-1 runs six
    workers at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("kind", ["none", "soft", "hard"])
def test_distillation_loss_matches_jax(kind):
    rng = np.random.default_rng(0)
    s = rng.normal(size=(4, 10)).astype(np.float32)
    t = rng.normal(size=(4, 10)).astype(np.float32)
    for alpha, tau in ((0.5, 1.0), (0.3, 2.0)):
        want = float(jax_distill(jnp.asarray(2.0), jnp.asarray(s), jnp.asarray(t),
                                 kind, alpha=alpha, tau=tau))
        got = float(distillation_loss(torch.tensor(2.0), torch.from_numpy(s),
                                      torch.from_numpy(t), kind, alpha=alpha, tau=tau))
        np.testing.assert_allclose(got, want, rtol=1e-6)
        assert np.isfinite(got)
    base = torch.tensor(2.0)
    if kind == "soft":          # teacher == student -> KL = 0 -> loss = base/2
        same = distillation_loss(base, torch.from_numpy(s), torch.from_numpy(s), "soft")
        np.testing.assert_allclose(float(same), 1.0, atol=1e-5)
    if kind == "none":
        assert float(distillation_loss(torch.tensor(3.0), None, None, "none")) == 3.0
    with pytest.raises(ValueError, match="unknown distillation type"):
        distillation_loss(base, torch.from_numpy(s), torch.from_numpy(t), "medium")


def _float_pair(kind):
    rng = np.random.default_rng(1)
    size = VIT["img_size"] if kind == "vit" else SWIN["img_size"]
    x = rng.normal(size=(2, size, size, 3)).astype(np.float32)
    jm = (JaxFloatViT(dtype=jnp.float32, **VIT) if kind == "vit"
          else JaxFloatSwin(dtype=jnp.float32, **SWIN))
    params = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(0), x))["params"]
    tm = (FloatVisionTransformer(dtype=torch.float32, device="cpu", **VIT)
          if kind == "vit" else
          FloatSwinTransformer(dtype=torch.float32, device="cpu", **SWIN))
    variables_to_torch(tm, {"params": params})
    want = np.asarray(jax.jit(jm.apply)({"params": params}, x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    return params, tm, want, got


@pytest.mark.parametrize("kind", ["vit", "swin"])
def test_float_models_match_jax(kind):
    params, tm, want, got = _float_pair(kind)
    assert got.shape == want.shape == (2, 10) and np.isfinite(got).all()
    assert np.abs(got - want).max() <= FLOAT_RTOL * np.abs(want).max()
    # the port's own seeded init draws at flax's scales
    seeded = (FloatVisionTransformer if kind == "vit" else FloatSwinTransformer)(
        dtype=torch.float32, device="cpu", seed=3, **(VIT if kind == "vit" else SWIN))
    mine = dict(seeded.named_parameters())
    for name, p in tm.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        q = mine[name].detach()
        if leaf == "kernel":
            std = float(np.prod(p.shape[:-1])) ** -0.5
            assert abs(float(q.std()) / std - 1) < 0.3, name
        elif leaf in ("cls_token", "pos_embed", "relative_position_bias_table"):
            assert abs(float(q.std()) / 0.02 - 1) < 0.3, name
        elif leaf == "scale":
            assert torch.equal(q, torch.ones_like(q)), name
        else:
            assert torch.equal(q, torch.zeros_like(q)), name


def test_teacher_fn_is_frozen_and_feeds_the_step():
    teacher = FloatVisionTransformer(dtype=torch.float32, device="cpu", seed=1, **VIT)
    teacher_fn = make_teacher_fn(teacher, device="cpu")
    assert not any(p.requires_grad for p in teacher.parameters())
    rng = np.random.default_rng(2)
    images = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    t_logits = teacher_fn(torch.from_numpy(images))
    assert t_logits.dtype == torch.float32 and not t_logits.requires_grad

    sim = VisionTransformer(device="cpu", **VIT)
    tsteps.make_calibration_step(sim)(images)
    ref = copy.deepcopy(sim)
    labels = np.array([3, 4])
    logits = ref(torch.from_numpy(images), running_stat=True, train=True)
    want = distillation_loss(tsteps.cross_entropy(logits, torch.from_numpy(labels), 10),
                             logits, t_logits, "soft", 0.5, 2.0)
    tx, _, _ = ttrainer.build_optimizer(ttrainer.TrainConfig(lr=1e-3, epochs=1), 1)
    step = tsteps.make_train_step(sim, tx, 10, teacher_fn=teacher_fn,
                                  distillation_type="soft", alpha=0.5, tau=2.0)
    state, met = step(tsteps.init_train_state(sim, tx),
                      {"image": images, "label": labels})
    assert float(met["loss"]) == float(want.detach())
    assert all(p.grad is None for p in teacher.parameters())


def test_float_models_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        float_model("deit_small_patch16_224")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        float_swin_model("swin_tiny_patch4_window7_224")
    m = float_model("deit_tiny_patch16_224", depth=1, device="cpu")
    assert m.embed_dim == 192 and m.dtype == torch.bfloat16
    x = torch.zeros((1, 224, 224, 3))
    with torch.no_grad():
        y = m(x)
    assert y.dtype == torch.float32 and y.shape == (1, 1000)
