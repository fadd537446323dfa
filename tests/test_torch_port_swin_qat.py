"""The port's Swin QAT sim (``ivit_tpu_torch.models.swin``) against the JAX
sim.

At ``tests/test_swin_engine.py::build_swin``'s geometry (56 px, patch 4,
embed 32, depths (2, 2), heads (2, 4), window 7, 10 classes, drop-path 0:
stage 0 has a shifted block, stage 1 takes the resolution <= window
clamp), on variables JAX initialized and carried across with
``variables_to_torch``:

* calibration from zeroed ranges, two batches of 2 images: every
  ``quant_stats`` leaf and the calibration forwards' logits bitwise equal
  to the JAX sim's, for ivit, ibert, the mix (ivit GELU and softmax, ibert
  LN) and ppoly (``ppoly_backend_ibert`` GELU and softmax, ivit LN, stage
  0 alone: each GELU site's fit takes seconds, in either package); the
  JAX side runs eagerly, as in ``tests/test_torch_port_qat.py`` (under
  ``jit`` XLA:CPU contracts a residual range's ``x + identity`` into an
  FMA and moves it by an ulp);
* frozen-eval logits bitwise equal, the ppoly tables fitted by the port's
  ``fit_ppoly_tables`` equal to JAX's first;
* the float family within 5% of the largest logit, ranges within 5%:
  torch's and XLA's f32 ``exp`` / ``erf`` may differ in the last ulp, which
  moves a quantized probability or GELU output by 1
  (``tests/test_torch_port_float.py``);
* the ``ape`` branch's ranges bitwise;
* ``swin_chunked_apply`` and ``scan_apply`` equal to the forward, logits
  and ranges;
* ``jax.grad`` (jitted) of a cross-entropy loss against ``.backward()``:
  each gradient within ``GRAD_RTOL`` of its tensor's largest, finite and
  nonzero at the patch projection, each qkv and a relative-position table;
* the share of nonzero ivit probabilities, printed and > 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivit_tpu.models.swin import SwinTransformer as JaxSwin
from ivit_tpu.train.ppoly_fit import fit_ppoly_tables as jax_fit_ppoly
from ivit_tpu_torch.models import SwinTransformer, VisionTransformer, str2model
from ivit_tpu_torch.models.chunked import scan_apply, swin_chunked_apply
from ivit_tpu_torch.models.convert import (_torch_name, differing_leaves,
                                           variables_to_numpy, variables_to_torch)
from ivit_tpu_torch.models.model_utils import freeze_model as fit_tables

GEOM = dict(img_size=56, patch_size=4, embed_dim=32, depths=(2, 2),
            num_heads=(2, 4), window_size=7, num_classes=10, drop_path_rate=0.0)
PPOLY = "ppoly_backend_ibert"
FAMILIES = [  # (gelu, softmax, ln)
    ("ivit", "ivit", "ivit"),
    ("ibert", "ibert", "ibert"),
    ("ivit", "ivit", "ibert"),
    (PPOLY, PPOLY, "ivit"),
    ("float", "float", "ivit"),
]
FLOAT_TOL = 0.05
GRAD_RTOL = 1e-4


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
    return rng.normal(size=(n, 56, 56, 3)).astype(np.float32)


def _models(gelu, softmax, ln, **kw):
    kw = {**GEOM, "gelu_type": gelu, "softmax_type": softmax, "layernorm_type": ln, **kw}
    return JaxSwin(**kw), SwinTransformer(device="cpu", **kw)


def _init(jm, x):
    return jax.device_get(jm.init(jax.random.PRNGKey(0), x, running_stat=True))


def _calibrate(jm, tm, rng):
    """Zeroed ranges, JAX's parameters, two calibrating batches in both
    sims; returns JAX's variables and each batch's (JAX, port) logits."""
    v = _init(jm, _images(rng))
    params, qs = v["params"], jax.tree.map(np.zeros_like, v["quant_stats"])
    variables_to_torch(tm, {"params": params, "quant_stats": qs})
    logits = []
    for _ in range(2):
        xb = _images(rng)
        want, st = jm.apply({"params": params, "quant_stats": qs}, xb,
                            running_stat=True, mutable=["quant_stats"])
        qs = jax.device_get(st["quant_stats"])
        with torch.no_grad():
            got = tm(torch.from_numpy(xb), running_stat=True)
        logits.append((np.asarray(want), got.numpy()))
    return {"params": params, "quant_stats": qs}, logits


def _close(want, got, tol):
    for path in differing_leaves(want, got):
        w, g = want, got
        for k in path.strip("/").split("/"):
            w, g = w[k], g[k]
        np.testing.assert_allclose(g, w, rtol=tol, atol=1e-6, err_msg=path)


@pytest.mark.parametrize("gelu,softmax,ln", FAMILIES,
                         ids=["/".join(f) for f in FAMILIES])
def test_calibration_and_eval_match_jax(gelu, softmax, ln):
    rng = np.random.default_rng(0)
    jm, tm = _models(gelu, softmax, ln,
                     **(dict(depths=(2,), num_heads=(2,)) if gelu == PPOLY else {}))
    variables, logits = _calibrate(jm, tm, rng)
    got_stats = variables_to_numpy(tm)["quant_stats"]
    if gelu == "float":
        _close(variables["quant_stats"], got_stats, FLOAT_TOL)
    else:
        for want, got in logits:
            np.testing.assert_array_equal(got, want)
        assert differing_leaves(variables["quant_stats"], got_stats) == []
    if gelu == PPOLY:
        variables = jax.device_get(jax_fit_ppoly(jm, variables))
        fit_tables(tm)
        assert differing_leaves(variables, variables_to_numpy(tm)) == []
    x = _images(rng)
    want = np.asarray(jm.apply(variables, x, running_stat=False))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert np.isfinite(got).all() and got.shape == (2, 10)
    if gelu == "float":
        assert np.abs(got - want).max() <= FLOAT_TOL * np.abs(want).max()
    else:
        np.testing.assert_array_equal(got, want)


def test_ape_ranges_match_jax():
    rng = np.random.default_rng(1)
    jm, tm = _models("ivit", "ivit", "ivit", ape=True)
    variables, logits = _calibrate(jm, tm, rng)
    assert "absolute_pos_embed" in variables["params"]
    assert "qact_pos" in variables["quant_stats"]
    for want, got in logits:
        np.testing.assert_array_equal(got, want)
    assert differing_leaves(variables["quant_stats"],
                            variables_to_numpy(tm)["quant_stats"]) == []


def test_chunked_apply_equals_forward():
    """``swin_chunked_apply`` and ``scan_apply`` against the forward of an
    identical copy: calibrating (logits and every range) and evaluating."""
    rng = np.random.default_rng(2)
    x1, x2 = torch.from_numpy(_images(rng)), torch.from_numpy(_images(rng))
    for make, chunked, xs in (
            (lambda: SwinTransformer(device="cpu", seed=3, **GEOM), swin_chunked_apply,
             (x1, x2)),
            (lambda: VisionTransformer(img_size=56, patch_size=8, embed_dim=32, depth=2,
                                       num_heads=2, num_classes=10, device="cpu", seed=3),
             scan_apply, (x1, x2))):
        ref, mod = make(), make()
        with torch.no_grad():
            for x in xs:
                want = ref(x, running_stat=True)
                got, st = chunked(mod, x, running_stat=True)
                assert torch.equal(got, want)
                assert differing_leaves(st["quant_stats"],
                                        variables_to_numpy(ref)["quant_stats"]) == []
            assert torch.equal(chunked(mod, x1), ref(x1))


def test_gradients_match_jax():
    rng = np.random.default_rng(3)
    jm, tm = _models("ivit", "ibert", "ibert")
    x = _images(rng)
    labels = np.array([1, 2])
    v = _init(jm, x)
    variables_to_torch(tm, v)

    def loss_fn(params):
        logits, _ = jm.apply({"params": params, "quant_stats": v["quant_stats"]},
                             x, running_stat=True, mutable=["quant_stats"])
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(logp[jnp.arange(2), labels])

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(v["params"])
    t_loss = torch.nn.functional.cross_entropy(
        tm(torch.from_numpy(x), running_stat=True), torch.from_numpy(labels))
    t_loss.backward()
    assert np.isfinite(float(loss))
    np.testing.assert_allclose(float(t_loss.detach()), float(loss), rtol=GRAD_RTOL)
    tgrads = {n: p.grad for n, p in tm.named_parameters()}
    leaves = []

    def walk(tree, path=()):
        for k, val in tree.items():
            if isinstance(val, dict):
                walk(val, path + (k,))
            else:
                leaves.append((path + (k,), np.asarray(val)))
    walk(jax.device_get(grads))
    assert len(leaves) == len(tgrads)
    for path, g in leaves:
        t = tgrads[_torch_name(path)]
        t = np.zeros_like(g) if t is None else t.numpy()    # LN bias: detached
        assert np.isfinite(t).all()
        np.testing.assert_allclose(t, g, rtol=0, atol=GRAD_RTOL * np.abs(g).max(),
                                   err_msg="/".join(path))
    blocks = [b for blocks, _ in tm.stages for b in blocks]
    reach = ([tm.patch_embed.proj.kernel] + [b.attn.qkv.kernel for b in blocks]
             + [blocks[0].attn.relative_position_bias_table])
    assert all(p.grad.abs().sum() > 0 for p in reach)


def test_ivit_probabilities_live():
    """Not every ivit probability floors to 0 in the calibrated sim."""
    rng = np.random.default_rng(4)
    _, tm = _models("ivit", "ivit", "ivit")
    with torch.no_grad():
        tm(torch.from_numpy(_images(rng)), running_stat=True)
        probs = []
        hooks = [b.attn.int_softmax.register_forward_hook(
            lambda mod, args, out: probs.append(float((out[0] != 0).float().mean())))
            for blocks, _ in tm.stages for b in blocks]
        try:
            tm(torch.from_numpy(_images(rng)))
        finally:
            for h in hooks:
                h.remove()
    print("nonzero ivit probability share by block:", probs)
    assert len(probs) == 4 and min(probs) > 0


def test_swin_factories_default_to_cuda():
    """The Swin sim and its factories run on the card unless asked: without
    one they raise rather than fall back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SwinTransformer(**GEOM)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        str2model("swin_tiny_patch4_window7_224")(img_size=56, depths=(2,))
    m = str2model("swin_base_patch4_window7_224")(img_size=56, depths=(2,),
                                                   num_heads=(2,), device="cpu")
    assert m.embed_dim == 128 and m.device.type == "cpu"
