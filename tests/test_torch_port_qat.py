"""The port's QAT sim (``ivit_tpu_torch.models``) against the JAX sim.

At ``tests/test_engine.py::build_calibrated``'s geometry (64 px, depth 2,
embed 64, 2 heads, 10 classes), on variables JAX initialized
(``model.init``) and carried across with ``variables_to_torch``:

* calibration from zeroed ranges, two batches of 4 images: every
  ``quant_stats`` leaf bitwise equal to the JAX sim's, for the families of
  ``test_engine.py:31-36``, ppoly (ibert backend, ibert LN, depth 1) and
  the INT16 bitwidths; the JAX side runs eagerly, op by op (and so its
  ops compile once for the whole file).  Under
  ``jax.jit`` XLA contracts the residual QuantAct's ``x + identity``
  (``x`` a product ``out * scale``) into one FMA, which moves a residual
  range by an ulp; eager JAX rounds the product first, as PyTorch does, and
  its ranges are the port's to the bit (the JAX package's own ``ema_update``
  docstring describes such context shifts);
* frozen-eval logits (``running_stat=False``) bitwise equal,
  the ppoly sites fitted by JAX's ``fit_ppoly_tables`` first;
* the float family within its stated tolerance: torch's and XLA's f32
  ``exp`` / ``erf`` may differ in the last ulp, which moves a quantized
  probability or GELU output by 1 (``tests/test_torch_port_float.py``):
  logits within 5% of the largest, ranges within 5%;
* the QuantAct modes of ``tests/test_model.py:122-175`` (percentile,
  per-channel, momentum -1) bitwise, and their assertions;
* the ivit probabilities are not all zero;
* ``variables_to_numpy`` of ``variables_to_torch`` is the JAX tree, leaf
  for leaf;
* ``jax.grad`` (jitted) of ``test_model.py:68``'s loss against
  ``.backward()`` at depth 1, ivit GELU, ibert softmax and LN: each
  gradient within ``GRAD_RTOL`` of the largest of its tensor (the two
  backward passes sum in other orders), finite, nonzero at
  the patch projection and the blocks' qkv.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivit_tpu.models import BitWidths as JaxBitWidths
from ivit_tpu.models import VisionTransformer as JaxViT
from ivit_tpu.models.layers import QuantAct as JaxQuantAct
from ivit_tpu.train.ppoly_fit import fit_ppoly_tables as jax_fit_ppoly
from ivit_tpu_torch.models import VisionTransformer, str2model
from ivit_tpu_torch.models.convert import variables_to_numpy, variables_to_torch
from ivit_tpu_torch.models.layers import QuantAct

GEOM = dict(img_size=64, patch_size=16, embed_dim=64, depth=2, num_heads=2,
            num_classes=10)
PPOLY = "ppoly_backend_ibert"
INT16 = "8,8,8,8,16,8,16,8"
FAMILIES = [  # (gelu, softmax, ln, bitwidths, depth)
    ("ivit", "ivit", "ivit", "8", 2),
    ("ibert", "ibert", "ibert", "8", 2),
    ("ivit", "ibert", "ivit", "8", 2),
    ("ibert", "ivit", "ibert_use-int-sqrt_true", "8", 2),
    (PPOLY, PPOLY, "ibert", "8", 1),
    ("ivit", "ivit", "ivit", INT16, 2),
    ("float", "float", "float", "8", 2),
]
FLOAT_TOL = 0.05
GRAD_RTOL = 1e-4


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


def _images(rng, n=4):
    return rng.normal(size=(n, 64, 64, 3)).astype(np.float32)


def _models(gelu, softmax, ln, bits="8", depth=2):
    kw = dict(GEOM, depth=depth, gelu_type=gelu, softmax_type=softmax,
              layernorm_type=ln)
    jm = JaxViT(bitwidths=JaxBitWidths.from_spec(bits), **kw)
    tm = VisionTransformer(bitwidths=bits, device="cpu", **kw)
    return jm, tm


def _init(jm, x):
    return jax.device_get(jm.init(jax.random.PRNGKey(0), x, running_stat=True))


def _assert_stats(want, got, tol=None):
    got = dict(_leaves(got))
    want = dict(_leaves(want))
    assert got.keys() == want.keys()
    for path, w in want.items():
        if tol is None:
            np.testing.assert_array_equal(got[path], w, err_msg="/".join(path))
        else:
            np.testing.assert_allclose(got[path], w, rtol=tol, atol=1e-6,
                                       err_msg="/".join(path))


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


@pytest.mark.parametrize("gelu,softmax,ln,bits,depth", FAMILIES,
                         ids=["/".join(f[:3]) + f"@{f[3]}" for f in FAMILIES])
def test_calibration_and_eval_match_jax(gelu, softmax, ln, bits, depth):
    rng = np.random.default_rng(0)
    jm, tm = _models(gelu, softmax, ln, bits, depth)
    v = _init(jm, _images(rng))
    params, qs = v["params"], jax.tree.map(np.zeros_like, v["quant_stats"])
    variables_to_torch(tm, {"params": params, "quant_stats": qs})
    tol = FLOAT_TOL if gelu == "float" else None
    for _ in range(2):
        xb = _images(rng)
        want, st = jm.apply({"params": params, "quant_stats": qs}, xb,
                            running_stat=True, mutable=["quant_stats"])
        qs = jax.device_get(st["quant_stats"])
        got = tm(torch.from_numpy(xb), running_stat=True).detach().numpy()
        if tol is None:
            np.testing.assert_array_equal(got, np.asarray(want))
    _assert_stats(qs, variables_to_numpy(tm)["quant_stats"], tol)

    variables = {"params": params, "quant_stats": qs}
    if gelu == PPOLY:
        variables = jax.device_get(jax_fit_ppoly(jm, variables))
        variables_to_torch(tm, variables)
    x = _images(rng)
    want = np.asarray(jm.apply(variables, x, running_stat=False))
    got = tm(torch.from_numpy(x)).detach().numpy()
    assert np.isfinite(got).all() and got.shape == (4, 10)
    if tol is None:
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(got - want).max() <= tol * np.abs(want).max()


def test_variables_round_trip():
    rng = np.random.default_rng(1)
    jm, tm = _models("ibert", PPOLY, "ibert")
    v = _init(jm, _images(rng))
    back = variables_to_numpy(variables_to_torch(tm, v))
    for coll in ("params", "quant_stats"):
        want, got = dict(_leaves(v[coll])), dict(_leaves(back[coll]))
        assert got.keys() == want.keys()
        for path, w in want.items():
            assert got[path].dtype == w.dtype and got[path].shape == w.shape
            np.testing.assert_array_equal(got[path], w)
    with pytest.raises(KeyError):
        variables_to_torch(tm, {"params": {**v["params"], "extra": np.zeros(1)},
                                "quant_stats": v["quant_stats"]})


def test_ivit_probabilities_live():
    """The calibrated ivit sim's Shiftmax passes something: not every
    probability floors to 0."""
    rng = np.random.default_rng(2)
    jm, tm = _models("ivit", "ivit", "ivit")
    variables_to_torch(tm, _init(jm, _images(rng)))
    probs = []
    hook = tm.blocks[0].attn.int_softmax.register_forward_hook(
        lambda mod, args, out: probs.append(out[0].detach()))
    try:
        tm(torch.from_numpy(_images(rng)))
    finally:
        hook.remove()
    assert float((probs[0] != 0).float().mean()) > 0


def _quantact_pair(x, **kw):
    """(JAX (out, scale, stats), port (out, scale, stats)) of one
    calibrating call on ``x``."""
    jmod = JaxQuantAct(8, **kw)
    v = jmod.init(jax.random.PRNGKey(0), x, running_stat=True)
    v = jax.tree.map(jnp.zeros_like, v)
    (jy, js), st = jmod.apply(v, x, running_stat=True, mutable=["quant_stats"])
    tmod = QuantAct(8, **kw)
    ty, ts = tmod(torch.from_numpy(np.asarray(x)), running_stat=True)
    return ((np.asarray(jy), np.asarray(js), jax.device_get(st["quant_stats"])),
            (ty.numpy(), ts.numpy(), {k: b.numpy() for k, b in tmod.named_buffers()}),
            tmod)


def _assert_same(pair):
    (jy, js, jst), (ty, ts, tst), _ = pair
    np.testing.assert_array_equal(ty, jy)
    np.testing.assert_array_equal(ts, js)
    for k, w in jst.items():
        np.testing.assert_array_equal(tst[k], np.asarray(w))


def test_quantact_modes_match_jax():
    """``test_model.py:122-175``'s QuantAct modes, each against JAX."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 32)).astype(np.float32)
    x[0, 0] = 100.0                                      # an outlier
    plain, pct = _quantact_pair(x), _quantact_pair(x, percentile=99.0)
    _assert_same(plain)
    _assert_same(pct)
    assert float(pct[1][1][0]) < float(plain[1][1][0]) / 5

    c = 8
    xc = rng.normal(size=(16, 10, c)).astype(np.float32)
    xc[..., 0] *= 100.0                                  # one hot channel
    per = _quantact_pair(xc, per_channel=True, channel_len=c)
    _assert_same(per)
    s = per[1][1]
    assert s.shape == (c,) and s[0] > 10 * s[1:].max()
    _assert_same(_quantact_pair(xc, per_channel=True, channel_len=c,
                                percentile=99.0))

    x1 = rng.normal(size=(8, 4)).astype(np.float32)
    first = _quantact_pair(x1, act_range_momentum=-1)
    _assert_same(first)
    tmod = first[2]
    before = tmod.x_max.clone()
    tmod(torch.from_numpy(x1 * 0.01), running_stat=True)
    assert torch.equal(tmod.x_max, before)       # the running max never shrinks
    ema = _quantact_pair(x1)[2]                   # momentum 0.95: the EMA moves
    ema(torch.from_numpy(x1 * 0.01), running_stat=True)
    jmod = JaxQuantAct(8)
    v = jax.tree.map(jnp.zeros_like, jmod.init(jax.random.PRNGKey(0), x1,
                                               running_stat=True))
    for xb in (x1, x1 * 0.01):
        _, st = jmod.apply(v, xb, running_stat=True, mutable=["quant_stats"])
        v = {"quant_stats": st["quant_stats"]}
    np.testing.assert_array_equal(ema.x_max.numpy(),
                                  np.asarray(v["quant_stats"]["x_max"]))


def test_gradients_match_jax():
    rng = np.random.default_rng(3)
    jm, tm = _models("ivit", "ibert", "ibert", depth=1)
    x = _images(rng, 2)
    labels = np.array([1, 2])
    v = _init(jm, x)
    variables_to_torch(tm, v)

    def loss_fn(params):
        logits, _ = jm.apply({"params": params, "quant_stats": v["quant_stats"]},
                             x, running_stat=True, mutable=["quant_stats"])
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(logp[jnp.arange(2), labels])

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(v["params"])
    logits = tm(torch.from_numpy(x), running_stat=True)
    t_loss = torch.nn.functional.cross_entropy(logits, torch.from_numpy(labels))
    t_loss.backward()
    assert np.isfinite(float(loss))
    np.testing.assert_allclose(float(t_loss.detach()), float(loss), rtol=GRAD_RTOL)
    tgrads = {n: p.grad for n, p in tm.named_parameters()}
    from ivit_tpu_torch.models.convert import _torch_name
    for path, g in _leaves(jax.device_get(grads)):
        t = tgrads[_torch_name(path)]
        t = np.zeros_like(g) if t is None else t.numpy()  # LN bias: detached
        assert np.isfinite(t).all()
        np.testing.assert_allclose(t, g, rtol=0, atol=GRAD_RTOL * np.abs(g).max(),
                                   err_msg="/".join(path))
    # the quantized graph backprops into the conv and the attention weights
    assert tm.patch_embed.proj.kernel.grad.abs().sum() > 0
    assert all(b.attn.qkv.kernel.grad.abs().sum() > 0 for b in tm.blocks)


def test_entry_points_default_to_cuda():
    """The sim and its factories run on the card unless asked: without one
    they raise rather than fall back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VisionTransformer(**GEOM)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        str2model("deit_tiny_patch16_224")(img_size=64, depth=1)
    m = str2model("deit_tiny_patch16_224")(img_size=64, depth=1, device="cpu")
    assert m.embed_dim == 192 and m.device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        str2model("swin_tiny_patch4_window7_224")()
    with pytest.raises(ValueError, match="unknown model"):
        str2model("swin_huge")
