"""The port's ivit family bit-exact against the JAX package (tolerance 0).

* the ivit integer cores over the whole int8 (difference) domain, at
  calibrated scales and at scales where the fast-quotient gate fails, and
  I-LayerNorm on random int8/int16 rows;
* the plain versions of the two standalone kernels against ``shiftmax_p`` /
  ``shift_gelu_requant_p`` in interpret mode, at the shapes of
  ``tests/test_pallas.py`` (int16 probs included);
* the plain versions of the two block kernels in the ivit and mixed
  families, LN in the kernel and hoisted (``ln_in``), against
  ``mlp_block_p`` / ``attn_block_p`` in interpret mode;
* the engine at 64 px on real JAX freezes of the three family mixes of
  ``tests/test_pallas.py``, each port path against its JAX counterpart;
* DeiT-S width at 224 px, a synthetic ivit spec through JAX's unfused
  engine and all three port paths;
* the synthetic ivit spec has a JAX ivit freeze's tree and config.
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
from test_torch_port_engine import _images, _to_jax, _to_port, _tree  # noqa: E402

import ivit_tpu.ops.pallas as ppkg  # noqa: E402
from ivit_tpu.engine import freeze_model  # noqa: E402
from ivit_tpu.engine import vit_int as jvit  # noqa: E402
from ivit_tpu.ops import ivit as jiv  # noqa: E402
from ivit_tpu.ops.pallas import block as jblk  # noqa: E402
from ivit_tpu.ops.pallas import nonlinear as jnl  # noqa: E402
from ivit_tpu_torch.engine import Engine, engine_forward  # noqa: E402
from ivit_tpu_torch.engine.synthetic import (S_ATTN_IVIT, deit_small_config,  # noqa: E402
                                              synthetic_spec)
from ivit_tpu_torch.ops import ivit as tiv  # noqa: E402
from ivit_tpu_torch.ops.kernels import block as kb  # noqa: E402
from ivit_tpu_torch.ops.kernels import nonlinear as knl  # noqa: E402

# calibrated DeiT-S sizes (softmax, GELU), larger, and small enough that
# the fast-quotient gate fails (s < ~1.3e-4 at n = 15)
SCALES = [0.0045778966, 0.014047618, 0.0521371, 1e-4]
INT8 = np.arange(-128, 128, dtype=np.float32)
DIFF = np.arange(-255, 1, dtype=np.float32)         # x - rowmax of int8 scores
# (gelu, softmax, ln): the mixes of test_pallas.py's block-kernel test
MIXES = [("ivit", "ivit", "ivit"), ("ivit", "ivit", "ibert"),
         ("ibert", "ibert", "ivit")]
MIX_IDS = ["/".join(m) for m in MIXES]


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


# --- (a) the integer cores --------------------------------------------------

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


@pytest.mark.parametrize("s", SCALES)
def test_ivit_cores_whole_int8_domain(s):
    rows = np.stack([np.random.default_rng(i).permutation(INT8) for i in range(4)])
    for fast_q in (False, True):
        for n in (15, 23):
            got, got_s = tiv.int_exp_shift(_t(DIFF), _t(s), n, fast_q)
            want, want_s = jiv.int_exp_shift(jnp.asarray(DIFF), jnp.float32(s), n,
                                             fast_q)
            _eq(got, want)
            _eq(got_s, want_s)
        for bit, n_valid in ((8, None), (8, 200), (16, None)):
            got, got_s = tiv.shiftmax_int(_t(rows), _t(s), bit, n_valid, fast_q)
            want, want_s = jiv.shiftmax_int(jnp.asarray(rows), jnp.float32(s), bit,
                                            n_valid, fast_q)
            _eq(got, want)
            _eq(got_s, want_s)
        got, got_s = tiv.shift_gelu_int(_t(rows), _t(s), 8, fast_q=fast_q)
        want, want_s = jiv.shift_gelu_int(jnp.asarray(rows), jnp.float32(s), 8,
                                          fast_q=fast_q)
        _eq(got, want)
        _eq(got_s, want_s)


@pytest.mark.parametrize("lim", [2**7, 2**12, 2**15])
def test_i_layernorm_and_newton_sqrt(lim):
    rng = np.random.default_rng(lim)
    x = rng.integers(-lim, lim, (32, 384)).astype(np.float32)
    x[0] = 5.0                                       # zero variance: k = 64
    w = rng.uniform(0.5, 1.5, 384).astype(np.float32)
    b = rng.normal(0, 0.2, 384).astype(np.float32)
    got, got_s = tiv.i_layernorm_int(_t(x), _t(w), _t(b))
    want, want_s = jiv.i_layernorm_int(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    _eq(got, want)
    _eq(got_s, want_s)
    v = rng.integers(0, 2**31, 4096).astype(np.float32)
    _eq(tiv.int_newton_sqrt(_t(v)), jiv.int_newton_sqrt(jnp.asarray(v)))


def test_random_init_softmax_scale_floors_every_probability():
    """Why the synthetic ivit spec does not take its freeze's softmax scale:
    at a random-init DeiT-S's calibrated scales every 8-bit Shiftmax
    probability of a 197-key row of int8 scores is 0, so attention would
    pass nothing; at the spec's scales (the JAX Shiftmax tests') a few
    dozen keys of each row keep a probability.  Port and JAX agree."""
    rows = np.random.default_rng(0).integers(-127, 128, (256, 197)).astype(np.float32)
    for s, live in ((0.0045778966, 0), (0.0048980233, 0),
                    (S_ATTN_IVIT[0], 32.7), (S_ATTN_IVIT[1], 29.8)):
        got, _ = tiv.shiftmax_int(_t(rows), _t(s), 8, fast_q=True)
        want, _ = jiv.shiftmax_int(jnp.asarray(rows), jnp.float32(s), 8,
                                   fast_q=True)
        _eq(got, want)
        assert round(float((want > 0).sum(-1).mean()), 1) == live


# --- (b) the standalone kernels' plain versions -----------------------------

SHIFTMAX_CASES = [  # (shape, s, output_bit, n_valid): test_pallas.py's shapes
    ((4, 6, 37, 197), 0.0521371, 8, None),
    ((130, 50), 0.061, 8, None),
    ((16, 197), 0.0521371, 16, None),
    ((4, 6, 37, 197), 0.0045778966, 8, 180),
    # one column at x0 = -1: its exp is 2**15, its probability 2**(bits - 1),
    # which the conversion saturates at the container's top
    ((4, 1), 2.0, 8, None),
    ((4, 1), 2.0, 16, None),
]


@pytest.mark.parametrize("shape,s,bit,n_valid", SHIFTMAX_CASES)
def test_shiftmax_ref_matches_pallas(shape, s, bit, n_valid):
    scores = np.random.default_rng(0).integers(-127, 128, shape).astype(np.int8)
    for fast_q in (False, True):
        want = jnl.shiftmax_p(jnp.asarray(scores), jnp.asarray(np.float32(s)), bit,
                              n_valid=n_valid, tile_rows=64, interpret=True,
                              fast_q=fast_q)
        before = knl.shiftmax.launches
        got = knl.shiftmax(torch.from_numpy(scores), _t(s), bit, n_valid=n_valid,
                           fast_q=fast_q)
        assert knl.shiftmax.launches == before       # the CPU runs no kernel
        assert got.dtype == (torch.int8 if bit <= 8 else torch.int16)
        _eq(got.numpy(), want)
    if bit == 16:
        assert int(np.asarray(want).max()) > 127


@pytest.mark.parametrize("shape,s,m_out", [((64, 384), 0.0417093, 0.031727),
                                           ((2, 17, 1536), 0.014047618, 0.5)])
def test_shift_gelu_requant_ref_matches_pallas(shape, s, m_out):
    x = np.random.default_rng(1).integers(-127, 128, shape).astype(np.int8)
    for fast_q in (False, True):
        want = jnl.shift_gelu_requant_p(jnp.asarray(x), jnp.asarray(np.float32(s)),
                                        jnp.asarray(np.float32(m_out)), 8,
                                        interpret=True, fast_q=fast_q)
        before = knl.shift_gelu_requant.launches
        got = knl.shift_gelu_requant(torch.from_numpy(x), _t(s), _t(m_out), 8,
                                     fast_q=fast_q)
        assert knl.shift_gelu_requant.launches == before
        _eq(got.numpy(), want)


# --- (c) the block kernels' plain versions ----------------------------------

B, NP, NV, C, HEADS = 2, 24, 17, 64, 2              # PR 1's padded geometry


def _small_spec(gelu, softmax, ln, depth=1, seed=3):
    cfg = dataclasses.replace(
        deit_small_config(depth=depth, img_size=64, ln=ln, gelu=gelu,
                          softmax=softmax),
        embed_dim=C, num_heads=HEADS, num_classes=10)
    return synthetic_spec(cfg, seed=seed)


def _x(seed):
    x = np.clip(np.round(np.random.default_rng(seed).normal(0, 32, (B, NP, C))),
                -128, 127).astype(np.int8)
    x[:, NV:] = 0
    return x


def _ln_in(jcfg, x, blk, which):
    """The JAX engine's hoisted LN (``_hoisted_ln8``) of x, or None where
    ``IVIT_HOIST_LN`` keeps the LN in the kernel."""
    if not jvit._hoist_ln_on(jcfg.base_type("ln")):
        return None
    return np.asarray(jvit._hoisted_ln8(
        jcfg, jnp.asarray(x), blk[f"ln{which}_bias_int"],
        blk[f"ln{which}_shift"], blk[f"s_ln{which}"], blk[f"m_ln{which}"]))


def _mlp_kw(b, mix, fast, as_t):
    keys = dict(ln_bias="ln2_bias_int", m_ln="m_ln2", ln_shift="ln2_shift",
                fc1_w="fc1_w", fc1_b="fc1_b", m_fc1="m_fc1", s_gelu="s_gelu",
                m_gelu="m_gelu", fc2_w="fc2_w", fc2_b="fc2_b", m_fc2="m_fc2",
                m_res_x="m_res2_x", m_res_id="m_res2_id")
    kw = {k: as_t(b[v]) for k, v in keys.items()}
    kw.update(ln_base=mix[2], gelu_base=mix[0], fast_exp=fast, fast_poly=fast)
    return kw


def _attn_kw(b, mix, fast, as_t):
    keys = dict(ln_bias="ln1_bias_int", m_ln="m_ln1", ln_shift="ln1_shift",
                qkv_w="qkv_w", qkv_b="qkv_b", m_qkv="m_qkv", m_attn="m_attn",
                s_attn="s_attn", m_av="m_av", proj_w="proj_w", proj_b="proj_b",
                m_proj="m_proj", m_res_x="m_res1_x", m_res_id="m_res1_id")
    kw = {k: as_t(b[v]) for k, v in keys.items()}
    if "s_exp_act" in b:
        kw["s_exp_act"] = as_t(b["s_exp_act"])
    kw.update(num_heads=HEADS, n_valid=NV, ln_base=mix[2], sm_base=mix[1],
              fast_exp=fast, fast_poly=fast)
    return kw


@pytest.mark.parametrize("hoist", ["0", "1"])
@pytest.mark.parametrize("mix", MIXES, ids=MIX_IDS)
def test_ivit_block_refs_match_pallas(mix, hoist, monkeypatch):
    monkeypatch.setenv("IVIT_HOIST_LN", hoist)
    spec = _small_spec(*mix)
    jcfg = _to_jax(spec).config
    blk = spec.params["blocks"][0]
    valid = (np.arange(B * NP) % NP) < NV
    for fast in (False, True):
        x = _x(0).reshape(B * NP, C)
        ln_in = _ln_in(jcfg, x, blk, 2)
        want = jblk.mlp_block_p(
            jnp.asarray(x), s_ln=jnp.asarray(blk["s_ln2"]), interpret=True,
            ln_in=None if ln_in is None else jnp.asarray(ln_in),
            **_mlp_kw(blk, mix, fast, jnp.asarray))
        got = kb.mlp_block(torch.from_numpy(x),
                           ln_in=None if ln_in is None else torch.from_numpy(ln_in),
                           **_mlp_kw(blk, mix, fast, torch.as_tensor))
        _eq(got.numpy()[valid], np.asarray(want)[valid])

        x = _x(1)
        ln_in = _ln_in(jcfg, x, blk, 1)
        want = jblk.attn_block_p(
            jnp.asarray(x), s_ln=jnp.asarray(blk["s_ln1"]), sm_bit=8,
            interpret=True, ln_in=None if ln_in is None else jnp.asarray(ln_in),
            **_attn_kw(blk, mix, fast, jnp.asarray))
        got = kb.attn_block(torch.from_numpy(x),
                            ln_in=None if ln_in is None else torch.from_numpy(ln_in),
                            **_attn_kw(blk, mix, fast, torch.as_tensor))
        _eq(got.numpy()[:, :NV], np.asarray(want)[:, :NV])


# --- (d) the engine at 64 px on real JAX freezes -----------------------------

@pytest.fixture(scope="module")
def freezes():
    out = {}
    for gelu, softmax, ln in MIXES:
        model, variables = build_calibrated(np.random.default_rng(0), gelu=gelu,
                                            softmax=softmax, ln=ln,
                                            calib_batches=1)
        out[(gelu, softmax, ln)] = freeze_model(model, variables)
    return out


def _jax_interpret(jspec, x, pallas):
    ppkg.FORCE_INTERPRET = True
    try:
        return np.asarray(jvit.engine_forward(jspec, jnp.asarray(x), pallas=pallas))
    finally:
        ppkg.FORCE_INTERPRET = False


@pytest.mark.parametrize("mix", MIXES, ids=MIX_IDS)
def test_engine_paths_match_jax(freezes, mix):
    """Port ``kernels=False`` / ``True`` / ``"ops"`` against JAX
    ``pallas=False`` / ``True`` / ``"ops"`` (interpret mode); with ``"ops"``
    the standalone kernels stand in only for the ivit softmax and GELU."""
    jspec = freezes[mix]
    assert "sm_lut" in jspec.params["blocks"][0]     # ignored: towers run
    spec = _to_port(jspec)
    x = _images(3, 64, seed=4)
    want = np.asarray(jvit.engine_forward(jspec, jnp.asarray(x), pallas=False))
    _eq(engine_forward(spec, x, kernels=False, device="cpu").numpy(), want)
    for path in (True, "ops"):
        got = engine_forward(spec, x, kernels=path, device="cpu")
        _eq(got.numpy(), _jax_interpret(jspec, x, path))


# --- (e) DeiT-S width, 224 px ------------------------------------------------

def test_deit_small_width_ivit_synthetic_matches_jax():
    spec = synthetic_spec(deit_small_config(depth=1, ln="ivit", gelu="ivit",
                                            softmax="ivit"), seed=0)
    x = _images(2, 224, seed=5)
    want = np.asarray(jvit.engine_forward(_to_jax(spec), jnp.asarray(x),
                                          pallas=False))
    for path in (False, True, "ops"):
        _eq(engine_forward(spec, x, kernels=path, device="cpu").numpy(), want)
    assert np.isfinite(want).all() and want.std(axis=0).max() > 0


# --- (f) the synthetic spec's tree -------------------------------------------

def test_ivit_synthetic_spec_has_the_freeze_tree(freezes):
    jspec = freezes[("ivit", "ivit", "ivit")]
    want = _tree(jax.device_get(jspec.params))
    assert "blocks/s_exp_act" not in want
    small = synthetic_spec(_to_port(jspec).config, seed=0)
    assert _tree(small.params) == want
    assert len(small.params["blocks"]) == len(jspec.params["blocks"])
    jc, sc = dataclasses.asdict(jspec.config), dataclasses.asdict(small.config)
    for k in ("bitwidths", "use_lut"):      # BitWidths types differ; no LUTs
        jc.pop(k), sc.pop(k)
    assert sc == jc
    # the mixes carry the same keys as their JAX freezes
    for mix in MIXES[1:]:
        jspec = freezes[mix]
        small = synthetic_spec(_to_port(jspec).config, seed=0)
        assert _tree(small.params) == _tree(jax.device_get(jspec.params))


@pytest.mark.parametrize("which", ["gelu", "softmax", "ln"])
def test_engine_refuses_families_not_ported(which):
    fams = {"gelu": "ivit", "softmax": "ivit", "ln": "ivit"}
    spec = synthetic_spec(dataclasses.replace(
        deit_small_config(depth=1, img_size=32, **fams), embed_dim=64,
        num_heads=2, num_classes=10), seed=0)
    field = {"gelu": "gelu_type", "softmax": "softmax_type",
             "ln": "layernorm_type"}[which]
    # every softmax and GELU family runs (float: tests/test_torch_port_float.py);
    # the LayerNorm is ivit or ibert, as in JAX's engine
    refused = [("sigmoid", "unknown family")]
    if which == "ln":
        refused += [("float", "no float LayerNorm"), ("ppoly", "no LayerNorm")]
    else:
        Engine(dataclasses.replace(spec, config=dataclasses.replace(
            spec.config, **{field: "float"})), device="cpu")
    for fam, item in refused:
        bad = dataclasses.replace(spec, config=dataclasses.replace(
            spec.config, **{field: fam}))
        with pytest.raises(NotImplementedError, match=item):
            Engine(bad, device="cpu")
        with pytest.raises(NotImplementedError, match=f"{which} family"):
            engine_forward(bad, np.zeros((1, 32, 32, 3), np.float32), device="cpu")
    with pytest.raises(ValueError, match="kernels="):
        Engine(spec, device="cpu", kernels="fused")
