"""The port's ppoly family (ViT) bit-exact against the JAX package
(tolerance 0).

* ``eval_piecewise_poly`` over the int8 domain and the softmax's offset
  domain, for fitted tables of 1-16 segments and degrees 1-3;
* the port's fit against JAX's on the same inputs (bounds, coefficients,
  output scale), both backends, the boundary search, a coefficient that
  the int32 clip cuts;
* on a JAX freeze of a calibrated, ``fit_ppoly_tables``-fitted 64 px ViT
  (depth 1, ppoly GELU and softmax, ibert LN): the port's ``fit_site`` on
  each site's calibrated range gives the freeze's leaves, and its fast-div
  gate JAX's ``(ok, c, patch_h, patch_d)``;
* the plain versions of the MLP and attention kernels with the ppoly GELU
  (fast-div on and off) and softmax (``n_valid`` below the token count;
  8- and 16-bit probabilities) against JAX ``mlp_block_p`` /
  ``attn_block_p`` in interpret mode;
* the engine on that freeze: ``kernels=False`` / ``True`` / ``"ops"``
  against JAX ``pallas=False`` / ``True`` (interpret) / ``"ops"``, fast-div
  on and off;
* the synthetic ppoly spec has the freeze's tree and config.
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
from test_torch_port_engine import _images, _to_port, _tree  # noqa: E402

import ivit_tpu.ops.pallas as ppkg  # noqa: E402
from ivit_tpu.engine import freeze_model  # noqa: E402
from ivit_tpu.engine import freeze as jfreeze  # noqa: E402
from ivit_tpu.engine import vit_int as jvit  # noqa: E402
from ivit_tpu.models import VisionTransformer  # noqa: E402
from ivit_tpu.ops import ppoly as jpp  # noqa: E402
from ivit_tpu.ops.pallas import block as jblk  # noqa: E402
from ivit_tpu.train.ppoly_fit import fit_ppoly_tables  # noqa: E402
from ivit_tpu_torch.engine import engine_forward  # noqa: E402
from ivit_tpu_torch.engine import freeze as tfreeze  # noqa: E402
from ivit_tpu_torch.engine.synthetic import synthetic_spec  # noqa: E402
from ivit_tpu_torch.ops import ppoly as tpp  # noqa: E402
from ivit_tpu_torch.ops.kernels import block as kb  # noqa: E402

PPOLY = "ppoly_backend_ibert"
INT8 = np.arange(-128, 128, dtype=np.float32)
OFFSETS = np.arange(-383, 128, dtype=np.float32)   # x - max + 127, 16-bit rows too


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


# --- (a) evaluation --------------------------------------------------------

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


@pytest.mark.parametrize("seg,deg", [(1, 2), (4, 1), (16, 2), (8, 3)])
def test_eval_piecewise_poly_matches_jax(seg, deg):
    gelu = jpp.fit_gelu_table(-6.4, 6.35, 0.05, backend="float", seg=seg,
                              deg=deg, optim_bounds=False)
    exp = jpp.fit_softmax_exp_table(-128, 127, 0.0417, backend="float",
                                    seg=seg, deg=deg)
    for table, x in ((gelu, INT8), (exp, OFFSETS)):
        b, c = table.bounds, table.coeffs.astype(np.float32)
        want = jpp.eval_piecewise_poly(jnp.asarray(x), jnp.asarray(b, jnp.float32),
                                       jnp.asarray(c))
        got = tpp.eval_piecewise_poly(torch.from_numpy(x), b, c)
        _eq(got.numpy(), want)


# --- (b) the fit -----------------------------------------------------------

FITS = [  # (kind, lo, hi, scale, keyword arguments)
    ("gelu", -1.78, 1.6, 0.014047618, dict(backend="ibert", seg=6)),
    ("gelu", -6.4, 6.35, 0.05, dict(backend="float", optim_bounds=False)),
    ("softmax", -94, 127, 0.004909, dict(backend="ibert")),
    ("softmax", 0, 127, 0.05, dict(backend="float")),       # clips to int32
    ("softmax", -18633, 127, 0.0053818, dict(backend="ibert", seg=4, deg=3)),
]


@pytest.mark.parametrize("kind,lo,hi,s,kw", FITS)
def test_fit_matches_jax(kind, lo, hi, s, kw):
    fit = {"gelu": (jpp.fit_gelu_table, tpp.fit_gelu_table),
           "softmax": (jpp.fit_softmax_exp_table, tpp.fit_softmax_exp_table)}[kind]
    want, got = fit[0](lo, hi, s, **kw), fit[1](lo, hi, s, **kw)
    _eq(got.bounds, want.bounds)
    _eq(got.coeffs, want.coeffs)
    assert got.scale_bits == want.scale_bits
    _eq(got.out_scale, want.out_scale)
    if (kind, s) == ("softmax", 0.05):
        assert np.abs(want.coeffs).max() > 2**31
        _, coeffs = tpp.fit_site("softmax", lo, hi, s, {"backend": "float"})
        assert np.abs(coeffs).max() == np.float32(2**31)


# --- the freeze --------------------------------------------------------------

@pytest.fixture(scope="module")
def frozen():
    """A 64 px ViT of depth 1, ppoly GELU and softmax (ibert backend),
    ibert LN, ``build_calibrated``'s model calibrated on the batch of its
    (jitted) init: the fitted variables and their JAX freeze."""
    model = VisionTransformer(img_size=64, patch_size=16, embed_dim=64, depth=1,
                              num_heads=2, num_classes=10, gelu_type=PPOLY,
                              softmax_type=PPOLY, layernorm_type="ibert")
    x0 = np.random.default_rng(0).normal(size=(4, 64, 64, 3)).astype(np.float32)
    variables = jax.jit(lambda a: model.init(jax.random.PRNGKey(0), a,
                                             running_stat=True))(jnp.asarray(x0))
    variables = fit_ppoly_tables(model, variables)
    return model, variables, freeze_model(model, variables)


def test_fit_site_and_gate_match_the_freeze(frozen):
    model, variables, jspec = frozen
    qs = jax.device_get(variables["quant_stats"])["blocks_0"]
    blk = jax.device_get(jspec.params)["blocks"][0]
    for kind, site, prefix in (("softmax", qs["attn"]["int_softmax"], "sm"),
                               ("gelu", qs["mlp"]["act"], "gelu")):
        x_lo, x_hi, s = (float(np.asarray(site[k])[0])
                         for k in ("x_lo", "x_hi", "in_scale"))
        which = "softmax" if kind == "softmax" else "gelu"
        bounds, coeffs = tpp.fit_site(kind, x_lo, x_hi, s,
                                      jspec.config.type_params(which))
        _eq(bounds, blk[f"{prefix}_bounds"])
        _eq(coeffs, blk[f"{prefix}_coeffs"])
        assert bounds.dtype == np.int32 and coeffs.dtype == np.float32
    args = (blk["gelu_bounds"], blk["gelu_coeffs"], 22, blk["gelu_s_out"])
    want = jfreeze._ppoly_fastdiv_gate(*args)
    got = tfreeze._ppoly_fastdiv_gate(*args)
    assert got[0] == want[0] and jspec.config.ppoly_fastdiv
    for g, w in zip(got[1:], want[1:]):
        _eq(g, w)
        assert g.dtype == np.float32
    _eq(got[1], blk["gelu_s_out_c"])
    _eq(got[2], blk["gelu_patch_h"])
    # a table whose fast form needs patches, and one that fails the gate
    s_out = np.float32(np.float32(blk["gelu_s_out"]) * np.float32(1.37))
    for n_bad in (0, 1):
        c2 = blk["gelu_coeffs"] * np.float32(1 + 16 * n_bad)
        want = jfreeze._ppoly_fastdiv_gate(blk["gelu_bounds"], c2, 22, s_out)
        got = tfreeze._ppoly_fastdiv_gate(blk["gelu_bounds"], c2, 22, s_out)
        assert got[0] == want[0]
        for g, w in zip(got[1:], want[1:]):
            _eq(g, w)
    with pytest.raises(ValueError, match="int8"):
        tfreeze._ppoly_fastdiv_gate(*args, in_bits=16)


# --- (c) the kernels' plain versions ---------------------------------------

B, NP, NV = 2, 24, 17               # padded tokens, test_torch_port_ivit.py's


def _x(seed, c):
    x = np.clip(np.round(np.random.default_rng(seed).normal(0, 32, (B, NP, c))),
                -128, 127).astype(np.int8)
    x[:, NV:] = 0
    return x


def _kw(blk, keys, as_t):
    return {k: as_t(blk[v]) for k, v in keys.items() if v in blk}


MLP_KEYS = dict(ln_bias="ln2_bias_int", m_ln="m_ln2", ln_shift="ln2_shift",
                fc1_w="fc1_w", fc1_b="fc1_b", m_fc1="m_fc1", s_gelu="s_gelu",
                m_gelu="m_gelu", fc2_w="fc2_w", fc2_b="fc2_b", m_fc2="m_fc2",
                m_res_x="m_res2_x", m_res_id="m_res2_id",
                gelu_bounds="gelu_bounds", gelu_coeffs="gelu_coeffs",
                gelu_s_out="gelu_s_out", gelu_s_out_c="gelu_s_out_c",
                gelu_patch_h="gelu_patch_h", gelu_patch_d="gelu_patch_d")
ATTN_KEYS = dict(ln_bias="ln1_bias_int", m_ln="m_ln1", ln_shift="ln1_shift",
                 qkv_w="qkv_w", qkv_b="qkv_b", m_qkv="m_qkv", m_attn="m_attn",
                 s_attn="s_attn", m_av="m_av", proj_w="proj_w",
                 proj_b="proj_b", m_proj="m_proj", m_res_x="m_res1_x",
                 m_res_id="m_res1_id", sm_bounds="sm_bounds",
                 sm_coeffs="sm_coeffs")


@pytest.mark.parametrize("fastdiv", [True, False])
def test_ppoly_block_refs_match_pallas(frozen, fastdiv):
    jspec = frozen[2]
    blk = jax.device_get(jspec.params)["blocks"][0]
    c = jspec.config.embed_dim
    valid = (np.arange(B * NP) % NP) < NV
    x = _x(0, c).reshape(B * NP, c)
    flags = dict(ln_base="ibert", gelu_base="ppoly", fast_exp=True,
                 fast_poly=True, gelu_fastdiv=fastdiv)
    want = jblk.mlp_block_p(jnp.asarray(x), s_ln=jnp.asarray(blk["s_ln2"]),
                            interpret=True, **flags,
                            **_kw(blk, MLP_KEYS, jnp.asarray))
    got = kb.mlp_block(torch.from_numpy(x), **flags,
                       **_kw(blk, MLP_KEYS, torch.as_tensor))
    _eq(got.numpy()[valid], np.asarray(want)[valid])

    x = _x(1, c)
    flags = dict(ln_base="ibert", sm_base="ppoly", fast_exp=True,
                 fast_poly=True, num_heads=jspec.config.num_heads, n_valid=NV,
                 exp_bits=16)
    want = jblk.attn_block_p(jnp.asarray(x), s_ln=jnp.asarray(blk["s_ln1"]),
                             sm_bit=8, interpret=True, **flags,
                             **_kw(blk, ATTN_KEYS, jnp.asarray))
    before = kb.attn_block.launches
    got = kb.attn_block(torch.from_numpy(x), **flags,
                        **_kw(blk, ATTN_KEYS, torch.as_tensor))
    assert kb.attn_block.launches == before          # the CPU runs no kernel
    _eq(got.numpy()[:, :NV], np.asarray(want)[:, :NV])


def test_ppoly_attn_block_ref_16bit_matches_pallas(frozen):
    """The ppoly softmax at 16-bit probabilities with an int16 output (the
    INT16 configuration's attention half) on the freeze's fitted tables:
    ``attn_block_ref`` against ``attn_block_p`` in interpret mode."""
    jspec = frozen[2]
    blk = jax.device_get(jspec.params)["blocks"][0]
    x = _x(1, jspec.config.embed_dim)
    flags = dict(ln_base="ibert", sm_base="ppoly", fast_exp=True,
                 fast_poly=True, num_heads=jspec.config.num_heads, n_valid=NV,
                 exp_bits=16, sm_bit=16, out_bits=16)
    want = jblk.attn_block_p(jnp.asarray(x), s_ln=jnp.asarray(blk["s_ln1"]),
                             out_dtype=jnp.int16, interpret=True, **flags,
                             **_kw(blk, ATTN_KEYS, jnp.asarray))
    got = kb.attn_block(torch.from_numpy(x), **flags,
                        **_kw(blk, ATTN_KEYS, torch.as_tensor))
    assert got.dtype == torch.int16
    _eq(got.numpy()[:, :NV], np.asarray(want)[:, :NV])


# --- (d) the engine on the freeze --------------------------------------------

def _jax_interpret(jspec, x, pallas):
    ppkg.FORCE_INTERPRET = True
    try:
        return np.asarray(jvit.engine_forward(jspec, jnp.asarray(x), pallas=pallas))
    finally:
        ppkg.FORCE_INTERPRET = False


@pytest.fixture(scope="module")
def jax_logits(frozen):
    """JAX ``pallas=False`` / ``True`` (interpret) / ``"ops"`` logits of the
    freeze (fast-div on, as frozen) on three images."""
    jspec = frozen[2]
    assert jspec.config.ppoly_fastdiv
    x = _images(3, 64, seed=4)
    want = {False: np.asarray(jvit.engine_forward(jspec, jnp.asarray(x),
                                                  pallas=False))}
    for path in (True, "ops"):
        want[path] = _jax_interpret(jspec, x, path)
    return x, want


@pytest.mark.parametrize("fastdiv", [True, False])
def test_ppoly_engine_paths_match_jax(frozen, jax_logits, fastdiv):
    """Port ``kernels=False`` / ``True`` / ``"ops"`` against JAX
    ``pallas=False`` / ``True`` (interpret) / ``"ops"``; ``"ops"`` runs the
    ppoly softmax and GELU unfused in both.  With fast-div off the port
    takes the rdiv form, whose values the gate proved equal (JAX's own
    ``test_ppoly_fastdiv_gate`` holds its two forms equal)."""
    jspec = frozen[2]
    spec = _to_port(jspec)
    spec = type(spec)(dataclasses.replace(spec.config, ppoly_fastdiv=fastdiv),
                      spec.params)
    x, want = jax_logits
    for path in (False, True, "ops"):
        got = engine_forward(spec, x, kernels=path, device="cpu")
        _eq(got.numpy(), want[path])
    assert np.isfinite(want[False]).all()


# --- (e) the synthetic spec's tree -------------------------------------------

def test_ppoly_synthetic_spec_has_the_freeze_tree(frozen):
    jspec = frozen[2]
    small = synthetic_spec(_to_port(jspec).config, seed=0)
    assert _tree(small.params) == _tree(jax.device_get(jspec.params))
    jc, sc = dataclasses.asdict(jspec.config), dataclasses.asdict(small.config)
    for k in ("bitwidths", "use_lut"):      # BitWidths types differ; no LUTs
        jc.pop(k), sc.pop(k)
    assert sc == jc


# --- (f) the port's fit and freeze of the same model ---------------------------

def test_port_fit_and_freeze_match_jax(frozen):
    """The port's ``fit_ppoly_tables`` over the calibrated ranges gives JAX's
    tables; its ``freeze_model`` gives the JAX freeze leaf for leaf (the
    fast-div constants and the LUTs included); and the port's sim, frozen,
    gives its engine's logits on every path, bitwise."""
    from ivit_tpu_torch.engine import Engine
    from ivit_tpu_torch.engine.freeze import freeze_model as port_freeze
    from ivit_tpu_torch.models import VisionTransformer as PortViT
    from ivit_tpu_torch.models.convert import variables_to_numpy, variables_to_torch
    from ivit_tpu_torch.models.model_utils import freeze_model as fix, unfreeze_model
    model, variables, jspec = frozen
    want = jax.device_get(variables)
    sim = PortViT(img_size=64, patch_size=16, embed_dim=64, depth=1, num_heads=2,
                  num_classes=10, gelu_type=PPOLY, softmax_type=PPOLY,
                  layernorm_type="ibert", device="cpu")
    unfreeze_model(variables_to_torch(sim, want))
    assert float(sim.blocks[0].mlp.act.fitted[0]) == 0
    with pytest.raises(ValueError, match="not fitted"):
        port_freeze(sim)
    got = variables_to_numpy(fix(sim))["quant_stats"]["blocks_0"]
    for path in (("attn", "int_softmax"), ("mlp", "act")):
        g, w = got[path[0]][path[1]], want["quant_stats"]["blocks_0"][path[0]][path[1]]
        for k in w:
            _eq(g[k], w[k])
            assert g[k].dtype == np.asarray(w[k]).dtype, k
    spec = port_freeze(sim)
    jc, sc = dataclasses.asdict(jspec.config), dataclasses.asdict(spec.config)
    assert jc.pop("bitwidths") == sc.pop("bitwidths")
    assert sc == jc
    jblk0 = jax.device_get(jspec.params)["blocks"][0]
    assert set(spec.params["blocks"][0]) == set(jblk0)
    for k, w in jblk0.items():
        _eq(spec.params["blocks"][0][k], w)
        assert spec.params["blocks"][0][k].dtype == np.asarray(w).dtype, k
    x = torch.from_numpy(_images(2, 64, seed=5))
    with torch.no_grad():
        want_logits = sim(x)
    for path in (False, True, "ops"):
        assert torch.equal(Engine(spec, device="cpu", kernels=path)(x), want_logits)
