"""The port's Swin kernels' plain versions, at the test geometry and at
Swin-T width, bit-exact against the JAX package (tolerance 0).

* the Swin geometry helpers (relative-position index, shift mask, window
  partition and reverse);
* the plain version of the window-attention kernel against JAX
  ``swin_attn_block_p`` in interpret mode: shifted and unshifted blocks,
  int16 and int8 (a merge's output) input, ivit, ibert and the two mixes of
  ``tests/test_pallas.py``, the hoisted ``ln_in``, an ibert LN shift > 0;
* the Swin form of the MLP kernel's plain version (int16 in and out)
  against JAX ``mlp_block_p``, and at C 96 unpadded against JAX padded to
  128 lanes with ``c_valid=96``;
* Swin-T width (224 px, embed 96, heads (3, 6, 12, 24); depths cut to
  (2, 2, 2, 2)): the synthetic spec through JAX's unfused engine and both
  port paths;
* float Swin specs, the ppoly LayerNorm, and ``kernels="ops"``, raise.

The engine on real JAX freezes, the artifacts and the synthetic spec's
tree are in ``tests/test_torch_port_swin_engine.py``; the ppoly family in
``tests/test_torch_port_swin_ppoly.py``.
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
from test_torch_port_engine import _images  # noqa: E402

from ivit_tpu.engine import swin_int as jswin  # noqa: E402
from ivit_tpu.models import BitWidths as JaxBitWidths  # noqa: E402
from ivit_tpu.models import swin as jgeo  # noqa: E402
from ivit_tpu.ops.pallas import block as jblk  # noqa: E402
from ivit_tpu_torch.engine import (Engine, SwinEngineConfig, SwinEngineSpec,  # noqa: E402
                                   swin_engine_forward)
from ivit_tpu_torch.engine.convert import params_to_torch  # noqa: E402
from ivit_tpu_torch.engine.synthetic import (swin_tiny_config,  # noqa: E402
                                              synthetic_swin_spec)
from ivit_tpu_torch.models import BitWidths  # noqa: E402
from ivit_tpu_torch.models import swin as tgeo  # noqa: E402
from ivit_tpu_torch.ops.kernels import block as kb  # noqa: E402

IVIT = ("ivit", "ivit", "ivit")                     # (gelu, softmax, ln)
IBERT = ("ibert", "ibert", "ibert")
# ivit, ibert and the two mixes of test_pallas.py's block-kernel test
MIXES = [IVIT, IBERT, ("ivit", "ivit", "ibert"), ("ibert", "ibert", "ivit")]
MIX_IDS = ["/".join(m) for m in MIXES]
SMALL = dict(depths=(2, 2), img_size=56, embed_dim=32, stage_heads=(2, 4),
             num_classes=10)                        # test_swin_engine.py's


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _to_port(jspec):
    d = dataclasses.asdict(jspec.config)
    d["bitwidths"] = BitWidths(*jspec.config.bitwidths.to_list())
    return SwinEngineSpec(SwinEngineConfig(**d),
                          params_to_torch(jax.device_get(jspec.params), "cpu"))


def _to_jax(spec):
    d = dataclasses.asdict(spec.config)
    d["bitwidths"] = JaxBitWidths(*spec.config.bitwidths.to_list())
    return jswin.SwinEngineSpec(jswin.SwinEngineConfig(**d),
                                jax.tree.map(jnp.asarray, spec.params))


def _small_spec(mix, **kw):
    gelu, softmax, ln = mix
    return synthetic_swin_spec(swin_tiny_config(
        gelu=gelu, softmax=softmax, ln=ln, **(SMALL | kw)), seed=3)


def _stream(shape, bits, seed):
    lim = 2 ** (bits - 1)
    x = np.clip(np.round(np.random.default_rng(seed).normal(0, lim / 4, shape)),
                -lim, lim - 1)
    return x.astype(np.int16 if bits > 8 else np.int8)


# --- (a) geometry ---------------------------------------------------------------

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


@pytest.mark.parametrize("res", [14, 56])
def test_swin_geometry_matches_jax(res):
    _eq(tgeo.relative_position_index(7), jgeo.relative_position_index(7))
    _eq(tgeo.attention_mask((res, res), 7, 3), jgeo.attention_mask((res, res), 7, 3))
    x = _stream((2, res, res, 8), 16, seed=res)
    wins = tgeo.window_partition(torch.from_numpy(x), 7)
    _eq(wins.numpy(), jgeo.window_partition(jnp.asarray(x), 7))
    _eq(tgeo.window_reverse(wins, 7, res, res).numpy(), x)


# --- (b) the window-attention kernel's plain version ---------------------------

def _attn_kw(blk, mix, fast, heads, n_windows, shift, as_t):
    keys = dict(ln_bias="ln1_bias_int", m_ln="m_ln1", ln_shift="ln1_shift",
                qkv_w="qkv_w", qkv_b="qkv_b", m_qkv="m_qkv", m_attn="m_attn",
                m_attn2="m_attn2", s_attn="s_attn", rel_addend="rel_bias_addend",
                m_av="m_av", proj_w="proj_w", proj_b="proj_b", m_proj="m_proj",
                m_res_x="m_res1_x", m_res_id="m_res1_id")
    kw = {k: as_t(blk[v]) for k, v in keys.items()}
    kw["mask_addend"] = as_t(blk["mask_int"]) if shift else None
    kw["s_exp_act"] = as_t(blk["s_exp_act"]) if "s_exp_act" in blk else None
    kw.update(num_heads=heads, n_windows=n_windows, ln_base=mix[2],
              sm_base=mix[1], fast_exp=fast, fast_poly=fast)
    return kw


def _jax_ln_in(spec, x, blk):
    """JAX's hoisted LN of the window stream (``swin_int._hoisted_ln8``)."""
    cfg = _to_jax(spec).config
    return np.asarray(jswin._hoisted_ln8(cfg, jnp.asarray(x), blk["ln1_bias_int"],
                                         blk["ln1_shift"], blk["s_ln1"],
                                         blk["m_ln1"]))


def _check_attn_ref(blk, mix, heads, nw, shift, x, ln_in=None):
    for fast in (False, True):
        want = jblk.swin_attn_block_p(
            jnp.asarray(x), s_ln=jnp.asarray(blk["s_ln1"]), interpret=True,
            ln_in=None if ln_in is None else jnp.asarray(ln_in),
            **_attn_kw(blk, mix, fast, heads, nw, shift, jnp.asarray))
        before = kb.swin_attn_block.launches
        got = kb.swin_attn_block(
            torch.from_numpy(x),
            ln_in=None if ln_in is None else torch.from_numpy(ln_in),
            **_attn_kw(blk, mix, fast, heads, nw, shift, torch.as_tensor))
        assert kb.swin_attn_block.launches == before     # the CPU runs no kernel
        assert got.dtype == torch.int16
        _eq(got.numpy(), want)


@pytest.mark.parametrize("mix", MIXES, ids=MIX_IDS)
def test_swin_attn_ref_matches_pallas(mix):
    """Stage 0's shifted block on the int16 stream (4 windows an image),
    stage 1's first block on a merge's int8 output (res = ws, 1 window)."""
    spec = _small_spec(mix)
    blocks = [b for b in spec.params["blocks"] if "merge" not in b]
    _check_attn_ref(blocks[1], mix, 2, 4, 3, _stream((8, 49, 32), 16, seed=0))
    _check_attn_ref(blocks[2], mix, 4, 1, 0, _stream((2, 49, 64), 8, seed=1))


@pytest.mark.parametrize("mix", [IVIT, IBERT], ids=["ivit", "ibert"])
def test_swin_attn_ref_hoisted_ln_matches_pallas(mix):
    spec = _small_spec(mix)
    blk = spec.params["blocks"][0]
    x = _stream((8, 49, 32), 16, seed=2)
    _check_attn_ref(blk, mix, 2, 4, 0, x, ln_in=_jax_ln_in(spec, x, blk))


@pytest.mark.parametrize("shift", [1.0, 2.0])
def test_swin_attn_ref_ibert_ln_shift_matches_pallas(shift):
    """The ibert LN with the overflow shift that calibration gives the
    16-bit stream (the synthetic spec's C = 32 needs none)."""
    blk = dict(_small_spec(IBERT).params["blocks"][1])
    blk["ln1_shift"] = np.float32(shift)
    _check_attn_ref(blk, IBERT, 2, 4, 3, _stream((8, 49, 32), 16, seed=3))


# --- (c) the MLP kernel's plain version, Swin form -------------------------------

def _mlp_kw(blk, mix, fast, as_t):
    keys = dict(ln_bias="ln2_bias_int", m_ln="m_ln2", ln_shift="ln2_shift",
                fc1_w="fc1_w", fc1_b="fc1_b", m_fc1="m_fc1", s_gelu="s_gelu",
                m_gelu="m_gelu", fc2_w="fc2_w", fc2_b="fc2_b", m_fc2="m_fc2",
                m_res_x="m_res2_x", m_res_id="m_res2_id")
    kw = {k: as_t(blk[v]) for k, v in keys.items()}
    kw.update(ln_base=mix[2], gelu_base=mix[0], fast_exp=fast, fast_poly=fast,
              mlp_bits=8, out_bits=16)
    return kw


@pytest.mark.parametrize("mix", [IVIT, IBERT], ids=["ivit", "ibert"])
def test_swin_mlp_ref_matches_pallas(mix):
    blk = dict(_small_spec(mix).params["blocks"][1])
    blk["ln2_shift"] = np.float32(1.0 if mix == IBERT else 0.0)
    x = _stream((98, 32), 16, seed=4)
    for fast in (False, True):
        want = jblk.mlp_block_p(jnp.asarray(x), s_ln=jnp.asarray(blk["s_ln2"]),
                                out_dtype=jnp.int16, interpret=True,
                                **_mlp_kw(blk, mix, fast, jnp.asarray))
        got = kb.mlp_block(torch.from_numpy(x), **_mlp_kw(blk, mix, fast, torch.as_tensor))
        assert got.dtype == torch.int16
        _eq(got.numpy(), want)


def test_swin_mlp_ref_unpadded_matches_pallas_c_valid():
    """C = 96 as the port runs it against the JAX kernel on C zero-padded to
    the 128-lane grid with ``c_valid=96``, sliced back
    (``swin_int.py:595-652``)."""
    spec = _small_spec(IVIT, depths=(1,), img_size=28, embed_dim=96,
                       stage_heads=(3,))
    blk = spec.params["blocks"][0]
    x = _stream((98, 96), 16, seed=5)
    pad = 32

    def pc(a):
        return jnp.pad(jnp.asarray(a), (0, pad))

    kw = _mlp_kw(blk, IVIT, True, jnp.asarray)
    kw.update(ln_bias=pc(blk["ln2_bias_int"]), m_ln=pc(blk["m_ln2"]),
              fc1_w=jnp.pad(jnp.asarray(blk["fc1_w"]), ((0, pad), (0, 0))),
              fc2_w=jnp.pad(jnp.asarray(blk["fc2_w"]), ((0, 0), (0, pad))),
              fc2_b=pc(blk["fc2_b"]), m_fc2=pc(blk["m_fc2"]))
    want = jblk.mlp_block_p(jnp.pad(jnp.asarray(x), ((0, 0), (0, pad))),
                            s_ln=pc(blk["s_ln2"]), out_dtype=jnp.int16,
                            c_valid=96, interpret=True, **kw)
    got = kb.mlp_block(torch.from_numpy(x), **_mlp_kw(blk, IVIT, True, torch.as_tensor))
    _eq(got.numpy(), np.asarray(want)[:, :96])


# --- (g) Swin-T width -----------------------------------------------------------

def test_swin_tiny_width_synthetic_matches_jax():
    """224 px, embed 96, heads (3, 6, 12, 24), window 7 at full width; the
    depths cut to (2, 2, 2, 2), which keeps a shifted block in stages 0-2.
    JAX's forward is jitted: eager dispatch of this graph takes a minute."""
    spec = synthetic_swin_spec(swin_tiny_config(depths=(2, 2, 2, 2)), seed=0)
    x = _images(2, 224, seed=7)
    jspec = _to_jax(spec)
    want = np.asarray(jax.jit(lambda p, a: jswin.swin_engine_forward(
        jswin.SwinEngineSpec(jspec.config, p), a, pallas=False))(
            jspec.params, jnp.asarray(x)))
    for kernels in (False, True):
        _eq(swin_engine_forward(spec, x, kernels=kernels, device="cpu").numpy(), want)
    assert np.isfinite(want).all() and want.std(axis=0).max() > 0
    shifts = {stage for kind, stage, shift in spec.config.layout if shift}
    assert shifts == {0, 1, 2}


# --- (h) what is not ported raises ----------------------------------------------

@pytest.mark.parametrize("which", ["gelu_type", "softmax_type", "layernorm_type"])
def test_swin_engine_refuses_families_not_ported(which):
    spec = _small_spec(IVIT, depths=(1,), img_size=28, stage_heads=(2,))
    x = np.zeros((1, 28, 28, 3), np.float32)
    # every softmax and GELU family runs (float: tests/test_torch_port_float.py);
    # the LayerNorm is ivit or ibert, as in JAX's engine
    refused = [("sigmoid", "unknown family")]
    if which == "layernorm_type":
        refused += [("float", "no float LayerNorm"), ("ppoly", "no LayerNorm")]
    else:
        Engine(dataclasses.replace(spec, config=dataclasses.replace(
            spec.config, **{which: "float"})), device="cpu")
    for fam, item in refused:
        bad = dataclasses.replace(spec, config=dataclasses.replace(
            spec.config, **{which: fam}))
        with pytest.raises(NotImplementedError, match=item):
            Engine(bad, device="cpu")
        with pytest.raises(NotImplementedError, match=item):
            swin_engine_forward(bad, x, device="cpu")
    for kernels in ("ops", "fused"):
        with pytest.raises(ValueError, match="kernels="):
            Engine(spec, device="cpu", kernels=kernels)
        with pytest.raises(ValueError, match="kernels="):
            swin_engine_forward(spec, x, kernels=kernels, device="cpu")
    with pytest.raises(ValueError, match="stage_paths"):
        Engine(spec, device="cpu", stage_paths=(True, True))
