"""The block kernels' plain versions bit-exact against the JAX Pallas
kernels (interpret mode).  The CUDA kernels are held against these plain
versions on a card by ``test_torch_port_cuda.py``.

Shapes: B 2, Np 24 of which n_valid 17 real tokens (the padded layout of
the JAX fused path, padding rows zero as ``jnp.pad`` leaves them), C 64,
2 heads, MLP 256, random int8 weights from a seeded synthetic spec.  Only
valid rows are compared: padding rows are undefined by design.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivit_tpu.ops.pallas import block as jblk
from ivit_tpu_torch.engine import vit_int as tvit
from ivit_tpu_torch.engine.synthetic import deit_small_config, synthetic_spec
from ivit_tpu_torch.ops.kernels import block as kb

B, NP, NV, C, HEADS = 2, 24, 17, 64, 2
FLAGS = [(False, False), (True, True), (True, False)]


@pytest.fixture(scope="module")
def blk():
    cfg = dataclasses.replace(deit_small_config(depth=1, img_size=64),
                              embed_dim=C, num_heads=HEADS, num_classes=10)
    return synthetic_spec(cfg, seed=3).params["blocks"][0]


def _x(seed):
    x = np.clip(np.round(np.random.default_rng(seed).normal(0, 32, (B, NP, C))),
                -128, 127).astype(np.int8)
    x[:, NV:] = 0
    return x


def _mlp_kw(b, fast_poly, as_t):
    keys = dict(ln_bias="ln2_bias_int", m_ln="m_ln2", ln_shift="ln2_shift",
                fc1_w="fc1_w", fc1_b="fc1_b", m_fc1="m_fc1", s_gelu="s_gelu",
                m_gelu="m_gelu", fc2_w="fc2_w", fc2_b="fc2_b", m_fc2="m_fc2",
                m_res_x="m_res2_x", m_res_id="m_res2_id")
    kw = {k: as_t(b[v]) for k, v in keys.items()}
    kw["fast_poly"] = fast_poly
    return kw


def _attn_kw(b, fast_exp, fast_poly, as_t):
    keys = dict(ln_bias="ln1_bias_int", m_ln="m_ln1", ln_shift="ln1_shift",
                qkv_w="qkv_w", qkv_b="qkv_b", m_qkv="m_qkv", m_attn="m_attn",
                s_attn="s_attn", s_exp_act="s_exp_act", m_av="m_av",
                proj_w="proj_w", proj_b="proj_b", m_proj="m_proj",
                m_res_x="m_res1_x", m_res_id="m_res1_id")
    kw = {k: as_t(b[v]) for k, v in keys.items()}
    kw.update(num_heads=HEADS, n_valid=NV, fast_exp=fast_exp,
              fast_poly=fast_poly)
    return kw


@pytest.mark.parametrize("fast_exp,fast_poly", FLAGS)
def test_mlp_block_matches_pallas(blk, fast_exp, fast_poly):
    x = _x(0).reshape(B * NP, C)
    want = jblk.mlp_block_p(jnp.asarray(x), s_ln=jnp.asarray(blk["s_ln2"]),
                            ln_base="ibert", gelu_base="ibert",
                            fast_exp=fast_exp, interpret=True,
                            **_mlp_kw(blk, fast_poly, jnp.asarray))
    before = kb.mlp_block.launches
    got = kb.mlp_block(torch.from_numpy(x), **_mlp_kw(blk, fast_poly,
                                                      torch.as_tensor))
    assert kb.mlp_block.launches == before        # the CPU runs no kernel
    valid = (np.arange(B * NP) % NP) < NV
    np.testing.assert_array_equal(got.numpy()[valid], np.asarray(want)[valid])


@pytest.mark.parametrize("fast_exp,fast_poly", FLAGS)
def test_attn_block_matches_pallas(blk, fast_exp, fast_poly):
    x = _x(1)
    want = jblk.attn_block_p(jnp.asarray(x), s_ln=jnp.asarray(blk["s_ln1"]),
                             ln_base="ibert", sm_base="ibert", sm_bit=8,
                             interpret=True,
                             **_attn_kw(blk, fast_exp, fast_poly, jnp.asarray))
    before = kb.attn_block.launches
    got = kb.attn_block(torch.from_numpy(x),
                        **_attn_kw(blk, fast_exp, fast_poly, torch.as_tensor))
    assert kb.attn_block.launches == before
    np.testing.assert_array_equal(got.numpy()[:, :NV], np.asarray(want)[:, :NV])


def test_wrappers_refuse_what_the_kernels_do_not_run(blk):
    """The float family and the float and ppoly LNs raise; the integer-sqrt
    ibert LN, which the wrappers refused before the kernels took it, runs."""
    x = torch.from_numpy(_x(0).reshape(B * NP, C))
    kw = _mlp_kw(blk, True, torch.as_tensor)
    with pytest.raises(NotImplementedError, match="no fused block kernel"):
        kb.mlp_block(x, gelu_base="float", **kw)
    for ln_base in ("float", "ppoly"):
        with pytest.raises(NotImplementedError, match="ivit or ibert LayerNorm"):
            kb.attn_block(torch.from_numpy(_x(1)), ln_base=ln_base,
                          **_attn_kw(blk, True, True, torch.as_tensor))
    # the integer-sqrt ibert LN runs, as the unfused engine runs it
    cfg = dataclasses.replace(deit_small_config(depth=1, img_size=64,
                                                ln="ibert_use-int-sqrt_true"),
                              embed_dim=C, num_heads=HEADS, num_classes=10)
    tb = {k: torch.as_tensor(v) for k, v in blk.items()}
    want = tvit._mlp_unfused(cfg, tb, x.reshape(B, NP, C), False).reshape(B * NP, C)
    got = kb.mlp_block(x, use_int_sqrt=True, **kw)
    valid = (np.arange(B * NP) % NP) < NV
    np.testing.assert_array_equal(got.numpy()[valid], want.numpy()[valid])
