"""Seeded synthetic engine specs at real widths (a fixture for the smoke run
and the tests).

:func:`synthetic_spec` builds the numpy parameter tree that
``ivit_tpu/engine/freeze.py::freeze_model`` emits for the ibert family --
the same keys, shapes and dtypes -- without a trained checkpoint or the QAT
sim.  It follows the freeze step's own arithmetic: int8 weights quantized
per output column from a normal draw, int32 biases on the
``w_scale * s_in`` grid, and every requant multiplier derived by
:func:`requant_multiplier` from site scales.  The site scales are chosen
from the fan-in so that every int8 requant output spreads over about 32
LSB (4 sigma at the int8 limit) and saturates rarely: a spec that is
neither dead nor saturated, so that bit-identity at full width means
something.  The LUT leaves (``sm_lut``, ``gelu_lut``) are left out, and
``use_lut`` is off: the LUT path is off by default in the JAX kernels.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..models.vit import BitWidths
from ..ops import ibert as _ib
from .freeze import (EngineConfig, EngineSpec, _exp_fast_gate,
                     _poly_fast_gate, _sym_scale, requant_const,
                     requant_multiplier)

# Nonlinearity input scales as a calibrated DeiT produces them: read off a
# JAX freeze (ivit_tpu.engine.freeze_model) of the DeiT-S geometry (224 px,
# embed 384, 6 heads, MLP 1536, ibert/ibert/ibert) with the depth cut to 2,
# calibrated with bench.py's recipe (seeded normal images, one running_stat
# pass, batch 4, numpy seed 0) on the CPU.  Block i uses entry i % 2.
CALIBRATED_S_ATTN = (0.005533343, 0.0049191364)
CALIBRATED_S_GELU = (0.013059441, 0.013524539)
# The exp QuantAct's calibrated scale is exactly exp(0) / 32767 of the
# block's s_attn (the same freeze), so it is derived, not tabled.

SIGMA = 4.0          # calibrated range in standard deviations (~32 LSB at int8)
W_STD = 0.02         # weight draw, before per-column int8 quantization
SCORE_SPREAD = 40.0  # int8 attention-score spread the qkv weights aim for
# ctx = probs @ v keeps about this fraction of v's spread at DeiT-S widths
# (measured on this spec with the plain engine; sets the m_av site)
CTX_GAIN = 0.018


def deit_small_config(depth: int = 12, img_size: int = 224,
                      ln: str = "ibert") -> EngineConfig:
    """The headline configuration (bench.py): DeiT-S, ibert everywhere,
    all bitwidths 8; ``depth`` may be cut for tests."""
    return EngineConfig(img_size=img_size, patch_size=16, embed_dim=384,
                        depth=depth, num_heads=6, mlp_ratio=4.0,
                        num_classes=1000, bitwidths=BitWidths(),
                        gelu_type="ibert", softmax_type="ibert",
                        layernorm_type=ln)


def _scale(std, bits=8):
    """Activation scale calibrated to +-SIGMA standard deviations."""
    return _sym_scale(bits, np.float32(-SIGMA * std), np.float32(SIGMA * std))


class _Sites:
    def __init__(self, rng):
        self.rng = rng

    def linear(self, fan_in, fan_out, s_in, in_std, w_std=W_STD):
        """(w_int8 [I, O], b_int32 [O], bias_scale [O], real out std), the
        freeze step's ``_linear`` on a normal draw."""
        w = self.rng.normal(0.0, w_std, (fan_in, fan_out)).astype(np.float32)
        w_scale = _sym_scale(8, w.min(axis=0), w.max(axis=0))
        w_int = np.clip(np.round(w / w_scale[None, :]), -128, 127).astype(np.int8)
        bias_scale = (w_scale.astype(np.float64)
                      * np.float64(s_in)).astype(np.float32)
        out_std = float(np.sqrt(fan_in) * in_std * w_std)
        b = self.rng.normal(0.0, 0.1 * out_std, fan_out).astype(np.float32)
        b_int = np.clip(np.round(b / bias_scale), -(2**31), 2**31 - 1)
        return w_int, b_int.astype(np.int32), bias_scale, out_std

    def layernorm(self, dim):
        """(bias_int [C], out_scale [C], shift), the freeze step's
        ``_ln_site`` on a drawn gamma/beta."""
        gamma = self.rng.uniform(0.8, 1.2, dim).astype(np.float32)
        beta = self.rng.normal(0.0, 0.1, dim).astype(np.float32)
        base = np.float32(np.sqrt(dim) / 2.0**30)
        bias_int = np.floor((beta / gamma) / base).astype(np.float32)
        return bias_int, base * gamma, np.float32(0.0)


def _ibert_gelu_out_scale(s_g):
    """The ibert GELU output scale, f32 step for step as freeze computes it."""
    sk = np.float32(np.float32(s_g) / np.float32(_ib.GELU_K))
    sig = np.float32(np.float32(np.float32(sk * sk) * np.float32(_ib.GELU_A))
                     * np.float32(2.0**_ib.GELU_N))
    return np.float32(np.float32(np.float32(s_g) * sig) / np.float32(2.0))


def synthetic_spec(config: EngineConfig, seed: int = 0) -> EngineSpec:
    """A seeded ibert engine spec for ``config`` (numpy parameter tree)."""
    for which in ("softmax", "gelu", "ln"):
        if config.base_type(which) != "ibert":
            raise NotImplementedError(
                "synthetic specs cover the ibert family of this slice")
    cfg, bw = config, config.bitwidths
    C, H = cfg.embed_dim, cfg.num_heads
    hidden = int(C * cfg.mlp_ratio)
    n_tok = cfg.num_patches + 1
    site = _Sites(np.random.default_rng(seed))
    p = {}

    s_input = _scale(1.0)                      # images ~ N(0, 1)
    p["s_input"] = s_input
    k = cfg.patch_size * cfg.patch_size * 3
    w, b, s_conv, patch_std = site.linear(k, C, s_input, 1.0)
    s_patch = _scale(patch_std, bw.patch_embed)
    p["patch"] = {"w": w, "b": b, "m": requant_multiplier(s_conv, s_patch)}
    p["s_patch"] = s_patch
    cls = site.rng.normal(0.0, patch_std, (1, 1, C)).astype(np.float32)
    p["cls_int"] = np.round(cls / s_patch)
    pos_std = patch_std / 2
    s_pos = _scale(pos_std, bw.pos_encoding)
    pos = site.rng.normal(0.0, pos_std, (1, n_tok, C)).astype(np.float32)
    n_pos = 2 ** (bw.pos_encoding - 1) - 1
    pos_int = np.clip(np.round(pos / s_pos), -n_pos - 1, n_pos)
    x_std = float(np.hypot(patch_std, pos_std))
    s_block_in = _scale(x_std, bw.block_input)
    p["pos_addend"] = requant_const(pos_int, s_pos, s_block_in).astype(np.float32)
    p["m_x0"] = requant_multiplier(s_patch, s_block_in)
    p["s_block0"] = s_block_in

    fast_exp = fast_poly = True
    blocks = []
    for i in range(cfg.depth):
        s_attn = np.float32(CALIBRATED_S_ATTN[i % 2])
        s_g = np.float32(CALIBRATED_S_GELU[i % 2])
        blk = {}
        ln_b, ln_s, ln_sh = site.layernorm(C)
        s_a1 = _scale(1.0)
        blk.update(ln1_bias_int=ln_b, ln1_shift=ln_sh, s_ln1=ln_s,
                   m_ln1=requant_multiplier(ln_s, s_a1))
        # qkv weights sized so the scores spread SCORE_SPREAD LSB at s_attn
        q_std = float(np.sqrt(SCORE_SPREAD * s_attn))
        w, b, s_qkv, q_std = site.linear(C, 3 * C, s_a1, 1.0,
                                         w_std=q_std / np.sqrt(C))
        s_q = _scale(q_std)
        blk.update(qkv_w=w, qkv_b=b, m_qkv=requant_multiplier(s_qkv, s_q))
        s_scores = np.float32(np.float32(s_q * s_q) * np.float32(cfg.attn_scale))
        blk["m_attn"] = requant_multiplier(s_scores, s_attn)
        blk["s_attn"] = s_attn
        c_int = np.floor(np.float32(_ib.EXP_C) / np.float32(s_attn * s_attn))
        blk["s_exp_act"] = _sym_scale(16, np.float32(0.0),
                                      np.float32(c_int * 2.0**30))
        s_sm = np.float32(2.0 / 2**bw.softmax)
        ctx_std = CTX_GAIN * q_std
        s_a2 = _scale(ctx_std)
        blk["m_av"] = requant_multiplier(np.float32(s_sm * s_q), s_a2)
        w, b, s_pj, proj_std = site.linear(C, C, s_a2, ctx_std)
        s_a3 = _scale(proj_std, bw.attention_out)
        blk.update(proj_w=w, proj_b=b, m_proj=requant_multiplier(s_pj, s_a3))
        res1_std = float(np.hypot(proj_std, x_std))
        s_res1 = _scale(res1_std, bw.norm2_in)
        blk["m_res1_x"] = requant_multiplier(s_a3, s_res1)
        blk["m_res1_id"] = requant_multiplier(s_block_in, s_res1)

        ln_b, ln_s, ln_sh = site.layernorm(C)
        s_m1 = _scale(1.0)
        blk.update(ln2_bias_int=ln_b, ln2_shift=ln_sh, s_ln2=ln_s,
                   m_ln2=requant_multiplier(ln_s, s_m1))
        # fc1 weights sized so the GELU input spreads ~32 LSB at s_gelu
        h_std = float(s_g) * 127.0 / SIGMA
        w, b, s_fc1, h_std = site.linear(C, hidden, s_m1, 1.0,
                                         w_std=h_std / np.sqrt(C))
        blk.update(fc1_w=w, fc1_b=b, m_fc1=requant_multiplier(s_fc1, s_g),
                   s_gelu=s_g)
        g_std = 0.6 * h_std                    # GELU keeps ~60% of the spread
        s_m2 = _scale(g_std)
        blk["m_gelu"] = requant_multiplier(_ibert_gelu_out_scale(s_g), s_m2)
        w, b, s_fc2, mlp_std = site.linear(hidden, C, s_m2, g_std)
        s_mlp = _scale(mlp_std, bw.mlp_out)
        blk.update(fc2_w=w, fc2_b=b, m_fc2=requant_multiplier(s_fc2, s_mlp))
        x_std = float(np.hypot(mlp_std, res1_std))
        s_block_out = _scale(x_std, bw.att_block_out)
        blk["m_res2_x"] = requant_multiplier(s_mlp, s_block_out)
        blk["m_res2_id"] = requant_multiplier(s_res1, s_block_out)

        fast_exp = fast_exp and _exp_fast_gate("ibert", "ibert", s_attn, s_g)
        fast_poly = fast_poly and _poly_fast_gate("ibert", "ibert", s_attn, s_g)
        blocks.append(blk)
        s_block_in = s_block_out
    p["blocks"] = blocks

    ln_b, ln_s, ln_sh = site.layernorm(C)
    s_cls = _scale(1.0)
    p.update(lnf_bias_int=ln_b, lnf_shift=ln_sh, s_lnf=ln_s,
             m_lnf=requant_multiplier(ln_s, s_cls))
    w, b, s_head, _ = site.linear(C, cfg.num_classes, s_cls, 1.0)
    p.update(head_w=w, head_b=b, head_scale=s_head)
    cfg = dataclasses.replace(cfg, fast_exp=fast_exp, fast_poly=fast_poly,
                              use_lut=False, sm_sum_i32=True,
                              ppoly_fastdiv=True)
    return EngineSpec(config=cfg, params=_f32_tree(p))


def _f32_tree(tree):
    """int8/int32 leaves as they are, every other leaf as an f32 array (the
    freeze step's ``_to_device`` dtype rule)."""
    if isinstance(tree, dict):
        return {k: _f32_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_f32_tree(v) for v in tree]
    arr = np.asarray(tree)
    if arr.dtype in (np.int8, np.int32):
        return arr
    return arr.astype(np.float32)
