"""Seeded synthetic engine specs at real widths (a fixture for the smoke run
and the tests).

:func:`synthetic_spec` builds the numpy parameter tree that
``ivit_tpu/engine/freeze.py::freeze_model`` emits for the ivit, ibert, ppoly
and float softmax and GELU, in any mix and at any bitwidth vector (the
reference's INT16 configuration ``8,8,8,8,16,8,16,8`` included) -- the same
keys, shapes and dtypes -- without a
trained checkpoint or the QAT sim; :func:`synthetic_swin_spec` does the
same for ``ivit_tpu/engine/swin_int.py::freeze_swin_model``.  The ppoly
softmax and GELU take tables fitted by the port's own fit
(``ops/ppoly.py``) over calibrated ranges, as ``fit_ppoly_tables`` fits
them before a freeze.  It follows the freeze step's own
arithmetic: int8 weights quantized per output column from a normal draw,
int32 biases on the ``w_scale * s_in`` grid, and every requant multiplier
derived by
:func:`requant_multiplier` from site scales.  The site scales are chosen
from the fan-in so that every int8 requant output spreads over about 32
LSB (4 sigma at the int8 limit) and saturates rarely: a spec that is
neither dead nor saturated, so that bit-identity at full width means
something.  The LUT leaves (``sm_lut``, ``gelu_lut``) are left out, and
``use_lut`` is off: the LUT path is off by default in the JAX kernels;
:func:`with_tables` adds them as a freeze writes them.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from ..models.swin import attention_mask, relative_position_index
from ..models.vit import BitWidths
from ..ops import ibert as _ib
from ..ops.ppoly import fit_site
from . import luts
from .freeze import (GELU_IN_BITS, EngineConfig, EngineSpec, _block_luts, _exp_fast_gate,
                     _gelu_out_scale, _poly_fast_gate, _ppoly_fastdiv_gate,
                     _quant_w, _sym_scale, requant_const, requant_multiplier,
                     spec_tree)
from .swin_int import SwinEngineConfig, SwinEngineSpec
from .vit_int import _check_families

# Nonlinearity input scales as a calibrated DeiT produces them: read off a
# JAX freeze (ivit_tpu.engine.freeze_model) of the DeiT-S geometry (224 px,
# embed 384, 6 heads, MLP 1536, ibert/ibert/ibert) with the depth cut to 2,
# calibrated with bench.py's recipe (seeded normal images, one running_stat
# pass, batch 4, numpy seed 0) on the CPU.  Block i uses entry i % 2.
CALIBRATED_S_ATTN = (0.005533343, 0.0049191364)
CALIBRATED_S_GELU = (0.013059441, 0.013524539)
# The exp QuantAct's calibrated scale is exactly exp(0) / 32767 of the
# block's s_attn (the same freeze), so it is derived, not tabled.
# The ivit family's GELU scales: the same geometry, gelu/softmax/layernorm
# "ivit", built as the deit_small_patch16_224 factory builds it (qkv_bias)
# with depth=2, initialized and calibrated (one running_stat pass) on one
# batch of 4 normal images drawn from numpy's default_rng(0), frozen on the
# CPU.
CALIBRATED_S_GELU_IVIT = (0.014047618, 0.014301606)
# Its softmax scales are not that freeze's (0.0045778966, 0.0048980233):
# a random-init model's attention is flat, its int8 scores span +-0.6, and
# Shiftmax's linear exp then floors every probability of a 197-token row
# to 0, so attention passes nothing and the logits do not depend on the
# image.  The ivit spec takes the scales of the JAX package's Shiftmax
# tests (tests/test_pallas.py), where the int8 range spans +-6.6 and +-7.7
# as a trained model's peaked attention does.  A mixed spec takes the
# softmax scale of its softmax family and the GELU scale of its GELU family.
S_ATTN_IVIT = (0.0521371, 0.061)
# The ppoly family's sites, (scale, calibrated min, max) a block: the GELU's
# real input range at s_gelu read off a JAX freeze of the same DeiT-S
# geometry with depth 2, gelu and softmax "ppoly_backend_ibert" and the
# ibert LN (bench_matrix.py's deit_small_ppoly), calibrated with the same
# recipe (one running_stat pass, batch 4, numpy seed 0) and fitted by
# fit_ppoly_tables.  That freeze's softmax sites (s_attn 0.004909 and
# 0.0048266, offsets x - max + 127 down to -94 and -90) leave a random-init
# model's attention flat: every 8-bit probability of a 197-key row floors
# to 0, as with Shiftmax, and the logits do not depend on the image.  The
# softmax sites take S_ATTN_IVIT's scales over the whole int8 offset
# domain [-128, 127] instead, as the JAX ppoly tests fit the exp
# (tests/test_ppoly.py, s 0.05 over [-128, 127]); at these scales the fit
# clips a coefficient to int32.
PPOLY_SOFTMAX = ((S_ATTN_IVIT[0], -128.0, 127.0), (S_ATTN_IVIT[1], -128.0, 127.0))
PPOLY_GELU = ((0.014047618, -1.7840475, 1.6014285),
              (0.014350488, -1.8225119, 1.6359556))
# The float family (jax.nn.softmax / gelu on the dequantized input): the
# GELU takes the calibrated ibert GELU scales of the same geometry; the
# softmax takes S_ATTN_IVIT, where the attention of a 197-key row is peaked
# enough that its 8-bit probabilities do not all floor to 0.
S_ATTN_TABLE = {"ivit": S_ATTN_IVIT, "ibert": CALIBRATED_S_ATTN,
                "ppoly": tuple(t[0] for t in PPOLY_SOFTMAX), "float": S_ATTN_IVIT}
S_GELU_TABLE = {"ivit": CALIBRATED_S_GELU_IVIT, "ibert": CALIBRATED_S_GELU,
                "ppoly": tuple(t[0] for t in PPOLY_GELU), "float": CALIBRATED_S_GELU}

SIGMA = 4.0          # calibrated range in standard deviations (~32 LSB at int8)
W_STD = 0.02         # weight draw, before per-column int8 quantization
SCORE_SPREAD = 40.0  # int8 attention-score spread the qkv weights aim for
# ctx = probs @ v keeps about this fraction of v's spread at DeiT-S widths
# (measured on this spec's first block with the plain engine, so that the
# int8 ctx spreads about 32 LSB; sets the m_av site), by softmax family and
# probability bits: the ibert spec's flat attention keeps little of it at 8
# bits, where most of a row's probabilities floor to 0, and ten times more
# at 16; the peaked attention of the other specs' scales keeps more
CTX_GAIN = {("ibert", 8): 0.018, ("ivit", 8): 0.3, ("ppoly", 8): 0.21,
            ("float", 8): 0.3, ("ibert", 16): 0.19, ("ivit", 16): 0.33,
            ("ppoly", 16): 0.26, ("float", 16): 0.35}


def deit_small_config(depth: int = 12, img_size: int = 224,
                      ln: str = "ibert", gelu: str = "ibert",
                      softmax: str = "ibert", bitwidths="8") -> EngineConfig:
    """DeiT-S, all bitwidths 8 by default: ibert everywhere is the headline
    configuration (bench.py), ivit everywhere the compile entry's
    (``__graft_entry__.py``); ``bitwidths`` takes a ``BitWidths`` or its
    spec string, ``"8,8,8,8,16,8,16,8"`` the reference's INT16 run
    (softmax and norm2_in 16); ``depth`` may be cut for tests."""
    return EngineConfig(img_size=img_size, patch_size=16, embed_dim=384,
                        depth=depth, num_heads=6, mlp_ratio=4.0,
                        num_classes=1000,
                        bitwidths=BitWidths.from_spec(bitwidths),
                        gelu_type=gelu, softmax_type=softmax,
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
        w_int = _quant_w(w, 8, w_scale[None, :]).astype(np.int8)
        bias_scale = (w_scale.astype(np.float64)
                      * np.float64(s_in)).astype(np.float32)
        out_std = float(np.sqrt(fan_in) * in_std * w_std)
        b = self.rng.normal(0.0, 0.1 * out_std, fan_out).astype(np.float32)
        b_int = _quant_w(b, 32, bias_scale)
        return w_int, b_int.astype(np.int32), bias_scale, out_std

    def layernorm(self, dim, shift=0.0):
        """(bias_int [C], out_scale [C], shift), the freeze step's
        ``_ln_site`` on a drawn gamma/beta."""
        gamma = self.rng.uniform(0.8, 1.2, dim).astype(np.float32)
        beta = self.rng.normal(0.0, 0.1, dim).astype(np.float32)
        base = np.float32(np.sqrt(dim) / 2.0**30)
        bias_int = np.floor((beta / gamma) / base).astype(np.float32)
        return bias_int, base * gamma, np.float32(shift)


def _ivit_sum_fits_int32(s_attn, n_tok):
    """May the Shiftmax row sum run as one int32 reduction?  The freeze
    step's gate on the block's exp table."""
    return luts.sum_fits_int32(luts.shiftmax_exp_lut(s_attn), n_tok)


@functools.lru_cache(maxsize=None)
def _fitted(kind, x_lo, x_hi, scale, type_params):
    return fit_site(kind, x_lo, x_hi, np.float32(scale), dict(type_params))


def _ppoly_site(config, kind, scale, x_lo, x_hi):
    """(bounds, coeffs) of one ppoly site, fitted once for each distinct
    (kind, range, scale, parameters) in a process: a GELU fit searches its
    segment bounds for seconds."""
    params = tuple(sorted(config.type_params(kind).items()))
    bounds, coeffs = _fitted(kind, float(x_lo), float(x_hi), float(scale), params)
    return bounds.copy(), coeffs.copy()


def _ppoly_gelu_leaves(config, blk, s_g, s_gelu_out, gelu_range):
    """A block's ppoly GELU leaves, as the freeze writes them: the fitted
    table, its output grid and the fast-div gate's constants; returns
    whether the gate passed."""
    blk["gelu_bounds"], blk["gelu_coeffs"] = _ppoly_site(config, "gelu", s_g,
                                                         *gelu_range)
    blk["gelu_s_out"] = np.float32(s_gelu_out)
    ok, c, ph, pd = _ppoly_fastdiv_gate(
        blk["gelu_bounds"], blk["gelu_coeffs"],
        int(config.type_params("gelu").get("scale_bits", 22)), s_gelu_out,
        in_bits=GELU_IN_BITS)
    blk.update(gelu_s_out_c=c, gelu_patch_h=ph, gelu_patch_d=pd)
    return ok


def synthetic_spec(config: EngineConfig, seed: int = 0) -> EngineSpec:
    """A seeded engine spec for ``config`` (numpy parameter tree), any mix
    of the ivit, ibert, ppoly and float softmax and GELU with the ivit or
    ibert LayerNorm, at the config's bitwidths: the softmax's scale and
    ``m_av`` from its bits, each residual stream's scale from its own, and
    an ibert LayerNorm's overflow shift from the bits of the stream it
    reads (:func:`ibert_ln_shift`: 2 on DeiT-S's 16-bit norm2 input, 0 on
    an 8-bit stream)."""
    sm_base, gelu_base = _families(config)
    s_attn_tab, s_gelu_tab = S_ATTN_TABLE[sm_base], S_GELU_TABLE[gelu_base]
    cfg, bw = config, config.bitwidths
    C, H = cfg.embed_dim, cfg.num_heads
    hidden = int(C * cfg.mlp_ratio)
    n_tok = cfg.num_patches + 1
    site = _Sites(np.random.default_rng(seed))
    p = {}

    def ln_site(bits):
        shift = ibert_ln_shift(C, bits) if config.base_type("ln") == "ibert" else 0.0
        return site.layernorm(C, shift)

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
    pos_int = _quant_w(pos, bw.pos_encoding, s_pos)
    x_std = float(np.hypot(patch_std, pos_std))
    s_block_in = _scale(x_std, bw.block_input)
    p["pos_addend"] = requant_const(pos_int, s_pos, s_block_in).astype(np.float32)
    p["m_x0"] = requant_multiplier(s_patch, s_block_in)
    p["s_block0"] = s_block_in

    fast_exp = fast_poly = sm_sum_i32 = ppoly_fastdiv = True
    blocks = []
    x_bits = bw.block_input
    for i in range(cfg.depth):
        s_attn = np.float32(s_attn_tab[i % 2])
        s_g = np.float32(s_gelu_tab[i % 2])
        blk = {}
        ln_b, ln_s, ln_sh = ln_site(x_bits)
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
        if sm_base == "ibert":
            c_int = np.floor(np.float32(_ib.EXP_C) / np.float32(s_attn * s_attn))
            blk["s_exp_act"] = _sym_scale(16, np.float32(0.0),
                                          np.float32(c_int * 2.0**30))
            s_sm = np.float32(2.0 / 2**bw.softmax)
        elif sm_base == "ppoly":
            blk["sm_bounds"], blk["sm_coeffs"] = _ppoly_site(
                cfg, "softmax", *PPOLY_SOFTMAX[i % 2])
            s_sm = np.float32(2.0 / 2**bw.softmax)
        elif sm_base == "float":
            s_sm = np.float32(2.0 / 2**bw.softmax)
        else:
            s_sm = np.float32(1.0 / 2 ** (bw.softmax - 1))
            sm_sum_i32 = sm_sum_i32 and _ivit_sum_fits_int32(s_attn, n_tok)
        ctx_std = CTX_GAIN[sm_base, bw.softmax] * q_std
        s_a2 = _scale(ctx_std)
        blk["m_av"] = requant_multiplier(np.float32(s_sm * s_q), s_a2)
        w, b, s_pj, proj_std = site.linear(C, C, s_a2, ctx_std)
        s_a3 = _scale(proj_std, bw.attention_out)
        blk.update(proj_w=w, proj_b=b, m_proj=requant_multiplier(s_pj, s_a3))
        res1_std = float(np.hypot(proj_std, x_std))
        s_res1 = _scale(res1_std, bw.norm2_in)
        blk["m_res1_x"] = requant_multiplier(s_a3, s_res1)
        blk["m_res1_id"] = requant_multiplier(s_block_in, s_res1)

        ln_b, ln_s, ln_sh = ln_site(bw.norm2_in)
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
        # freeze_model quantizes the float GELU on its input grid
        s_gelu_out = _gelu_out_scale(cfg, gelu_base, s_g)
        blk["m_gelu"] = requant_multiplier(s_gelu_out, s_m2)
        if gelu_base == "ppoly":
            ppoly_fastdiv &= _ppoly_gelu_leaves(cfg, blk, s_g, s_gelu_out,
                                                PPOLY_GELU[i % 2][1:])
        w, b, s_fc2, mlp_std = site.linear(hidden, C, s_m2, g_std)
        s_mlp = _scale(mlp_std, bw.mlp_out)
        blk.update(fc2_w=w, fc2_b=b, m_fc2=requant_multiplier(s_fc2, s_mlp))
        x_std = float(np.hypot(mlp_std, res1_std))
        s_block_out = _scale(x_std, bw.att_block_out)
        blk["m_res2_x"] = requant_multiplier(s_mlp, s_block_out)
        blk["m_res2_id"] = requant_multiplier(s_res1, s_block_out)

        fast_exp = fast_exp and _exp_fast_gate(sm_base, gelu_base, s_attn, s_g)
        fast_poly = fast_poly and _poly_fast_gate(sm_base, gelu_base, s_attn, s_g)
        blocks.append(blk)
        s_block_in, x_bits = s_block_out, bw.att_block_out
    p["blocks"] = blocks

    ln_b, ln_s, ln_sh = ln_site(x_bits)
    s_cls = _scale(1.0)
    p.update(lnf_bias_int=ln_b, lnf_shift=ln_sh, s_lnf=ln_s,
             m_lnf=requant_multiplier(ln_s, s_cls))
    w, b, s_head, _ = site.linear(C, cfg.num_classes, s_cls, 1.0)
    p.update(head_w=w, head_b=b, head_scale=s_head)
    cfg = dataclasses.replace(cfg, fast_exp=fast_exp, fast_poly=fast_poly,
                              use_lut=False, sm_sum_i32=sm_sum_i32,
                              ppoly_fastdiv=ppoly_fastdiv)
    return EngineSpec(config=cfg, params=spec_tree(p))


def _families(config):
    """(softmax, GELU) families of a config; raises for those the engines
    do not run."""
    _check_families(config)
    return config.base_type("softmax"), config.base_type("gelu")


# --- Swin ---------------------------------------------------------------------

# The int8 scores after the first requant spread over this fraction of
# their range at the softmax's scale (s_attn1 = SWIN_S_ATTN1_RATIO * s_attn;
# a JAX freeze of the test_swin_engine.py geometry gives m_attn2 of 0.60 to
# 0.90), so the rel-pos addend widens them into s_attn's grid.
SWIN_S_ATTN1_RATIO = 0.75
# The rel-pos bias table's spread, relative to the scores' real spread: a
# trained Swin's biases move a score by about half its spread.
SWIN_REL_GAIN = 0.5
# ctx = probs @ v keeps about this fraction of v's spread over a 49-key
# window, by softmax family (the DeiT-S values of CTX_GAIN, windowed).
SWIN_CTX_GAIN = {"ibert": 0.15, "ivit": 0.3, "ppoly": 0.15, "float": 0.3}
# The ppoly family's sites, (scale, min, max) for even and odd blocks (the
# odd ones shifted where the stage has room): stage 2's first two blocks in
# a JAX freeze of Swin-T with gelu and softmax "ppoly_backend_ibert" and the
# ivit LN (test_swin_engine.py's ppoly families), calibrated and fitted as
# PPOLY_SOFTMAX's DeiT-S.  A shifted block's softmax range reaches down to
# its mask, round(-100 / s_attn) = -18,581, below the scores' own offsets.
SWIN_PPOLY_SOFTMAX = ((0.0052431864, -66.0, 127.0),
                      (0.0053818272, -18633.0, 127.0))
SWIN_PPOLY_GELU = ((0.012791909, -1.5989887, 1.6245725),
                   (0.013311714, -1.6905876, 1.5042237))


def swin_tiny_config(depths=(2, 2, 6, 2), img_size: int = 224,
                     ln: str = "ivit", gelu: str = "ivit", softmax: str = "ivit",
                     embed_dim: int = 96, stage_heads=(3, 6, 12, 24),
                     window_size: int = 7,
                     num_classes: int = 1000) -> SwinEngineConfig:
    """Swin-T (``swin_tiny_patch4_window7_224``, ``ivit_tpu/models/swin.py``):
    224 px, patch 4, window 7, embed 96, depths (2, 2, 6, 2), heads (3, 6,
    12, 24), all bitwidths 8 with the 16-bit residual stream; ivit
    everywhere is the JAX package's Swin bench row.  Depth, widths and
    image size may be cut for tests; ``layout`` is filled in by
    :func:`synthetic_swin_spec`."""
    return SwinEngineConfig(
        img_size=img_size, patch_size=4, embed_dim=embed_dim,
        depth=sum(depths), num_heads=stage_heads[0], mlp_ratio=4.0,
        num_classes=num_classes, bitwidths=BitWidths(), gelu_type=gelu,
        softmax_type=softmax, layernorm_type=ln, depths=tuple(depths),
        stage_heads=tuple(stage_heads), window_size=window_size)


def ibert_ln_shift(dim: int, bits: int) -> float:
    """The overflow shift that calibration gives an ibert LayerNorm over
    ``dim`` channels of a ``bits``-bit stream spread to +-SIGMA standard
    deviations: the least ``shift`` with ``var / 2**(2 * shift) < 2**32``
    (``ivit_tpu/ops/ibert.py`` set_shift), var = dim * (2**(bits-1) /
    SIGMA)**2.  0 on the 8-bit stream; 1 or 2 on Swin-T's 16-bit one."""
    var = dim * (2.0 ** (bits - 1) / SIGMA) ** 2
    return float(max(0.0, np.ceil(np.log2(np.sqrt(var / 2.0**32)))))


def synthetic_swin_spec(config: SwinEngineConfig, seed: int = 0) -> SwinEngineSpec:
    """A seeded Swin engine spec for ``config`` (numpy parameter tree and
    the ``layout``), any mix of the families :func:`synthetic_spec` takes;
    the method of
    :func:`synthetic_spec`, site for site as ``freeze_swin_model`` emits
    them: the patch GEMM and patch norm, per block the rel-pos addend
    [H, n, n] (a drawn int8 table through ``requant_const``), ``m_attn2``
    and on shifted blocks ``mask_int = round(mask / s_attn)``, the
    ``{"merge": ...}`` entries, the final LN, ``m_pool`` and the head.  An
    ibert LN on the 16-bit stream gets its calibrated overflow shift
    (:func:`ibert_ln_shift`)."""
    sm_base, gelu_base = _families(config)
    ln_base = config.base_type("ln")
    s_attn_tab = {**S_ATTN_TABLE,
                  "ppoly": [t[0] for t in SWIN_PPOLY_SOFTMAX]}[sm_base]
    s_gelu_tab = {**S_GELU_TABLE, "ppoly": [t[0] for t in SWIN_PPOLY_GELU]}[gelu_base]
    cfg = config
    site = _Sites(np.random.default_rng(seed))

    def ln_site(dim, bits):
        shift = ibert_ln_shift(dim, bits) if ln_base == "ibert" else 0.0
        return site.layernorm(dim, shift)

    p = {}
    s_input = _scale(1.0)                      # images ~ N(0, 1)
    p["s_input"] = s_input
    D = cfg.embed_dim
    w, b, s_conv, patch_std = site.linear(cfg.patch_size ** 2 * 3, D, s_input, 1.0)
    s_bn = _scale(patch_std)
    pn_b, pn_s, pn_sh = ln_site(D, 8)
    s_patch = _scale(1.0)                      # LN outputs ~ N(beta, gamma)
    s0 = _scale(1.0, 16)
    p["patch"] = {"w": w, "b": b, "m": requant_multiplier(s_conv, s_bn),
                  "pn_bias_int": pn_b, "pn_shift": pn_sh, "s_pn": pn_s,
                  "m_norm": requant_multiplier(pn_s, s_patch),
                  "m_x0": requant_multiplier(s_patch, s0)}

    fast_exp = fast_poly = sm_sum_i32 = ppoly_fastdiv = True
    blocks, layout = [], []
    s_in, x_std, x_bits = s0, 1.0, 16
    grid = cfg.img_size // cfg.patch_size
    i_blk = 0
    for stage, depth in enumerate(cfg.depths):
        dim = cfg.embed_dim * 2 ** stage
        heads = cfg.stage_heads[stage]
        res = grid // 2 ** stage
        ws = min(cfg.window_size, res)
        n = ws * ws
        hidden = int(dim * cfg.mlp_ratio)
        for d in range(depth):
            s_attn = np.float32(s_attn_tab[i_blk % 2])
            s_g = np.float32(s_gelu_tab[i_blk % 2])
            pp_site = i_blk % 2
            i_blk += 1
            blk = {}
            ln_b, ln_s, ln_sh = ln_site(dim, x_bits)
            s_a1 = _scale(1.0)
            blk.update(ln1_bias_int=ln_b, ln1_shift=ln_sh, s_ln1=ln_s,
                       m_ln1=requant_multiplier(ln_s, s_a1))
            # qkv weights sized so the first score requant spreads
            # SCORE_SPREAD LSB at s_attn1
            s_attn1 = np.float32(SWIN_S_ATTN1_RATIO * s_attn)
            q_std = float(np.sqrt(SCORE_SPREAD * s_attn1))
            w, b, s_qkv, q_std = site.linear(dim, 3 * dim, s_a1, 1.0,
                                             w_std=q_std / np.sqrt(dim))
            s_q = _scale(q_std)
            blk.update(qkv_w=w, qkv_b=b, m_qkv=requant_multiplier(s_qkv, s_q))
            s_scores = np.float32(np.float32(s_q * s_q)
                                  * np.float32((dim // heads) ** -0.5))
            blk["m_attn"] = requant_multiplier(s_scores, s_attn1)
            # relative position bias: a drawn table quantized to int8, then
            # requanted onto s_attn
            table = site.rng.normal(0.0, SWIN_REL_GAIN * SCORE_SPREAD * s_attn1,
                                    ((2 * ws - 1) ** 2, heads)).astype(np.float32)
            s_table = _sym_scale(8, table.min(), table.max())
            table_int = _quant_w(table, 8, s_table)
            bias_int = table_int[relative_position_index(ws).reshape(-1)]
            bias_int = bias_int.reshape(n, n, heads).transpose(2, 0, 1)
            blk["rel_bias_addend"] = requant_const(bias_int, s_table, s_attn)
            blk["m_attn2"] = requant_multiplier(s_attn1, s_attn)
            blk["s_attn"] = s_attn
            shift = 0 if d % 2 == 0 or res <= cfg.window_size else ws // 2
            layout.append(("block", stage, shift))
            if shift > 0:
                mask = attention_mask((res, res), ws, shift)
                blk["mask_int"] = np.round(mask / np.float32(s_attn))
            if sm_base == "ibert":
                c_int = np.floor(np.float32(_ib.EXP_C) / np.float32(s_attn * s_attn))
                blk["s_exp_act"] = _sym_scale(16, np.float32(0.0),
                                              np.float32(c_int * 2.0**30))
                s_sm = np.float32(2.0 / 2**8)
            elif sm_base == "ppoly":
                blk["sm_bounds"], blk["sm_coeffs"] = _ppoly_site(
                    cfg, "softmax", *SWIN_PPOLY_SOFTMAX[pp_site])
                s_sm = np.float32(2.0 / 2**8)
            elif sm_base == "float":
                s_sm = np.float32(2.0 / 2**8)
            else:
                s_sm = np.float32(1.0 / 2**7)
                sm_sum_i32 = sm_sum_i32 and _ivit_sum_fits_int32(s_attn, n)
            ctx_std = SWIN_CTX_GAIN[sm_base] * q_std
            s_a3 = _scale(ctx_std)
            blk["m_av"] = requant_multiplier(np.float32(s_sm * s_q), s_a3)
            w, b, s_pj, proj_std = site.linear(dim, dim, s_a3, ctx_std)
            s_a4 = _scale(proj_std, 16)
            blk.update(proj_w=w, proj_b=b, m_proj=requant_multiplier(s_pj, s_a4))
            res1_std = float(np.hypot(proj_std, x_std))
            s_res1 = _scale(res1_std, 16)
            blk["m_res1_x"] = requant_multiplier(s_a4, s_res1)
            blk["m_res1_id"] = requant_multiplier(s_in, s_res1)

            ln_b, ln_s, ln_sh = ln_site(dim, 16)
            s_m1 = _scale(1.0)
            blk.update(ln2_bias_int=ln_b, ln2_shift=ln_sh, s_ln2=ln_s,
                       m_ln2=requant_multiplier(ln_s, s_m1))
            h_std = float(s_g) * 127.0 / SIGMA
            w, b, s_fc1, h_std = site.linear(dim, hidden, s_m1, 1.0,
                                             w_std=h_std / np.sqrt(dim))
            blk.update(fc1_w=w, fc1_b=b, m_fc1=requant_multiplier(s_fc1, s_g),
                       s_gelu=s_g)
            g_std = 0.6 * h_std
            s_m2 = _scale(g_std)
            # freeze_swin_model takes the ibert composite for a float GELU too
            s_gelu_out = _gelu_out_scale(
                cfg, "ibert" if gelu_base == "float" else gelu_base, s_g)
            blk["m_gelu"] = requant_multiplier(s_gelu_out, s_m2)
            if gelu_base == "ppoly":
                ppoly_fastdiv &= _ppoly_gelu_leaves(
                    cfg, blk, s_g, s_gelu_out, SWIN_PPOLY_GELU[pp_site][1:])
            w, b, s_fc2, mlp_std = site.linear(hidden, dim, s_m2, g_std)
            s_mlp = _scale(mlp_std)
            blk.update(fc2_w=w, fc2_b=b, m_fc2=requant_multiplier(s_fc2, s_mlp))
            x_std = float(np.hypot(mlp_std, res1_std))
            s_out = _scale(x_std, 16)
            blk["m_res2_x"] = requant_multiplier(s_mlp, s_out)
            blk["m_res2_id"] = requant_multiplier(s_res1, s_out)
            fast_exp = fast_exp and _exp_fast_gate(sm_base, gelu_base, s_attn, s_g)
            fast_poly = fast_poly and _poly_fast_gate(sm_base, gelu_base, s_attn, s_g)
            blocks.append(blk)
            s_in, x_bits = s_out, 16

        if stage < len(cfg.depths) - 1:
            layout.append(("merge", stage, 0))
            nb, nscale, nshift = ln_site(4 * dim, x_bits)
            s_n = _scale(1.0)
            w, _, red_scale, red_std = site.linear(4 * dim, 2 * dim, s_n, 1.0)
            s_r = _scale(red_std)
            blocks.append({"merge": {
                "norm_bias_int": nb, "norm_shift": nshift, "s_norm": nscale,
                "m_norm": requant_multiplier(nscale, s_n), "red_w": w,
                "m_red": requant_multiplier(red_scale, s_r)}})
            s_in, x_std, x_bits = s_r, red_std, 8
    p["blocks"] = blocks

    dim = cfg.embed_dim * 2 ** (len(cfg.depths) - 1)
    ln_b, ln_s, ln_sh = ln_site(dim, x_bits)
    s_cls = _scale(1.0)
    p.update(lnf_bias_int=ln_b, lnf_shift=ln_sh, s_lnf=ln_s,
             m_lnf=requant_multiplier(ln_s, s_cls))
    pool_std = 0.3                             # the token mean of LN outputs
    s_pool = _scale(pool_std)
    p["m_pool"] = requant_multiplier(s_cls, s_pool)
    w, b, s_head, _ = site.linear(dim, cfg.num_classes, s_pool, pool_std)
    p.update(head_w=w, head_b=b, head_scale=s_head)
    cfg = dataclasses.replace(cfg, layout=tuple(layout), fast_exp=fast_exp,
                              fast_poly=fast_poly, use_lut=False,
                              sm_sum_i32=sm_sum_i32, ppoly_fastdiv=ppoly_fastdiv)
    return SwinEngineSpec(config=cfg, params=spec_tree(p))


def with_tables(spec):
    """``spec`` (ViT or Swin) with the freeze-time tables a freeze writes
    (``freeze._block_luts``: ``sm_lut`` and ``gelu_lut`` a block, the
    ``sm_sum_i32`` gate; ``sm_sat`` on a shifted Swin block where
    ``luts.swin_shift_sat`` passes) and ``use_lut`` where every block has
    both tables, as ``freeze_model`` sets it; the leaves already there are
    shared, not copied."""
    cfg = spec.config
    sm_base, gelu_base = cfg.base_type("softmax"), cfg.base_type("gelu")
    swin = isinstance(spec, SwinEngineSpec)
    layout = cfg.layout if swin else [("block", 0, 0)] * len(spec.params["blocks"])
    use_lut, sum_i32, blocks = True, cfg.sm_sum_i32, []
    grid = cfg.img_size // cfg.patch_size
    for (kind, stage, shift), blk in zip(layout, spec.params["blocks"]):
        blk = dict(blk)
        if kind == "block":
            n = min(cfg.window_size, grid >> stage) ** 2 if swin else grid * grid + 1
            ok, s_ok = _block_luts(cfg, blk, sm_base, gelu_base, blk["s_attn"],
                                   blk["s_gelu"], n)
            use_lut, sum_i32 = use_lut and ok, sum_i32 and s_ok
            if shift > 0 and "sm_lut" in blk:
                sat_ok, sat = luts.swin_shift_sat(sm_base, blk["s_attn"],
                                                  float(blk["mask_int"].min()),
                                                  blk.get("s_exp_act"))
                if sat_ok:
                    blk["sm_sat"] = sat
        blocks.append(blk)
    cfg = dataclasses.replace(cfg, use_lut=use_lut, sm_sum_i32=sum_i32)
    return type(spec)(cfg, {**spec.params, "blocks": blocks})
