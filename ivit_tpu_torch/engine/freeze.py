"""Model freeze: a calibrated QAT sim -> integer-only engine spec
(counterpart of ``ivit_tpu/engine/freeze.py``).

:func:`freeze_model` walks the sim's variables on the host, quantizes every
weight to int8 and bias to int32, and builds the static scale graph, one
requant multiplier per edge, as JAX's ``freeze_model`` does, leaf for leaf:
the same keys, dtypes and values, the freeze-time LUTs (``engine/luts.py``)
and the gate flags included, so a spec saved by either package is the
same artifact.  The scale helpers are numpy f32 arithmetic, whose division
is correctly rounded and so bit-matches the sim's ``rdiv``, and every scale
product repeats the sim's f32 op sequence; the ppoly fast-div gate and the
LUTs evaluate the port's own integer cores on the CPU.  The synthetic
specs (:mod:`ivit_tpu_torch.engine.synthetic`) share the helpers.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..models.registry import parse_layer_name
from ..models.vit import BitWidths
from ..ops import ibert as _ib
from ..ops.ppoly import eval_piecewise_poly
from ..ops.quant import exp_fastdiv_ok
from . import luts

F32_EPS = float(np.finfo(np.float32).eps)


def _np(x):
    return np.asarray(x)


def _sym_scale(num_bits: int, x_min, x_max):
    """float32 scale exactly as the reference/trainer computes it."""
    n = np.float32(2 ** (num_bits - 1) - 1)
    mag = np.maximum(-_np(x_min).astype(np.float32),
                     _np(x_max).astype(np.float32))
    return np.maximum(mag / n, np.float32(F32_EPS))


def _quant_w(w, num_bits: int, scale):
    """clamp(round(w / s)) in float32 (``freeze.py:57``)."""
    n = 2 ** (num_bits - 1) - 1
    z = np.round(_np(w).astype(np.float32) / scale)
    return np.clip(z, -n - 1, n)


def requant_multiplier(s_in, s_out) -> np.ndarray:
    """Correctly-rounded f32 ratio ``s_in / s_out`` -- the dyadic multiplier."""
    return (_np(s_in).astype(np.float32)
            / _np(s_out).astype(np.float32)).astype(np.float32)


def requant_const(z_int, s_in, s_out):
    """Freeze-time constant requant: f32 ``round(z * M)``."""
    m = requant_multiplier(s_in, s_out)
    return np.round(_np(z_int).astype(np.float32) * m)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static architecture + approximation selection of a frozen engine.

    Field for field the JAX ``EngineConfig``, so one artifact JSON loads
    into either package."""

    img_size: int
    patch_size: int
    embed_dim: int
    depth: int
    num_heads: int
    mlp_ratio: float
    num_classes: int
    bitwidths: BitWidths
    gelu_type: str
    softmax_type: str
    layernorm_type: str
    qk_scale: Optional[float] = None
    fast_exp: bool = False
    fast_poly: bool = False
    use_lut: bool = False
    sm_sum_i32: bool = False
    ppoly_fastdiv: bool = False

    @property
    def head_dim(self):
        return self.embed_dim // self.num_heads

    @property
    def num_patches(self):
        return (self.img_size // self.patch_size) ** 2

    @property
    def attn_scale(self):
        return self.qk_scale or self.head_dim ** -0.5

    def base_type(self, which: str) -> str:
        name = {"gelu": self.gelu_type, "softmax": self.softmax_type,
                "ln": self.layernorm_type}[which]
        return parse_layer_name(name)[0]

    def type_params(self, which: str) -> dict:
        name = {"gelu": self.gelu_type, "softmax": self.softmax_type,
                "ln": self.layernorm_type}[which]
        return parse_layer_name(name)[1]


@dataclasses.dataclass
class EngineSpec:
    """Frozen integer network: static config + parameter tree (numpy arrays
    or torch tensors, see :func:`ivit_tpu_torch.engine.convert.params_to_torch`)."""

    config: EngineConfig
    params: Dict[str, Any]


def _exp_fast_gate(sm_base: str, gelu_base: str, s_attn, s_gelu) -> bool:
    """May every exp-chain quotient in a block use ``floor_div_int``?
    (freeze.py:154; ivit softmax n=15, ivit GELU n=23, ibert exp n=30)."""
    ok = True
    if sm_base == "ivit":
        x0 = np.floor(np.float32(-1.0) / np.float32(s_attn))
        ok = ok and exp_fastdiv_ok(x0, 15)
    elif sm_base == "ibert":
        x0 = np.floor(np.float32(_ib.EXP_X0) / np.float32(s_attn))
        ok = ok and exp_fastdiv_ok(x0, _ib.EXP_N)
    if gelu_base == "ivit":
        s_sig = np.float32(np.float32(s_gelu) * np.float32(1.702))
        x0 = np.floor(np.float32(-1.0) / s_sig)
        ok = ok and exp_fastdiv_ok(x0, 23)
    return bool(ok)


def _poly_fast_gate(sm_base: str, gelu_base: str, s_attn, s_gelu) -> bool:
    """May the block's ibert polynomials use the plain mul-add form?
    (freeze.py:228: every product and sum inside the f32-exact 2**24)."""
    lim = 2.0**24
    ok = True
    if sm_base == "ibert":
        s = np.float32(s_attn)
        x0 = abs(np.floor(np.float32(_ib.EXP_X0) / s))
        b = np.floor(np.float32(_ib.EXP_B) / s)
        c = abs(np.floor(np.float32(_ib.EXP_C) / np.float32(s * s)))
        ok = ok and bool(x0 * (x0 + abs(b)) + c < lim)
    if gelu_base == "ibert":
        se = np.float32(np.float32(s_gelu) / np.float32(_ib.GELU_K))
        b = abs(np.floor(np.float32(_ib.GELU_B) / se))
        c = abs(np.floor(np.float32(_ib.GELU_C) / np.float32(se * se)))
        ok = ok and bool(b * b + c < lim)
    return bool(ok)


# The bits of the GELU's input, the fc1 requant (``vit_int._mlp_unfused``
# and ``swin_int._mlp_unfused`` requant to it; the MLP kernels hold it as
# int8): the domain that the ppoly fast-div gate enumerates.
GELU_IN_BITS = 8
PPOLY_FASTDIV_PATCHES = 8


def _ppoly_fastdiv_gate(bounds, coeffs, scale_bits: int, s_out,
                        in_bits: int = GELU_IN_BITS) -> tuple:
    """Exhaustive proof that the ppoly GELU epilogue divide is one
    multiply plus at most ``PPOLY_FASTDIV_PATCHES`` fixups
    (``freeze.py:182``).  The GELU input is the int8 fc1 requant, so all
    256 inputs are evaluated in both forms:

        fast:  g = floor(poly(x) * c),  c = fl(fl(1 / s_out) * 2**-sb)

    and every input where ``fast`` differs from the rdiv form becomes a
    patch ``g += (x == h_j) * d_j``.  Returns ``(ok, c, patch_h [P],
    patch_d [P])``, unused slots ``h = 2**30`` (never an int8 input).
    ``in_bits``: the bits of the GELU input; the proof covers 8 only, so
    any other width raises rather than void it."""
    if in_bits != 8:
        raise ValueError(f"the ppoly fast-div gate enumerates the int8 GELU "
                         f"input domain; got a {in_bits}-bit input")
    truth = luts.ppoly_gelu_lut(bounds, coeffs, scale_bits, s_out)
    minv = np.float32(np.float32(1.0) / np.float32(s_out))
    c = np.float32(minv * np.float32(2.0 ** -scale_bits))
    x = np.arange(256, dtype=np.float32) - 128.0
    y_int = eval_piecewise_poly(torch.from_numpy(x), bounds, coeffs).numpy()
    fast = np.floor(y_int * c)
    bad = np.nonzero(truth != fast)[0]
    P = PPOLY_FASTDIV_PATCHES
    patch_h = np.full((P,), 2.0**30, np.float32)
    patch_d = np.zeros((P,), np.float32)
    if len(bad) > P:
        return False, c, patch_h, patch_d
    patch_h[:len(bad)] = x[bad]
    patch_d[:len(bad)] = (truth - fast)[bad]
    return True, c, patch_h, patch_d


def _block_luts(cfg, blk, sm_base, gelu_base, s_attn, s_gelu,
                n_softmax: int) -> tuple:
    """Write one block's freeze-time LUTs (``freeze.py:254``); returns
    ``(lut_ok, sum_i32_ok)``: whether both sites have a table, and whether
    the ivit softmax row sum fits one int32 reduction."""
    lut_ok = sum_ok = True
    if sm_base == "ivit":
        t = luts.shiftmax_exp_lut(s_attn)
        blk["sm_lut"] = t
        sum_ok = luts.sum_fits_int32(t, n_softmax)
    elif sm_base == "ibert":
        blk["sm_lut"] = luts.ibert_softmax_exp16_lut(s_attn, blk["s_exp_act"])
    elif sm_base == "ppoly":
        eb = int(cfg.type_params("softmax").get("exp_bits", 16))
        blk["sm_lut"] = luts.ppoly_softmax_exp_lut(blk["sm_bounds"],
                                                   blk["sm_coeffs"], eb)
    else:
        lut_ok = False
    if gelu_base == "ivit":
        blk["gelu_lut"] = luts.shift_gelu_exp_lut(s_gelu)
    elif gelu_base == "ibert":
        blk["gelu_lut"] = luts.ibert_gelu_lut(s_gelu)
    elif gelu_base == "ppoly":
        sb = int(cfg.type_params("gelu").get("scale_bits", 22))
        blk["gelu_lut"] = luts.ppoly_gelu_lut(blk["gelu_bounds"], blk["gelu_coeffs"],
                                              sb, blk["gelu_s_out"])
    else:
        lut_ok = False
    return lut_ok, sum_ok


def _require_fitted(qs: dict, site: str):
    """A ppoly site must be fitted before a freeze: an unfitted one would
    bake the all-zero placeholder table into the engine while the sim runs
    its golden function (``freeze.py:299``)."""
    if "fitted" in qs and float(_np(qs["fitted"]).reshape(-1)[0]) <= 0:
        raise ValueError(
            f"ppoly site {site!r} is not fitted; run "
            "ivit_tpu_torch.train.ppoly_fit.fit_ppoly_tables(model) after "
            "calibration, before freezing")


def _act_scale(qs: dict, name: str, bits: int) -> np.float32:
    st = qs[name]
    return _sym_scale(bits, st["x_min"], st["x_max"]).reshape(-1)[0]


def _linear(params_tree, s_in, weight_bit=8, bias_bit=32):
    """One linear site: (w int8 [I, O], b int32 [O], bias scale [O])
    (``freeze.py:322``)."""
    kernel = _np(params_tree["kernel"]).astype(np.float32)
    w_scale = _sym_scale(weight_bit, kernel.min(axis=0), kernel.max(axis=0))
    w_int = _quant_w(kernel, weight_bit, w_scale[None, :]).astype(np.int8)
    bias_scale = (w_scale.astype(np.float64) * np.float64(s_in)).astype(np.float32)
    if "bias" in params_tree:
        b_int = _quant_w(_np(params_tree["bias"]), bias_bit, bias_scale).astype(np.int32)
    else:
        b_int = np.zeros(kernel.shape[1], np.int32)
    return w_int, b_int, bias_scale


def _ln_site(params_tree, dim: int, qs: Optional[dict] = None):
    """LayerNorm freeze (``freeze.py:337``): integer bias ``floor((beta /
    gamma) / base)``, output scale ``base * gamma``, ``base = sqrt(C) /
    2**30``, and the ibert overflow shift."""
    gamma = _np(params_tree["weight"]).astype(np.float32)
    beta = _np(params_tree["bias"]).astype(np.float32)
    base = np.float32(np.sqrt(dim) / 2.0**30)
    bias_int = np.floor((beta / gamma) / base)
    shift = _np(qs["shift"]).reshape(-1)[0] if qs and "shift" in qs else np.float32(0)
    return bias_int.astype(np.float32), base * gamma, shift


def _gelu_out_scale(cfg, gelu_base, s_g) -> np.float32:
    """The GELU's output scale by family, f32 op for op as the sim's
    wrappers compute it (``freeze.py:489-514``)."""
    params = cfg.type_params("gelu")
    if gelu_base == "ivit":
        return np.float32(s_g) / np.float32(2.0**7)          # an exact shift
    if gelu_base == "ppoly" and str(params.get("backend", "ibert")) != "ibert":
        sb = int(params.get("scale_bits", 22))
        return np.float32(np.float32(s_g) / np.float32(2.0**sb))
    if gelu_base in ("ibert", "ppoly"):
        # ibert_gelu_int: s/K -> int_erf's s**2 * A * 2**N -> s * sig / 2
        sk = np.float32(np.float32(s_g) / np.float32(_ib.GELU_K))
        sig = np.float32(np.float32(np.float32(sk * sk) * np.float32(_ib.GELU_A))
                         * np.float32(2.0**_ib.GELU_N))
        return np.float32(np.float32(np.float32(s_g) * sig) / np.float32(2.0))
    return np.float32(s_g)            # float golden: quantized on the input grid


def _patch_gemm(conv, s_input):
    """The patch conv as one GEMM over flattened HWIO patches: (int8 w [K,
    D], int32 b [D], the GEMM's output scale [D])."""
    kernel = _np(conv["kernel"]).astype(np.float32)
    wf = kernel.reshape(-1, kernel.shape[-1])
    w_scale = _sym_scale(8, wf.min(axis=0), wf.max(axis=0))
    out_scale = (w_scale.astype(np.float64) * np.float64(s_input)).astype(np.float32)
    return (_quant_w(wf, 8, w_scale[None, :]).astype(np.int8),
            _quant_w(_np(conv["bias"]), 32, out_scale).astype(np.int32), out_scale)


def _mlp_half(cfg, blk, bp, bq, dim, s_res1, site, gelu_scale_base,
              mlp_bits: int, out_bits: int):
    """One block's MLP half into ``blk`` (LN2, fc1, the GELU, fc2 and the
    residual; ViT ``freeze.py:468-533``, Swin ``swin_int.py:200-266``):
    ``gelu_scale_base`` the family whose output grid the GELU takes,
    ``mlp_bits`` / ``out_bits`` the fc2 and residual QuantActs' bits.
    Returns ``(s_gelu, s_out, fastdiv_ok)``: the GELU's input and the
    block's output scale, and whether a ppoly GELU passed the fast-div
    gate (True for the other families)."""
    mp, mq = bp["mlp"], bq["mlp"]
    ln_bias, ln_scale, ln_shift = _ln_site(bp["norm2"], dim, bq.get("norm2"))
    s_m1 = _act_scale(bq, "qact3", 8)
    blk.update(ln2_bias_int=ln_bias, ln2_shift=ln_shift, s_ln2=ln_scale,
               m_ln2=requant_multiplier(ln_scale, s_m1))
    fc1_w, fc1_b, fc1_scale = _linear(mp["fc1"], s_m1)
    s_g = _act_scale(mq, "qact_gelu", 8)
    blk.update(fc1_w=fc1_w, fc1_b=fc1_b, m_fc1=requant_multiplier(fc1_scale, s_g),
               s_gelu=np.float32(s_g))
    ppoly = cfg.base_type("gelu") == "ppoly"
    if ppoly:
        _require_fitted(mq["act"], f"{site}.mlp.act")
        blk["gelu_bounds"] = _np(mq["act"]["bounds"]).astype(np.int32)
        blk["gelu_coeffs"] = _np(mq["act"]["coeffs"]).astype(np.float32)
    s_gelu_out = _gelu_out_scale(cfg, gelu_scale_base, s_g)
    s_m2 = _act_scale(mq, "qact1", 8)
    blk["m_gelu"] = requant_multiplier(s_gelu_out, s_m2)
    fastdiv_ok = True
    if ppoly:
        blk["gelu_s_out"] = np.float32(s_gelu_out)
        fastdiv_ok, c, ph, pd = _ppoly_fastdiv_gate(
            blk["gelu_bounds"], blk["gelu_coeffs"],
            int(cfg.type_params("gelu").get("scale_bits", 22)), s_gelu_out)
        blk.update(gelu_s_out_c=c, gelu_patch_h=ph, gelu_patch_d=pd)
    fc2_w, fc2_b, fc2_scale = _linear(mp["fc2"], s_m2)
    s_mlp_out = _act_scale(mq, "qact2", mlp_bits)
    blk.update(fc2_w=fc2_w, fc2_b=fc2_b, m_fc2=requant_multiplier(fc2_scale, s_mlp_out))
    s_out = _act_scale(bq, "qact4", out_bits)
    blk["m_res2_x"] = requant_multiplier(s_mlp_out, s_out)
    blk["m_res2_id"] = requant_multiplier(s_res1, s_out)
    return s_g, s_out, fastdiv_ok


def freeze_model(model) -> EngineSpec:
    """The integer engine spec of a calibrated (and, for ppoly, fitted) QAT
    sim (``freeze.py:348``): numpy leaves, int8 weights, int32 biases, f32
    everything else, as JAX's freeze emits them."""
    from ..models.convert import variables_to_numpy
    variables = variables_to_numpy(model)
    cfg = EngineConfig(
        img_size=model.img_size, patch_size=model.patch_size,
        embed_dim=model.embed_dim, depth=model.depth, num_heads=model.num_heads,
        mlp_ratio=model.mlp_ratio, num_classes=model.num_classes,
        bitwidths=model.bitwidths, gelu_type=model.gelu_type,
        softmax_type=model.softmax_type, layernorm_type=model.layernorm_type,
        qk_scale=model.qk_scale)
    bw = cfg.bitwidths
    P, Q = variables["params"], variables["quant_stats"]
    sm_base, gelu_base = cfg.base_type("softmax"), cfg.base_type("gelu")
    p: Dict[str, Any] = {}

    s_input = _act_scale(Q, "qact_input", 8)
    p["s_input"] = s_input
    w, b, conv_out_scale = _patch_gemm(P["patch_embed"]["proj"], s_input)
    s_patch = _act_scale(Q["patch_embed"], "qact", bw.patch_embed)
    p["patch"] = {"w": w, "b": b, "m": requant_multiplier(conv_out_scale, s_patch)}
    p["s_patch"] = s_patch
    # cls token + positional embedding, freeze-time integer constants
    p["cls_int"] = np.round(_np(P["cls_token"]).astype(np.float32)
                            / s_patch.astype(np.float32))
    s_pos = _act_scale(Q, "qact_pos", bw.pos_encoding)
    s_block0 = _act_scale(Q, "qact1", bw.block_input)
    pos_int = _quant_w(_np(P["pos_embed"]).astype(np.float32), bw.pos_encoding, s_pos)
    p["pos_addend"] = requant_const(pos_int, s_pos, s_block0).astype(np.float32)
    p["m_x0"] = requant_multiplier(s_patch, s_block0)
    p["s_block0"] = s_block0

    blocks = []
    s_block_in = s_block0
    fast_exp = fast_poly = use_lut = sm_sum_i32 = ppoly_fastdiv = True
    for i in range(cfg.depth):
        bp, bq = P[f"blocks_{i}"], Q[f"blocks_{i}"]
        aq, ap = bq["attn"], bp["attn"]
        blk: Dict[str, Any] = {}

        ln_bias, ln_scale, ln_shift = _ln_site(bp["norm1"], cfg.embed_dim,
                                               bq.get("norm1"))
        s_a1 = _act_scale(bq, "qact1", 8)
        blk.update(ln1_bias_int=ln_bias, ln1_shift=ln_shift, s_ln1=ln_scale,
                   m_ln1=requant_multiplier(ln_scale, s_a1))
        qkv_w, qkv_b, qkv_scale = _linear(ap["qkv"], s_a1)
        s_q = _act_scale(aq, "qact1", 8)
        blk.update(qkv_w=qkv_w, qkv_b=qkv_b, m_qkv=requant_multiplier(qkv_scale, s_q))
        # scores: f32 op for op as the sim (quant_matmul's s_a * s_b, then
        # the head scale), so the ratio matches bit for bit
        s_attn = _act_scale(aq, "qact_attn1", 8)
        s_scores = np.float32(np.float32(s_q * s_q) * np.float32(cfg.attn_scale))
        blk["m_attn"] = requant_multiplier(s_scores, s_attn)
        blk["s_attn"] = np.float32(s_attn)
        if sm_base == "ibert":
            blk["s_exp_act"] = _act_scale(aq["int_softmax"], "act", 16)
        elif sm_base == "ppoly":
            smq = aq["int_softmax"]
            _require_fitted(smq, f"blocks_{i}.attn.int_softmax")
            blk["sm_bounds"] = _np(smq["bounds"]).astype(np.int32)
            blk["sm_coeffs"] = _np(smq["coeffs"]).astype(np.float32)
        s_sm = (np.float32(2.0 / 2**bw.softmax) if sm_base in ("ibert", "ppoly", "float")
                else np.float32(1.0 / 2 ** (bw.softmax - 1)))
        s_a2 = _act_scale(aq, "qact2", 8)
        blk["m_av"] = requant_multiplier(np.float32(s_sm * s_q), s_a2)
        proj_w, proj_b, proj_scale = _linear(ap["proj"], s_a2)
        s_a3 = _act_scale(aq, "qact3", bw.attention_out)
        blk.update(proj_w=proj_w, proj_b=proj_b,
                   m_proj=requant_multiplier(proj_scale, s_a3))
        s_res1 = _act_scale(bq, "qact2", bw.norm2_in)
        blk["m_res1_x"] = requant_multiplier(s_a3, s_res1)
        blk["m_res1_id"] = requant_multiplier(s_block_in, s_res1)

        s_g, s_block_out, ok = _mlp_half(cfg, blk, bp, bq, cfg.embed_dim, s_res1,
                                         f"blocks_{i}", gelu_base, bw.mlp_out,
                                         bw.att_block_out)
        ppoly_fastdiv = ppoly_fastdiv and ok

        fast_exp = fast_exp and _exp_fast_gate(sm_base, gelu_base, s_attn, s_g)
        fast_poly = fast_poly and _poly_fast_gate(sm_base, gelu_base, s_attn, s_g)
        ok, s_ok = _block_luts(cfg, blk, sm_base, gelu_base, s_attn, s_g,
                               cfg.num_patches + 1)
        use_lut, sm_sum_i32 = use_lut and ok, sm_sum_i32 and s_ok
        blocks.append(blk)
        s_block_in = s_block_out
    p["blocks"] = blocks

    ln_bias, ln_scale, ln_shift = _ln_site(P["norm"], cfg.embed_dim, Q.get("norm"))
    s_cls = _act_scale(Q, "qact2", 8)
    p.update(lnf_bias_int=ln_bias, lnf_shift=ln_shift, s_lnf=ln_scale,
             m_lnf=requant_multiplier(ln_scale, s_cls))
    head_w, head_b, head_scale = _linear(P["head"], s_cls)
    p.update(head_w=head_w, head_b=head_b, head_scale=head_scale)
    cfg = dataclasses.replace(cfg, fast_exp=fast_exp, fast_poly=fast_poly,
                              use_lut=use_lut, sm_sum_i32=sm_sum_i32,
                              ppoly_fastdiv=ppoly_fastdiv)
    return EngineSpec(config=cfg, params=spec_tree(p))


def spec_tree(tree):
    """int8 / int32 leaves as they are, every other leaf an f32 array (the
    JAX freeze's ``_to_device`` dtype rule)."""
    if isinstance(tree, dict):
        return {k: spec_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [spec_tree(v) for v in tree]
    arr = np.asarray(tree, order="C")
    if arr.dtype in (np.int8, np.int32):
        return arr
    return arr.astype(np.float32)
