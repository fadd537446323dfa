"""Integer-only ViT forward (counterpart of ``ivit_tpu/engine/vit_int.py``).

Three paths, bit-identical to each other and to the JAX engine:

* ``kernels=True`` (the JAX fused branch, ``vit_int.py:527-596``): each
  block is one :func:`~ivit_tpu_torch.ops.kernels.block.attn_block` and one
  :func:`~ivit_tpu_torch.ops.kernels.block.mlp_block` call -- the CUDA
  kernels for tensors on the card, their plain versions on the CPU -- at
  any bitwidth vector the kernels take (the reference's INT16
  configuration, ``8,8,8,8,16,8,16,8``, included).  A spec with the float
  softmax or GELU takes the unfused forward instead, as JAX's
  ``use_blocks`` routes it (``vit_int.py:496-500``): no float kernel
  exists in either package, so this is JAX's routing, not a fallback;
* ``kernels="ops"`` (JAX's ``pallas="ops"`` hybrid, ``vit_int.py:37-45``):
  the unfused engine with the standalone kernels
  :func:`~ivit_tpu_torch.ops.kernels.nonlinear.shiftmax` and
  :func:`~ivit_tpu_torch.ops.kernels.nonlinear.shift_gelu_requant` in place
  of the ivit softmax and GELU + requant; every GEMM stays outside any
  kernel, and an ibert softmax or GELU runs unfused, as in JAX;
* ``kernels=False`` (the JAX unfused branch, ``vit_int.py:598-655``): the
  plain per-op engine on either device, the reference the kernels are held
  against on the card.

The patch-embed and head GEMMs and the input quant run outside any kernel
on every path, as in the JAX package.  The final cls-row LN + requant is
one :func:`~ivit_tpu_torch.ops.kernels.nonlinear.ln_requant` launch on the
two kernel paths (JAX leaves it to XLA) and the per-op chain on the plain
engine and while the envelope audit records.  The JAX fused
branch pads tokens to a multiple of 8 for the TPU's tiles; the port runs
the ``N`` real tokens unpadded.  The ivit, ibert, ppoly and float softmax
and GELU run, in any mix, with the ivit or ibert LayerNorm; the float and
ppoly LayerNorms raise, as in JAX.  With ``"ops"`` the ppoly and float
softmax and GELU run unfused, as in JAX: no standalone kernel exists for
them.  The float family is JAX's golden ``jax.nn.softmax`` /
``jax.nn.gelu`` with a quantized output, here ``torch.softmax`` in f32 and
``F.gelu(approximate="none")`` before the same floor and clip: torch's and
XLA's f32 ``exp`` / ``erf`` may differ in the last ulp, which moves a
quantized probability or GELU output by at most 1 on a few elements
(``tests/test_torch_port_float.py`` states the bound).

A spec frozen with ``use_lut`` carries its tables (``engine/luts.py``); the
fused paths read them where ``IVIT_LUT`` is set, the unfused engine where
``IVIT_XLA_LUT`` is set as well (``_xla_lut_on``, ``vit_int.py:256``), both
read at each call and off by default, as in JAX: one table lookup in place
of each exp / erf / polynomial tower, the same bits.

The envelope audit (``vit_int.py:67-116``): under :func:`audit_capture`
every integer site of the unfused path records its extrema beside the
bound its container, or the f32-exactness envelope, sets -- the nine sites
of JAX's engine, in its order.  :func:`fusion_report` says which path a
config takes with the port's own gates; ``Engine.fusion`` holds it.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import logging
import os

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..ops import ibert as ib
from ..ops import ivit as iv
from ..ops import ppoly as pp
from ..ops.kernels import block as kblock
from ..ops.kernels import nonlinear as knl
from ..ops.kernels.block import container as _container
from ..ops.kernels.block import int8_matmul, to_container
from ..ops.quant import exact_int_sum, rdiv
from ..parallel import collectives as coll
from ..parallel.mesh import check_engine_tp
from ..utils.spans import span
from .convert import params_to_torch
from .freeze import GELU_IN_BITS, EngineConfig, EngineSpec

_FAMILIES = {"softmax": ("ivit", "ibert", "ppoly", "float"),
             "gelu": ("ivit", "ibert", "ppoly", "float"),
             "ln": ("ivit", "ibert")}
# the LayerNorm families the integer engines do not run, in JAX as here
_NO_LN = {
    "ppoly": "the ppoly family has no LayerNorm (JAX's engine has none "
             "either)",
    "float": "the integer engine runs no float LayerNorm (JAX's raises too, "
             "vit_int.py:458-461: the QAT sim evaluates the float family)",
}


# ---------------------------------------------------------------------------
# Envelope audit (the datapath-sizing check; JAX's vit_int.py:60-116).  While
# a capture is active, every integer site of the unfused path records its
# extrema together with the bound its container -- or the f32-exactness
# envelope the QAT sim relies on -- imposes.
# ---------------------------------------------------------------------------

_AUDIT = None  # type: list | None

# f32 holds every integer in (-2**24, 2**24) exactly.  The GEMM accumulators
# run as int32 in the engine but as f32 in the QAT sim; their bit-equality
# holds while the values stay inside this envelope.
F32_EXACT = 2.0**24


@contextlib.contextmanager
def audit_capture():
    """Collect per-site integer extrema while the engine runs.

    Yields a list of records ``{site, kind, min, max, lo_bound, hi_bound}``
    (and ``sat_frac`` at the requant and residual sites, which clamp by
    design).  ``min``, ``max`` and ``sat_frac`` are 0-d f32 tensors on the
    engine's device, read (``float(...)``) when the caller wants them: a
    capture adds no host sync per site.  The taps live on the unfused path
    (``kernels=False``; the kernels are bitwise equal to it, so its
    envelopes are theirs) and at the sites outside the blocks on every path.
    """
    global _AUDIT
    _AUDIT = records = []
    try:
        yield records
    finally:
        _AUDIT = None


def _tap(kind, val, lo, hi, sat=False):
    if _AUDIT is None:
        return
    rec = {"site": f"{kind}#{len(_AUDIT)}", "kind": kind,
           "min": torch.amin(val).float(), "max": torch.amax(val).float(),
           "lo_bound": float(lo), "hi_bound": float(hi)}
    if sat:
        # requant sites clamp by design (calibration maps the observed range
        # onto the container; outliers saturate): record the share that
        # clips, as jnp.mean forms it (the f32 count times the f32
        # reciprocal of the element count)
        recip = float(np.float32(1.0) / np.float32(val.numel()))
        rec["sat_frac"] = ((val < lo) | (val > hi)).sum().float() * recip
    _AUDIT.append(rec)


def audit_violations(records):
    """Records whose extrema escape their declared bounds (empty == sized)."""
    bad = []
    for r in records:
        lo, hi = float(r["min"]), float(r["max"])
        if lo < r["lo_bound"] or hi > r["hi_bound"]:
            bad.append({**r, "min": lo, "max": hi})
    return bad


def fusion_report(cfg, kernels=True) -> dict:
    """Which path :func:`engine_forward` takes for ``cfg`` and ``kernels``,
    under JAX's keys (``vit_int.py:119``), the reasons naming the port's own
    gates: the fused block kernels unless ``kernels`` is not True or a
    softmax / GELU is float (no kernel for it in either package); with
    ``"ops"`` the standalone ivit Shiftmax / ShiftGELU kernels; the table
    forms where the spec carries them and ``IVIT_LUT`` is set."""
    sm, ge, ln = (cfg.base_type(w) for w in ("softmax", "gelu", "ln"))
    reasons = []
    if kernels is False:
        reasons.append("kernels=False: the plain per-op engine")
    elif kernels == "ops":
        reasons.append("kernels='ops': the standalone nonlinearity kernels "
                       "in the unfused engine")
    for which, base in (("softmax", sm), ("gelu", ge)):
        if base not in ("ivit", "ibert", "ppoly"):
            reasons.append(f"{which} family {base!r} has no fused block kernel")
    if ln not in ("ivit", "ibert"):
        reasons.append(f"ln family {ln!r}: the integer engine does not run it")
    fused_blocks = kernels is True and not reasons
    return {
        "fused_blocks": fused_blocks,
        "fused_softmax": fused_blocks or (kernels == "ops" and sm == "ivit"),
        "fused_gelu": fused_blocks or (kernels == "ops" and ge == "ivit"),
        "lut_nonlinearities": bool(fused_blocks and cfg.use_lut
                                   and kblock._lut_on()),
        "unfused_reasons": reasons,
    }


def _base(cfg: EngineConfig, which: str) -> str:
    """The family of one nonlinearity; raises for those the engines do not
    run."""
    base = cfg.base_type(which)
    if base not in _FAMILIES[which]:
        why = _NO_LN.get(base) if which == "ln" else None
        raise NotImplementedError(
            f"{which} family {base!r}: the port runs "
            f"{', '.join(_FAMILIES[which])}; {why or 'unknown family'}")
    return base


def _check_families(cfg: EngineConfig):
    for which in ("softmax", "gelu", "ln"):
        _base(cfg, which)


def fused_halves(cfg: EngineConfig):
    """(attention, MLP): which half-blocks have a fused kernel for the
    config's families -- all but the float softmax and the float GELU, as
    JAX's engines decide (``vit_int.py:496-500``, ``swin_int.py:496-502``)."""
    return _base(cfg, "softmax") != "float", _base(cfg, "gelu") != "float"


def _check_kernels(kernels):
    if kernels not in (True, False, "ops"):
        raise ValueError(f"kernels={kernels!r}: want True (the fused block "
                         "kernels), 'ops' (the standalone nonlinearity "
                         "kernels) or False (the plain engine)")


def _gemm_bias(a_int, w_int8, b_int32, row_sharded=False):
    """int8 GEMM (the operand wrapped to int8, as JAX's ``_dot_i8``) + bias,
    tapped: the sim computes the same value in f32.  ``row_sharded``
    (``proj``, ``fc2``): under a tensor-parallel mesh the weight holds this
    rank's rows, and the int32 partial accumulators are summed over the
    model axis before the bias is added once (int32 addition wraps the
    same in any order, so the sum is the single-device accumulator)."""
    acc = int8_matmul(a_int.to(torch.int8), w_int8)
    if row_sharded:
        acc = coll.all_reduce_exact(acc, "model")
    acc = acc + b_int32
    _tap("gemm_acc", acc, -F32_EXACT, F32_EXACT)
    return acc


# columns appended to a hidden row shard to carry the row's global max
_ROW_MAX_PAD = 16


def _with_row_max(x_int):
    """ShiftGELU's row max runs over the whole hidden row.  Under a
    tensor-parallel mesh this rank holds a block of its columns: the row's
    max over the model axis is appended as 16 more columns (keeping 16-byte
    rows), so that the kernel and the plain cores, which take the max of
    the row they are given, see the global one; an output depends on its
    input and the row max only, so the first columns are the single-device
    ones.  Returns ``(x, width)``, ``width`` None without a cut."""
    mesh = coll.active()
    if mesh is None or mesh.tp == 1:
        return x_int, None
    m = coll.reduce_max(torch.amax(x_int, dim=-1, keepdim=True).to(torch.int32),
                     "model").to(x_int.dtype)
    pad = m.expand(*x_int.shape[:-1], _ROW_MAX_PAD)
    return torch.cat([x_int, pad], dim=-1), x_int.shape[-1]


def _requant(acc, m, bits):
    """round(acc * m) clamped and stored in the ``bits`` container."""
    n = 2 ** (bits - 1) - 1
    y = torch.round(acc.float() * m)
    _tap(f"requant{bits}", y, -n - 1, n, sat=True)
    return torch.clamp(y, -n - 1, n).to(_container(bits))


def _ln_requant(y_int, m, bits):
    """Requant of the exact LayerNorm integer; a NaN (an ibert zero-variance
    row) is pinned to 0 first, as the kernels do, since NaN -> int is
    undefined."""
    y_int = torch.where(torch.isnan(y_int), torch.zeros_like(y_int), y_int)
    return _requant(y_int, m, bits)


def _xla_lut_on(cfg) -> bool:
    """The unfused engine's table forms (``vit_int.py:256``): a spec frozen
    with ``use_lut``, ``IVIT_LUT`` and ``IVIT_XLA_LUT`` both set."""
    return (cfg.use_lut and kblock._lut_on()
            and os.environ.get("IVIT_XLA_LUT", "0") not in ("", "0"))


def _softmax_int(cfg, blk, scores_int, kernels=False, allow_lut=True):
    """int8 scores -> probs in the softmax container.  ``allow_lut=False``:
    the scores leave the int8 domain (Swin's shift mask), the towers run
    (``vit_int.py:300``)."""
    bit = cfg.bitwidths.softmax
    base = _base(cfg, "softmax")
    if (allow_lut and kernels is False and base != "float" and "sm_lut" in blk
            and _xla_lut_on(cfg)):
        probs = kblock.softmax_lut(scores_int.float(), blk["sm_lut"], base, bit,
                                   sum_i32=cfg.sm_sum_i32)
        return to_container(probs, bit)
    if base == "ivit":
        if kernels == "ops":
            return knl.shiftmax(scores_int.to(torch.int8), blk["s_attn"], bit,
                                fast_q=cfg.fast_exp)
        probs, _ = iv.shiftmax_int(scores_int.float(), blk["s_attn"], bit,
                                   fast_q=cfg.fast_exp)
        return to_container(probs, bit)
    if base == "ppoly":
        probs = pp.ppoly_softmax_int(scores_int.float(), blk["sm_bounds"],
                                     blk["sm_coeffs"], _exp_bits(cfg), bit)
        return to_container(probs, bit)
    if base == "float":
        probs = torch.softmax(scores_int.float() * blk["s_attn"], dim=-1)
        qmax = 2 ** (bit - 1) - 1
        return torch.clamp(torch.floor(probs / (2.0 / 2**bit)), 0,
                           qmax).to(_container(bit))
    exp_int, _ = ib.ibert_softmax_exp_int(scores_int.float(), blk["s_attn"],
                                          fast_q=cfg.fast_exp,
                                          fast_poly=cfg.fast_poly)
    # internal 16-bit QuantAct on the raw exp ints, multiply form
    exp16 = torch.clamp(torch.round(exp_int * rdiv(1.0, blk["s_exp_act"])),
                        -(2.0**15), 2.0**15 - 1)
    exp_sum = exact_int_sum(exp16)
    _tap("exp_sum", exp_sum, 1.0, 2.0**31 - 1)
    factor = torch.floor(rdiv(2.0**32, exp_sum))
    return to_container(torch.floor(exp16 * factor / 2 ** (32 - bit + 1)), bit)


def _gelu_requant_int(cfg, blk, x_int, out_bits, kernels=False):
    """GELU followed by the dyadic requant to the next activation scale
    (the table form where :func:`_xla_lut_on`, but for ShiftGELU under a
    kernel path, which JAX gives its own kernel, ``vit_int.py:356``)."""
    if _base(cfg, "gelu") == "ivit":
        x_pad, width = _with_row_max(x_int)
        if width is not None:
            y = _gelu_requant_rows(cfg, blk, x_pad, out_bits, kernels)
            return y[..., :width].contiguous()
    return _gelu_requant_rows(cfg, blk, x_int, out_bits, kernels)


def _gelu_requant_rows(cfg, blk, x_int, out_bits, kernels):
    base = _base(cfg, "gelu")
    if (base != "float" and "gelu_lut" in blk and _xla_lut_on(cfg)
            and not (base == "ivit" and kernels is not False)):
        y = kblock.gelu_lut_int(x_int.float(), blk["gelu_lut"], base,
                                blk["s_gelu"], cfg.fast_exp)
        return _requant(y, blk["m_gelu"], out_bits)
    if base == "ivit":
        if kernels == "ops":
            return knl.shift_gelu_requant(x_int.to(torch.int8), blk["s_gelu"],
                                          blk["m_gelu"], 8, out_bits=out_bits,
                                          fast_q=cfg.fast_exp)
        y, _ = iv.shift_gelu_int(x_int.float(), blk["s_gelu"], 8,
                                 fast_q=cfg.fast_exp)
    elif base == "float":
        y = F.gelu(x_int.float() * blk["s_gelu"], approximate="none")
        y = torch.clamp(torch.floor(y / blk["s_gelu"]), -128, 127)
    elif base == "ppoly":
        y = pp.ppoly_gelu_int(x_int.float(), blk["gelu_bounds"],
                              blk["gelu_coeffs"], _scale_bits(cfg),
                              blk["gelu_s_out"], cfg.ppoly_fastdiv,
                              blk.get("gelu_s_out_c"), blk.get("gelu_patch_h"),
                              blk.get("gelu_patch_d"))
    else:
        y, _ = ib.ibert_gelu_int(x_int.float(), blk["s_gelu"],
                                 fast_poly=cfg.fast_poly)
    return _requant(y, blk["m_gelu"], out_bits)


def _exp_bits(cfg):
    """The ppoly softmax's exp grid bits (``exp_bits``, default 16)."""
    return int(cfg.type_params("softmax").get("exp_bits", 16))


def _scale_bits(cfg):
    """The ppoly GELU's output grid bits (``scale_bits``, default 22)."""
    return int(cfg.type_params("gelu").get("scale_bits", 22))


def _ppoly_gelu_kw(cfg, blk):
    """The fused MLP's ppoly GELU operands (none for another family)."""
    if _base(cfg, "gelu") != "ppoly":
        return {}
    return dict(gelu_bounds=blk["gelu_bounds"], gelu_coeffs=blk["gelu_coeffs"],
                gelu_s_out=blk["gelu_s_out"], gelu_scale_bits=_scale_bits(cfg),
                gelu_fastdiv=cfg.ppoly_fastdiv,
                gelu_s_out_c=blk.get("gelu_s_out_c"),
                gelu_patch_h=blk.get("gelu_patch_h"),
                gelu_patch_d=blk.get("gelu_patch_d"))


def _ppoly_softmax_kw(cfg, blk):
    """The fused attention's ppoly softmax operands (none for another
    family)."""
    if _base(cfg, "softmax") != "ppoly":
        return {}
    return dict(sm_bounds=blk["sm_bounds"], sm_coeffs=blk["sm_coeffs"],
                exp_bits=_exp_bits(cfg))


def _use_int_sqrt(cfg):
    return bool(cfg.type_params("ln").get("use_int_sqrt", False))


def _lut_kw(cfg, blk, which):
    """A fused call's table (``sm_lut`` with ``sm_sum_i32``, or
    ``gelu_lut``) where the spec was frozen with ``use_lut``, as JAX's
    engines pass them (``vit_int.py:563, 590``); the wrapper reads it only
    where ``IVIT_LUT`` is set."""
    lut = blk.get(f"{which}_lut") if cfg.use_lut else None
    if which == "sm":
        return dict(sm_lut=lut, sm_sum_i32=cfg.sm_sum_i32)
    return dict(gelu_lut=lut)


def _layernorm_int(cfg, x_int, bias_int, shift):
    if _base(cfg, "ln") == "ivit":
        if _AUDIT is not None:
            # the two-limb variance is exact iff C * (|y| / 2**8)**2 < 2**31
            bound = 2.0**8 * (2.0**31 / x_int.shape[-1]) ** 0.5
            _tap("ln_centered", iv.i_layernorm_centered(x_int.float()),
                 -bound, bound)
        return iv.i_layernorm_core(x_int.float()) + bias_int
    return ib.ibert_layernorm_int(x_int.float(), shift,
                                  use_int_sqrt=_use_int_sqrt(cfg)) + bias_int


def _norm_site(cfg, x, bias_int, shift, m, kernels):
    """A LayerNorm + int8 requant outside the block kernels (the final
    norm; Swin's patch norm and merges): one ``ln_requant`` launch where
    the engine launches kernels (``kernels`` True or ``"ops"``; its plain
    version on the CPU), the per-op chain on the plain engine and while the
    envelope audit records, whose taps are the chain's."""
    if kernels is False or _AUDIT is not None:
        return _ln_requant(_layernorm_int(cfg, x, bias_int, shift), m, 8)
    return knl.ln_requant(x, bias_int, m, shift, ln_base=_base(cfg, "ln"),
                          use_int_sqrt=_use_int_sqrt(cfg))


def _residual_requant(y, my, xr, mx, bits, tap=True):
    """The integer residual add (dual requant); ``tap=False`` where JAX's
    engine does not tap it (Swin's, ``swin_int.py:466``)."""
    lim = 2.0 ** (bits - 1)
    raw = torch.round(y.float() * my) + torch.round(xr.float() * mx)
    if tap:
        _tap(f"residual{bits}", raw, -lim, lim - 1, sat=True)
    return torch.clamp(raw, -lim, lim - 1).to(_container(bits))


def _attn_unfused(cfg, blk, x, kernels):
    bw = cfg.bitwidths
    B, N, _ = x.shape
    Dh = cfg.head_dim
    # this rank's heads under a tensor-parallel mesh (head-aligned shards)
    H = blk["qkv_w"].shape[1] // (3 * Dh)
    y = _layernorm_int(cfg, x, blk["ln1_bias_int"], blk["ln1_shift"])
    y = _ln_requant(y, blk["m_ln1"], 8)
    y = _requant(_gemm_bias(y, blk["qkv_w"], blk["qkv_b"]), blk["m_qkv"], 8)
    qkv = y.reshape(B, N, 3, H, Dh)
    q = qkv[:, :, 0].permute(0, 2, 1, 3)                     # [B, H, N, Dh]
    k = qkv[:, :, 1].permute(0, 2, 3, 1)                     # [B, H, Dh, N]
    v = qkv[:, :, 2].permute(0, 2, 1, 3)
    scores = int8_matmul(q, k)
    _tap("gemm_acc", scores, -F32_EXACT, F32_EXACT)
    scores = _requant(scores, blk["m_attn"], 8)
    probs = _softmax_int(cfg, blk, scores, kernels)
    ctx = int8_matmul(probs, v)
    _tap("gemm_acc", ctx, -F32_EXACT, F32_EXACT)
    y = _requant(ctx, blk["m_av"], 8)                        # [B, H, N, Dh]
    y = y.permute(0, 2, 1, 3).reshape(B, N, H * Dh)
    y = _requant(_gemm_bias(y, blk["proj_w"], blk["proj_b"], row_sharded=True),
                 blk["m_proj"], bw.attention_out)
    return _residual_requant(y, blk["m_res1_x"], x, blk["m_res1_id"],
                             bw.norm2_in)


def _mlp_unfused(cfg, blk, x, kernels):
    bw = cfg.bitwidths
    y = _layernorm_int(cfg, x, blk["ln2_bias_int"], blk["ln2_shift"])
    y = _ln_requant(y, blk["m_ln2"], 8)
    y = _requant(_gemm_bias(y, blk["fc1_w"], blk["fc1_b"]), blk["m_fc1"],
                 GELU_IN_BITS)
    y = _gelu_requant_int(cfg, blk, y, 8, kernels)
    y = _requant(_gemm_bias(y, blk["fc2_w"], blk["fc2_b"], row_sharded=True),
                 blk["m_fc2"], bw.mlp_out)
    return _residual_requant(y, blk["m_res2_x"], x, blk["m_res2_id"],
                             bw.att_block_out)


def _attn_fused(cfg, blk, x, kernels):
    bw = cfg.bitwidths
    return kblock.attn_block(
        x, ln_bias=blk["ln1_bias_int"], m_ln=blk["m_ln1"],
        ln_shift=blk["ln1_shift"], qkv_w=blk["qkv_w"], qkv_b=blk["qkv_b"],
        m_qkv=blk["m_qkv"], m_attn=blk["m_attn"], s_attn=blk["s_attn"],
        s_exp_act=blk.get("s_exp_act"), m_av=blk["m_av"],
        proj_w=blk["proj_w"], proj_b=blk["proj_b"], m_proj=blk["m_proj"],
        m_res_x=blk["m_res1_x"], m_res_id=blk["m_res1_id"],
        num_heads=cfg.num_heads, n_valid=x.shape[1], sm_bit=bw.softmax,
        attn_bits=8, proj_bits=bw.attention_out, out_bits=bw.norm2_in,
        fast_exp=cfg.fast_exp, fast_poly=cfg.fast_poly,
        ln_base=_base(cfg, "ln"), sm_base=_base(cfg, "softmax"),
        use_int_sqrt=_use_int_sqrt(cfg), **_ppoly_softmax_kw(cfg, blk),
        **_lut_kw(cfg, blk, "sm"))


def _mlp_fused(cfg, blk, x, kernels):
    bw = cfg.bitwidths
    B, N, C = x.shape
    y = kblock.mlp_block(
        x.reshape(B * N, C), ln_bias=blk["ln2_bias_int"], m_ln=blk["m_ln2"],
        ln_shift=blk["ln2_shift"], fc1_w=blk["fc1_w"], fc1_b=blk["fc1_b"],
        m_fc1=blk["m_fc1"], s_gelu=blk["s_gelu"], m_gelu=blk["m_gelu"],
        fc2_w=blk["fc2_w"], fc2_b=blk["fc2_b"], m_fc2=blk["m_fc2"],
        m_res_x=blk["m_res2_x"], m_res_id=blk["m_res2_id"],
        mlp_bits=bw.mlp_out, out_bits=bw.att_block_out,
        fast_exp=cfg.fast_exp, fast_poly=cfg.fast_poly,
        ln_base=_base(cfg, "ln"), gelu_base=_base(cfg, "gelu"),
        use_int_sqrt=_use_int_sqrt(cfg), fc1_wt=blk.get("fc1_wt"),
        fc2_wt=blk.get("fc2_wt"), **_ppoly_gelu_kw(cfg, blk),
        **_lut_kw(cfg, blk, "gelu"))
    return y.reshape(B, N, C)


def engine_forward(spec: EngineSpec, images, kernels=True, device=None,
                   mlp_wt=None, mesh=None):
    """images: f32 NHWC [B, img, img, 3] -> f32 logits [B, classes].

    ``kernels``: the fused block kernels (True), the standalone ivit
    nonlinearity kernels in the unfused engine ("ops"), or the unfused plain
    engine (False).  ``device``: where to run (default ``cuda``, or the
    rank's device on a mesh; raises without a card unless ``"cpu"``);
    params and images are moved there if needed.  ``mlp_wt``: one dict a
    block of its MLP weights transposed (:func:`transposed_mlp_weights`),
    or None.

    ``mesh``: a rank mesh (``parallel.make_mesh`` in a ``torch.distributed``
    world), the counterpart of JAX's ``jit(engine_forward,
    in_shardings=...)`` over ``shard_engine_params``.  ``spec`` then holds
    this rank's shards (``parallel.shard_engine_params``) and ``images``
    this rank's rows of the batch (``parallel.local_rows``); the
    row-sharded ``proj`` / ``fc2`` accumulators are summed over the model
    axis (:func:`_gemm_bias`) and the logits come back all-gathered over
    the data axis, bitwise the single-device engine's.  ``kernels=True``
    takes ``tp == 1`` only: the fused half-blocks end in the ``proj`` /
    ``fc2`` residual epilogue inside the kernel, where no partial sum can
    be reduced.
    """
    _check_kernels(kernels)
    cfg = spec.config
    _check_families(cfg)
    if mesh is not None:
        if not mesh.distributed:
            raise ValueError("engine_forward(mesh=) takes a mesh of ranks; the "
                             "server runs a mesh of devices (ServingEngine)")
        check_engine_tp(cfg, mesh.tp)
        if kernels is True and mesh.tp > 1 and all(fused_halves(cfg)):
            raise ValueError(f"kernels=True runs the fused block kernels, which "
                             f"end in the proj / fc2 residual epilogue: no "
                             f"partial sum to reduce under tp={mesh.tp}; use "
                             "kernels='ops' or False")
        device = mesh.device if device is None else device
    with coll.use(mesh):
        logits = _engine_forward(spec, images, kernels, resolve_device(device),
                                 mlp_wt)
        return coll.all_gather(logits, "data") if mesh is not None else logits


def params_on(spec, dev):
    """The spec's parameter tree on ``dev`` (:func:`params_to_torch`), spanned
    as ``ivit.params``."""
    with span("ivit.params"):
        return params_to_torch(spec.params, dev)


def quantized_patches(cfg, images, s_input, dev):
    """f32 NHWC images -> the int8 patch rows [B, g*g, ps*ps*3] on ``dev``
    (SymmetricQuantFunction on the raw image, then the patch layout),
    spanned as ``ivit.input``."""
    with span("ivit.input"):
        images = torch.as_tensor(images, dtype=torch.float32).to(dev)
        B, ps = images.shape[0], cfg.patch_size
        g = cfg.img_size // ps
        x = torch.clamp(torch.round(rdiv(images, s_input)), -128, 127)
        x = x.to(torch.int8).reshape(B, g, ps, g, ps, 3)
        return x.permute(0, 1, 3, 2, 4, 5).reshape(B, g * g, ps * ps * 3)


def _engine_forward(spec, images, kernels, dev, mlp_wt):
    cfg = spec.config
    bw = cfg.bitwidths
    C = cfg.embed_dim
    p = params_on(spec, dev)

    with torch.no_grad():
        x = quantized_patches(cfg, images, p["s_input"], dev)
        B = x.shape[0]
        with span("ivit.embed"):
            x = _requant(_gemm_bias(x, p["patch"]["w"], p["patch"]["b"]),
                         p["patch"]["m"], bw.patch_embed)

            # cls concat (shares the patch scale) + positional add at s_block0
            cls = p["cls_int"].to(torch.int32).expand(B, 1, C)
            x = torch.cat([cls, x.to(torch.int32)], dim=1)
            lim = 2.0 ** (bw.block_input - 1)
            x = torch.clamp(torch.round(x.float() * p["m_x0"]) + p["pos_addend"],
                            -lim, lim - 1).to(_container(bw.block_input))

        # the fused kernels where JAX runs them: no half-block is fused
        # when the softmax or the GELU is float (vit_int.py:496-500)
        fused = kernels is True and all(fused_halves(cfg))
        attn, mlp = (_attn_fused, _mlp_fused) if fused else \
            (_attn_unfused, _mlp_unfused)
        for blk, wt in zip(p["blocks"], mlp_wt or itertools.repeat({})):
            blk = {**blk, **wt}
            x = mlp(cfg, blk, attn(cfg, blk, x, kernels), kernels)

        # final norm on the cls row only -> head
        with span("ivit.head"):
            y = _norm_site(cfg, x[:, :1], p["lnf_bias_int"], p["lnf_shift"],
                           p["m_lnf"], kernels)[:, 0]
            acc = _gemm_bias(y, p["head_w"], p["head_b"])
            return acc.float() * p["head_scale"]


def transposed_mlp_weights(params):
    """Each block's MLP weights transposed to torch's Linear layout
    (``fc1_wt``, ``fc2_wt``), which the ``mlp_block`` kernel streams: one
    dict a block of ``params["blocks"]`` (empty for a PatchMerging entry).
    Kept beside the spec, never in it, so the spec saves as it was given."""
    return [{"fc1_wt": blk["fc1_w"].t().contiguous(),
             "fc2_wt": blk["fc2_w"].t().contiguous()} if "fc1_w" in blk else {}
            for blk in params["blocks"]]


def weight_transposes():
    """The weight transposes the kernel wrappers have made inside their
    calls (their ``transposes`` counters, summed)."""
    return (kblock.attn_block.transposes + kblock.swin_attn_block.transposes
            + kblock.mlp_block.transposes)


class Engine:
    """Callable integer inference engine for one frozen ViT or Swin spec
    (dispatching on the spec's type, as the JAX ``Engine`` does).

    ``kernels=None`` (the default, JAX's ``pallas=None``) resolves on the
    card through :func:`~ivit_tpu_torch.engine.dispatch.resolve`, to a path
    that launches a kernel: with ``probe_images``, a one-time timed probe
    of the fused kernels against ``"ops"`` for a ViT whose softmax or GELU
    is ivit; otherwise the H100 A/B tables (a ViT takes True, or ``"ops"``
    where its row says unfused and ``"ops"`` launches a kernel; a Swin
    takes True with the per-stage ``stage_paths`` of its table).  An
    explicit ``kernels`` or ``stage_paths`` skips both; on the CPU
    ``None`` means True (the wrappers run their plain versions there, so
    every path gives the same bits).  ``fusion`` is
    :func:`fusion_report` (ViT) or
    :func:`~ivit_tpu_torch.engine.swin_int.swin_fusion_report` (Swin) of
    the path taken, with ``path_choice`` the report of the choice: the
    table's or the probe's, or ``{"source": "caller", ...}``.

    Keeps the caller's spec as ``spec`` and moves its parameters to
    ``device`` once (default ``cuda``; raises without a card unless
    ``device="cpu"``); where the MLP half-blocks run fused
    (:func:`fused_halves`), keeps each block's MLP
    weights transposed beside them (:func:`transposed_mlp_weights`: the
    ``mlp_block`` kernel streams those, so a call neither transposes nor
    gives its weight maps fresh addresses), and runs :func:`engine_forward`
    (a ViT spec; ``kernels`` True, "ops" or False) or
    :func:`~ivit_tpu_torch.engine.swin_int.swin_engine_forward` (a Swin
    spec; ``kernels`` True or False, ``stage_paths`` one bool per stage) on
    them.

    Spans (:mod:`ivit_tpu_torch.utils.spans`, recorded only while a
    ``torch.profiler`` records): each call is the root ``ivit.call`` (on
    close ``transposes``, the call's :func:`weight_transposes`), over
    ``ivit.params`` (the parameter walk), ``ivit.input`` (the images to the
    device and their quantization), ``ivit.embed`` (patch GEMM, cls / pos;
    Swin: patch GEMM and patch norm), on Swin ``ivit.merge``, and
    ``ivit.head`` (final LN, Swin's pool, head GEMM); below them the
    wrappers' ``ivit.kernel.<wrapper>`` and, wherever a host scalar becomes
    a device tensor and the host waits for the device,
    ``ops/quant.py::f32``'s ``ivit.sync``.
    """

    def __init__(self, spec, device=None, kernels=None, stage_paths=None,
                 probe_images=None):
        # imported here: swin_int builds on this module
        from . import dispatch
        from .swin_int import (SwinEngineSpec, check_stage_paths,
                               check_swin_kernels, swin_engine_forward,
                               swin_fusion_report)
        _check_families(spec.config)
        attn_fused, mlp_fused = fused_halves(spec.config)
        is_swin = isinstance(spec, SwinEngineSpec)
        forward = swin_engine_forward if is_swin else engine_forward
        if is_swin:
            check_stage_paths(spec.config, stage_paths)
        else:
            mlp_fused = attn_fused and mlp_fused
            if stage_paths is not None:
                raise ValueError("stage_paths picks a path per Swin stage; "
                                 "a ViT spec has none")
        if kernels is not None:
            (check_swin_kernels if is_swin else _check_kernels)(kernels)
        self.device = resolve_device(device)
        self.spec = spec
        params = params_to_torch(spec.params, self.device)
        self._spec = type(spec)(spec.config, params)
        mlp_wt = (transposed_mlp_weights(params)
                  if mlp_fused and (kernels is None or kernels is True) else None)

        choice = {"source": "caller", "kernels": repr(kernels),
                  "stage_paths": stage_paths}
        if kernels is None and stage_paths is None and self.device.type == "cuda":
            probe = None
            if probe_images is not None:
                probe = (lambda k: functools.partial(
                    forward, self._spec, kernels=k, device=self.device,
                    mlp_wt=mlp_wt if k is True else None),
                    torch.as_tensor(probe_images, dtype=torch.float32).to(self.device))
            kernels, stage_paths, choice = dispatch.resolve(spec.config, probe)
        elif kernels is None:
            kernels = True

        if is_swin:
            self._forward = functools.partial(forward, stage_paths=stage_paths)
            self.fusion = swin_fusion_report(spec.config, kernels, stage_paths)
            fused = self.fusion["fused_window_attention"]
        else:
            self._forward = forward
            self.fusion = fusion_report(spec.config, kernels)
            fused = self.fusion["fused_blocks"]
        self.fusion["path_choice"] = choice
        log = logging.getLogger("ivit_tpu_torch.engine")
        if fused:
            log.info("engine path: fused block kernels (%s)", choice["source"])
        else:
            log.warning("engine path: unfused (%s; choice: %s)",
                        "; ".join(self.fusion["unfused_reasons"]) or "by stage",
                        choice)
        self.mlp_wt = mlp_wt if kernels is True else None
        self.kernels = kernels

    def __call__(self, images):
        with span("ivit.call") as s:
            before = weight_transposes() if s else None
            out = self._forward(self._spec, images, kernels=self.kernels,
                                device=self.device, mlp_wt=self.mlp_wt)
            if s:
                s.set(transposes=weight_transposes() - before)
            return out
