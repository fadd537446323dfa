"""Integer-only Swin forward (counterpart of ``ivit_tpu/engine/swin_int.py``).

Two paths, bit-identical to each other and to the JAX engine:

* ``kernels=True`` (the JAX fused branch, ``swin_int.py:546-652``): each
  block is one :func:`~ivit_tpu_torch.ops.kernels.block.swin_attn_block`
  call on the token-order stream, windowed by the kernel's row map, and one
  :func:`~ivit_tpu_torch.ops.kernels.block.mlp_block` call on the int16
  token rows -- the CUDA kernels for tensors on the card, their plain
  versions on the CPU;
* ``kernels=False`` (the unfused branch, ``swin_int.py:418-469, 653-665``):
  the plain per-op engine on either device, the reference the kernels are
  held against on the card.

``stage_paths`` picks the path per stage and ``fuse_parts`` the fused
half-blocks, as in JAX.  The input quant, the
patch GEMM, PatchMerging's gather and GEMM, the exact-int average pool and
the head run outside any kernel on every path, as in the JAX package; the
roll and window permutations too on the plain path, while the fused
window attention reads and writes the token-order stream through them
(``swin_attn_block``'s ``grid``; JAX rolls and partitions around its
kernel); the patch norm, each merge's norm and
the final LN, each with its int8 requant, are one
:func:`~ivit_tpu_torch.ops.kernels.nonlinear.ln_requant` launch where
``kernels`` is True (JAX leaves them to XLA; ``stage_paths`` does not
reach them) and the per-op chain on the plain engine.  The JAX fused branch pads
Swin's 96- and 192-channel stages to 128 lanes for the FFN kernel
(``c_valid``) and each window to 56 tokens for the attention kernel; the
port runs both unpadded.  JAX's Swin engine has no hybrid of standalone
nonlinearity kernels, so ``kernels="ops"`` raises.  The ivit, ibert, ppoly
and float softmax and GELU run, in any mix, with the ivit or ibert
LayerNorm.  As in JAX (``swin_int.py:496-502``), each half-block of a
fused stage is fused only where its nonlinearity has a kernel: a float
softmax runs its attention half, a float GELU its MLP half, unfused
(``vit_int.fused_halves``; no float kernel exists in either package).

The envelope audit's taps (``vit_int.audit_capture``) reach the unfused
path through the shared helpers at JAX's Swin sites: the patch, qkv, fc1,
fc2 and head GEMMs, every requant, the ibert exp sum and the ivit LN's
centred values; the score, context, proj and merge products and the two
residual adds are untapped, as in JAX.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict

import numpy as np
import torch

from .. import resolve_device
from ..models.swin import (attention_mask, from_windows, relative_position_index,
                           stage_geometry, to_windows)
from ..models.vit import BitWidths
from ..ops.kernels import block as kblock
from ..ops.kernels.block import int8_matmul
from ..ops.quant import exact_int_sum, rdiv
from ..parallel import collectives as coll
from ..parallel.mesh import check_tp_widths
from ..utils.spans import span
from .freeze import (GELU_IN_BITS, EngineConfig, _act_scale, _block_luts,
                     _exp_fast_gate, _linear, _ln_site, _mlp_half, _patch_gemm,
                     _poly_fast_gate, _quant_w, _require_fitted, requant_const,
                     requant_multiplier, spec_tree)
from .luts import swin_shift_sat
from .vit_int import (_base, _check_families, _gelu_requant_int, _gemm_bias,
                      _layernorm_int, _ln_requant, _lut_kw, _norm_site,
                      _ppoly_gelu_kw, _ppoly_softmax_kw, _requant,
                      _residual_requant, _softmax_int, _use_int_sqrt,
                      fused_halves, params_on, quantized_patches)


@dataclasses.dataclass(frozen=True)
class SwinEngineConfig(EngineConfig):
    """Swin adds stage structure on top of the base engine config.

    ``layout`` carries the static per-entry structure of ``params["blocks"]``:
    ``("block", stage, shift)`` or ``("merge", stage, 0)``."""

    depths: tuple = (2, 2, 6, 2)
    stage_heads: tuple = (3, 6, 12, 24)
    window_size: int = 7
    layout: tuple = ()


@dataclasses.dataclass
class SwinEngineSpec:
    """Frozen integer Swin: static config + parameter tree (numpy arrays or
    torch tensors)."""

    config: SwinEngineConfig
    params: Dict[str, Any]


def freeze_swin_model(model) -> SwinEngineSpec:
    """The integer engine spec of a calibrated (and, for ppoly, fitted)
    Swin QAT sim (``swin_int.py:70``), leaf for leaf as JAX's
    ``freeze_swin_model`` writes it: the patch GEMM and patch norm, per
    block the quantized relative-position addend, ``mask_int`` on shifted
    blocks and ``sm_sat`` where :func:`~ivit_tpu_torch.engine.luts.swin_shift_sat`
    passes, each ``{"merge": ...}``, the final LN, the pool and the head;
    the ``layout`` and the five gate flags folded over every block; the
    default bitwidths.  A sim with the absolute position embedding
    (``ape=True``) is refused: JAX's freeze leaves the embedding out, and
    its engine then differs from the sim (ROADMAP Queue 3)."""
    if model.ape:
        raise ValueError(
            "freeze_swin_model: ape=True is not frozen; the reference's "
            "freeze_swin_model (ivit_tpu/engine/swin_int.py:70) never reads "
            "absolute_pos_embed, so its engine leaves the embedding out and "
            "differs from the sim")
    from ..models.convert import variables_to_numpy
    variables = variables_to_numpy(model)
    cfg = SwinEngineConfig(
        img_size=model.img_size, patch_size=model.patch_size,
        embed_dim=model.embed_dim, depth=sum(model.depths),
        num_heads=model.num_heads[0], mlp_ratio=model.mlp_ratio,
        num_classes=model.num_classes, bitwidths=BitWidths(),
        gelu_type=model.gelu_type, softmax_type=model.softmax_type,
        layernorm_type=model.layernorm_type, depths=tuple(model.depths),
        stage_heads=tuple(model.num_heads), window_size=model.window_size)
    P, Q = variables["params"], variables["quant_stats"]
    sm_base, gelu_base = cfg.base_type("softmax"), cfg.base_type("gelu")
    p: Dict[str, Any] = {}

    s_input = _act_scale(Q, "qact_input", 8)
    p["s_input"] = s_input
    # the patch GEMM, the patch norm and its qact, then the 16-bit stage input
    w, b, conv_out_scale = _patch_gemm(P["patch_embed"]["proj"], s_input)
    s_bn = _act_scale(Q["patch_embed"], "qact_before_norm", 8)
    pn_bias, pn_scale, pn_shift = _ln_site(P["patch_embed"]["norm"], cfg.embed_dim,
                                           Q["patch_embed"].get("norm"))
    s_patch = _act_scale(Q["patch_embed"], "qact", 8)
    s0 = _act_scale(Q, "qact1", 16)
    p["patch"] = {
        "w": w, "b": b, "m": requant_multiplier(conv_out_scale, s_bn),
        "pn_bias_int": pn_bias, "pn_shift": pn_shift, "s_pn": pn_scale,
        "m_norm": requant_multiplier(pn_scale, s_patch),
        "m_x0": requant_multiplier(s_patch, s0)}

    blocks, layout = [], []
    s_in = s0
    fast_exp = fast_poly = use_lut = sm_sum_i32 = ppoly_fastdiv = True
    grid = cfg.img_size // cfg.patch_size
    for i, depth in enumerate(cfg.depths):
        dim, heads, res = cfg.embed_dim * 2 ** i, cfg.stage_heads[i], grid // 2 ** i
        for d in range(depth):
            name = f"layers_{i}_blocks_{d}"
            bp, bq = P[name], Q[name]
            aq, ap = bq["attn"], bp["attn"]
            ws, shift = stage_geometry(res, cfg.window_size,
                                       0 if d % 2 == 0 else cfg.window_size // 2)
            n = ws * ws
            blk: Dict[str, Any] = {}
            ln_bias, ln_scale, ln_shift = _ln_site(bp["norm1"], dim, bq.get("norm1"))
            s_a1 = _act_scale(bq, "qact1", 8)
            blk.update(ln1_bias_int=ln_bias, ln1_shift=ln_shift, s_ln1=ln_scale,
                       m_ln1=requant_multiplier(ln_scale, s_a1))
            qkv_w, qkv_b, qkv_scale = _linear(ap["qkv"], s_a1)
            s_q = _act_scale(aq, "qact1", 8)
            blk.update(qkv_w=qkv_w, qkv_b=qkv_b, m_qkv=requant_multiplier(qkv_scale, s_q))
            s_attn1 = _act_scale(aq, "qact_attn1", 8)
            # f32 op for op as the sim (quant_matmul's s1 * s1, then the
            # head scale), swin_int.py:151-152
            s_scores = np.float32(np.float32(s_q * s_q)
                                  * np.float32((dim // heads) ** -0.5))
            blk["m_attn"] = requant_multiplier(s_scores, s_attn1)
            # the quantized bias table, gathered and requanted onto s_attn2
            s_table = _act_scale(aq, "qact_table", 8)
            table = np.asarray(ap["relative_position_bias_table"]).astype(np.float32)
            bias_int = _quant_w(table, 8, s_table)[relative_position_index(ws).reshape(-1)]
            bias_int = bias_int.reshape(n, n, heads).transpose(2, 0, 1)
            s_attn2 = _act_scale(aq, "qact2", 8)
            blk["rel_bias_addend"] = requant_const(bias_int, s_table,
                                                   s_attn2).astype(np.float32)
            blk["m_attn2"] = requant_multiplier(s_attn1, s_attn2)
            blk["s_attn"] = np.float32(s_attn2)
            layout.append(("block", i, shift))
            if shift > 0:
                mask = attention_mask((res, res), ws, shift)
                blk["mask_int"] = np.round(mask / np.float32(s_attn2)).astype(np.float32)
            if sm_base == "ibert":
                blk["s_exp_act"] = _act_scale(aq["int_softmax"], "act", 16)
            elif sm_base == "ppoly":
                _require_fitted(aq["int_softmax"], f"{name}.attn.int_softmax")
                blk["sm_bounds"] = np.asarray(aq["int_softmax"]["bounds"]).astype(np.int32)
                blk["sm_coeffs"] = np.asarray(aq["int_softmax"]["coeffs"]).astype(np.float32)
            s_sm = np.float32(1.0 / 2**7) if sm_base == "ivit" else np.float32(2.0 / 2**8)
            s_a3 = _act_scale(aq, "qact3", 8)
            blk["m_av"] = requant_multiplier(np.float32(s_sm * s_q), s_a3)
            proj_w, proj_b, proj_scale = _linear(ap["proj"], s_a3)
            s_a4 = _act_scale(aq, "qact4", 16)
            blk.update(proj_w=proj_w, proj_b=proj_b,
                       m_proj=requant_multiplier(proj_scale, s_a4))
            s_res1 = _act_scale(bq, "qact2", 16)
            blk["m_res1_x"] = requant_multiplier(s_a4, s_res1)
            blk["m_res1_id"] = requant_multiplier(s_in, s_res1)

            # JAX's Swin freeze takes the ibert GELU grid for a float GELU
            # too (swin_int.py:219-236); fc2 requants to 8 bits, the residual
            # to 16
            s_g, s_out, ok = _mlp_half(cfg, blk, bp, bq, dim, s_res1, name,
                                       "ibert" if gelu_base == "float" else gelu_base,
                                       8, 16)
            ppoly_fastdiv = ppoly_fastdiv and ok
            fast_exp = fast_exp and _exp_fast_gate(sm_base, gelu_base, blk["s_attn"], s_g)
            fast_poly = fast_poly and _poly_fast_gate(sm_base, gelu_base, blk["s_attn"], s_g)
            ok, s_ok = _block_luts(cfg, blk, sm_base, gelu_base, blk["s_attn"], s_g, n)
            use_lut, sm_sum_i32 = use_lut and ok, sm_sum_i32 and s_ok
            if shift > 0 and "sm_lut" in blk:
                # masked positions saturate the exp tower where the gate
                # proves it; only then does the spec carry the constant
                sat_ok, sat = swin_shift_sat(sm_base, blk["s_attn"],
                                             float(blk["mask_int"].min()),
                                             blk.get("s_exp_act"))
                if sat_ok:
                    blk["sm_sat"] = sat
            blocks.append(blk)
            s_in = s_out

        if i < len(cfg.depths) - 1:
            dp, dq = P[f"layers_{i}_downsample"], Q[f"layers_{i}_downsample"]
            layout.append(("merge", i, 0))
            nb, nscale, nshift = _ln_site(dp["norm"], 4 * dim, dq.get("norm"))
            s_n = _act_scale(dq, "qact1", 8)
            red_w, _, red_scale = _linear(dp["reduction"], s_n)
            s_r = _act_scale(dq, "qact2", 8)
            blocks.append({"merge": {
                "norm_bias_int": nb, "norm_shift": nshift, "s_norm": nscale,
                "m_norm": requant_multiplier(nscale, s_n), "red_w": red_w,
                "m_red": requant_multiplier(red_scale, s_r)}})
            s_in = s_r
    p["blocks"] = blocks

    ln_bias, ln_scale, ln_shift = _ln_site(
        P["norm"], cfg.embed_dim * 2 ** (len(cfg.depths) - 1), Q.get("norm"))
    s_cls = _act_scale(Q, "qact2", 8)
    p.update(lnf_bias_int=ln_bias, lnf_shift=ln_shift, s_lnf=ln_scale,
             m_lnf=requant_multiplier(ln_scale, s_cls))
    s_pool = _act_scale(Q, "qact3", 8)
    p["m_pool"] = requant_multiplier(s_cls, s_pool)
    head_w, head_b, head_scale = _linear(P["head"], s_pool)
    p.update(head_w=head_w, head_b=head_b, head_scale=head_scale)
    cfg = dataclasses.replace(cfg, layout=tuple(layout), fast_exp=fast_exp,
                              fast_poly=fast_poly, use_lut=use_lut,
                              sm_sum_i32=sm_sum_i32, ppoly_fastdiv=ppoly_fastdiv)
    return SwinEngineSpec(config=cfg, params=spec_tree(p))


def check_swin_kernels(kernels):
    if kernels == "ops":
        raise ValueError(
            "kernels='ops' runs ViT's standalone nonlinearity kernels; the "
            "Swin engine has no such hybrid (JAX's runs its fused kernels "
            "for pallas='ops'): use kernels=True or False")
    if kernels not in (True, False):
        raise ValueError(f"kernels={kernels!r}: want True (the fused block "
                         "kernels) or False (the plain engine)")


def _attn_unfused(cfg, blk, x, B, res, dim, heads, ws, shift):
    """Per-op window-attention half-block (``_swin_attn_unfused``).  Under a
    tensor-parallel mesh the block holds this rank's heads (``qkv``'s
    columns, ``rel_bias_addend``'s rows, ``proj``'s rows) and ``proj``'s
    int32 partial sums are summed over the model axis before its bias."""
    n, dh = ws * ws, dim // heads
    heads = blk["qkv_w"].shape[1] // (3 * dh)
    y = _layernorm_int(cfg, x, blk["ln1_bias_int"], blk["ln1_shift"])
    y = _ln_requant(y, blk["m_ln1"], 8)
    yw = to_windows(y, B, res, dim, ws, shift)               # [B*nW, n, C] i8
    q8 = _requant(_gemm_bias(yw, blk["qkv_w"], blk["qkv_b"]), blk["m_qkv"], 8)
    qkv = q8.reshape(-1, n, 3, heads, dh)
    q = qkv[:, :, 0].permute(0, 2, 1, 3)                     # [B*nW, H, n, Dh]
    k = qkv[:, :, 1].permute(0, 2, 3, 1)
    v = qkv[:, :, 2].permute(0, 2, 1, 3)
    scores = _requant(int8_matmul(q, k), blk["m_attn"], 8)
    # + the quantized relative position bias, then the int8 clip, then the
    # shift mask (masked scores leave the int8 range and stay f32)
    attn = torch.clamp(torch.round(scores.float() * blk["m_attn2"])
                       + blk["rel_bias_addend"][None], -128, 127)
    if shift > 0:
        nw = (res // ws) ** 2
        attn = (attn.reshape(B, nw, heads, n, n)
                + blk["mask_int"][None, :, None]).reshape(-1, heads, n, n)
    # the tables only where the scores stay int8: the shift mask leaves the
    # domain (``swin_int.py:447-451``)
    probs = _softmax_int(cfg, blk, attn, allow_lut=shift == 0)
    ctx = _requant(int8_matmul(probs, v), blk["m_av"], 8)    # [B*nW, H, n, Dh]
    ctx = ctx.permute(0, 2, 1, 3).reshape(-1, n, heads * dh)
    # proj untapped: JAX's contracts (H, Dh) with dot_general (swin_int.py:457)
    acc = coll.all_reduce_exact(int8_matmul(ctx, blk["proj_w"]), "model")
    yo = _requant(acc + blk["proj_b"], blk["m_proj"], 16)
    yo = from_windows(yo, B, res, dim, ws, shift)
    return _residual_requant(yo, blk["m_res1_x"], x, blk["m_res1_id"], 16,
                             tap=False)


def _attn_fused(cfg, blk, x, B, res, dim, heads, ws, shift):
    """The window-attention half-block as one ``swin_attn_block`` call on
    the token-order stream (int16, or int8 after a merge) as it stands: the
    kernel reads and writes its windows' rows through the roll and the
    partition (``grid``), so nothing is rolled or permuted around it."""
    yo = kblock.swin_attn_block(
        x, grid=(res, ws, shift), ln_bias=blk["ln1_bias_int"], m_ln=blk["m_ln1"],
        ln_shift=blk["ln1_shift"], qkv_w=blk["qkv_w"], qkv_b=blk["qkv_b"],
        m_qkv=blk["m_qkv"], m_attn=blk["m_attn"], m_attn2=blk["m_attn2"],
        s_attn=blk["s_attn"], rel_addend=blk["rel_bias_addend"],
        mask_addend=blk["mask_int"] if shift > 0 else None,
        m_av=blk["m_av"], proj_w=blk["proj_w"], proj_b=blk["proj_b"],
        m_proj=blk["m_proj"], m_res_x=blk["m_res1_x"],
        m_res_id=blk["m_res1_id"], num_heads=heads,
        n_windows=(res // ws) ** 2, s_exp_act=blk.get("s_exp_act"),
        sm_bit=cfg.bitwidths.softmax, fast_exp=cfg.fast_exp,
        fast_poly=cfg.fast_poly, ln_base=_base(cfg, "ln"),
        sm_base=_base(cfg, "softmax"), use_int_sqrt=_use_int_sqrt(cfg),
        sm_sat=blk.get("sm_sat") if cfg.use_lut and shift > 0 else None,
        **_ppoly_softmax_kw(cfg, blk), **_lut_kw(cfg, blk, "sm"))
    return yo


def _mlp_unfused(cfg, blk, x):
    y = _layernorm_int(cfg, x, blk["ln2_bias_int"], blk["ln2_shift"])
    y = _ln_requant(y, blk["m_ln2"], 8)
    y = _requant(_gemm_bias(y, blk["fc1_w"], blk["fc1_b"]), blk["m_fc1"],
                 GELU_IN_BITS)
    y = _gelu_requant_int(cfg, blk, y, 8)
    y = _requant(_gemm_bias(y, blk["fc2_w"], blk["fc2_b"], row_sharded=True),
                 blk["m_fc2"], 8)
    return _residual_requant(y, blk["m_res2_x"], x, blk["m_res2_id"], 16,
                             tap=False)


def _mlp_fused(cfg, blk, x):
    """The FFN half-block as one ``mlp_block`` call on the int16 rows: fc2
    requant to 8 bits, residual and output at 16 (``swin_int.py:617-649``;
    C as it is, no lane padding)."""
    B, L, C = x.shape
    y = kblock.mlp_block(
        x.reshape(B * L, C), ln_bias=blk["ln2_bias_int"], m_ln=blk["m_ln2"],
        ln_shift=blk["ln2_shift"], fc1_w=blk["fc1_w"], fc1_b=blk["fc1_b"],
        m_fc1=blk["m_fc1"], s_gelu=blk["s_gelu"], m_gelu=blk["m_gelu"],
        fc2_w=blk["fc2_w"], fc2_b=blk["fc2_b"], m_fc2=blk["m_fc2"],
        m_res_x=blk["m_res2_x"], m_res_id=blk["m_res2_id"], mlp_bits=8,
        out_bits=16, fast_exp=cfg.fast_exp, fast_poly=cfg.fast_poly,
        ln_base=_base(cfg, "ln"), gelu_base=_base(cfg, "gelu"),
        use_int_sqrt=_use_int_sqrt(cfg), fc1_wt=blk.get("fc1_wt"),
        fc2_wt=blk.get("fc2_wt"), **_ppoly_gelu_kw(cfg, blk),
        **_lut_kw(cfg, blk, "gelu"))
    return y.reshape(B, L, C)


def _merge(cfg, mg, x, B, res, dim, kernels):
    """PatchMerging: 2x2 neighbours concatenated (integer data movement),
    LN over 4C, reduction GEMM (no bias), requant to int8."""
    with span("ivit.merge"):
        xm = x.reshape(B, res, res, dim)
        xm = torch.cat([xm[:, 0::2, 0::2], xm[:, 1::2, 0::2],
                        xm[:, 0::2, 1::2], xm[:, 1::2, 1::2]], dim=-1)
        xm = xm.reshape(B, -1, 4 * dim)
        y = _norm_site(cfg, xm, mg["norm_bias_int"], mg["norm_shift"],
                       mg["m_norm"], kernels)
        return _requant(int8_matmul(y, mg["red_w"]), mg["m_red"], 8)


def swin_fusion_report(cfg, kernels=True, stage_paths=None) -> dict:
    """Which path :func:`swin_engine_forward` takes, under JAX's keys
    (``swin_int.py:371``), the reasons naming the port's own gates: a stage
    runs fused where ``kernels`` is True and ``stage_paths`` (None: every
    stage) says so; there its attention half takes ``swin_attn_block``
    unless the softmax is float, its MLP half ``mlp_block`` unless the GELU
    is float.  The port runs every stage at its own width, so the stage
    keys carry no lane padding."""
    sm, ge, ln = (cfg.base_type(w) for w in ("softmax", "gelu", "ln"))
    dims = [cfg.embed_dim * 2**i for i in range(len(cfg.depths))]
    on = [kernels is True and (stage_paths is None or bool(stage_paths[i]))
          for i in range(len(dims))]
    reasons = []
    if kernels is not True:
        reasons.append(f"kernels={kernels!r}: the plain per-op engine")
    if ge not in ("ivit", "ibert", "ppoly"):
        reasons.append(f"gelu family {ge!r} has no fused kernel")
    if ln not in ("ivit", "ibert"):
        reasons.append(f"ln family {ln!r}: the integer engine does not run it")
    attn_reasons = []
    if sm not in ("ivit", "ibert", "ppoly"):
        attn_reasons.append(f"softmax family {sm!r} has no fused kernel")
    fuse_mlp = kernels is True and not reasons
    fuse_attn = (kernels is True and ln in ("ivit", "ibert")
                 and not attn_reasons)
    attn_stages = [bool(fuse_attn and o) for o in on]
    mlp_stages = {f"stage{i}(dim={d})": bool(fuse_mlp and o)
                  for i, (d, o) in enumerate(zip(dims, on))}
    return {"fused_mlp_stages": mlp_stages,
            "fused_window_attention": any(attn_stages),
            "fused_attn_stages": attn_stages,
            "lut_nonlinearities": bool((any(attn_stages)
                                        or any(mlp_stages.values()))
                                       and cfg.use_lut and kblock._lut_on()),
            "unfused_reasons": reasons + attn_reasons}


FUSE_PARTS = frozenset({"attn", "mlp", "mlp_pad", "mlp_nopad"})


def check_stage_paths(cfg, stage_paths):
    if stage_paths is not None and len(stage_paths) != len(cfg.depths):
        raise ValueError(f"stage_paths {stage_paths!r}: want one bool for each "
                         f"of the {len(cfg.depths)} stages")


def swin_engine_forward(spec: SwinEngineSpec, images, kernels=True,
                        device=None, stage_paths=None, mlp_wt=None, mesh=None,
                        fuse_parts=("attn", "mlp")):
    """images: f32 NHWC [B, img, img, 3] -> f32 logits [B, classes].

    ``kernels``: the fused block kernels (True) or the unfused plain engine
    (False); ``stage_paths``: one bool per stage, fused or unfused for that
    stage (``None``: ``kernels`` everywhere; a stage is fused only where
    ``kernels`` is True).  ``fuse_parts``: JAX's A/B switch
    (``swin_int.py:473-500``), which half-blocks of a fused stage take
    their kernel: ``"attn"`` the window attention, ``"mlp"`` (or
    ``"mlp_pad"``) the MLP; ``"mlp_nopad"`` keeps the MLP kernel to stages
    whose width is a multiple of 128 (JAX pads the others to 128 lanes,
    ``"mlp_pad"`` overriding; the port pads nothing).  Every choice gives
    the same bits.  ``device``: where to run (default ``cuda``;
    raises without a card unless ``"cpu"``); params and images are moved
    there if needed.  ``mlp_wt``: one dict a ``params["blocks"]`` entry of
    its MLP weights transposed (``vit_int.transposed_mlp_weights``), or
    None.

    ``mesh``: a rank mesh, as :func:`~ivit_tpu_torch.engine.vit_int.
    engine_forward` takes it (this rank's shards from
    ``parallel.shard_engine_params``, which cuts ``rel_bias_addend`` by
    head too, and its rows of the batch; the logits all-gathered over the
    data axis); ``tp > 1`` takes the plain path only (``kernels=False``,
    or every ``stage_paths`` entry False).
    """
    check_swin_kernels(kernels)
    cfg = spec.config
    _check_families(cfg)
    check_stage_paths(cfg, stage_paths)
    if isinstance(fuse_parts, str) or not set(fuse_parts) <= FUSE_PARTS:
        raise ValueError(f"fuse_parts {fuse_parts!r}: want a tuple of "
                         f"{sorted(FUSE_PARTS)}")
    if mesh is not None:
        if not mesh.distributed:
            raise ValueError("swin_engine_forward(mesh=) takes a mesh of ranks")
        for i, heads in enumerate(cfg.stage_heads):
            dim = cfg.embed_dim * 2 ** i
            check_tp_widths([(f"the heads of stage {i}", heads),
                             (f"the MLP hidden width of stage {i}",
                              int(dim * cfg.mlp_ratio))], mesh.tp)
        fused_any = kernels is True and (stage_paths is None or any(stage_paths))
        if fused_any and mesh.tp > 1 and any(fused_halves(cfg)):
            raise ValueError(f"kernels=True runs the fused block kernels, which "
                             f"end in the proj / fc2 residual epilogue: no "
                             f"partial sum to reduce under tp={mesh.tp}; use "
                             "kernels=False")
        device = mesh.device if device is None else device
    with coll.use(mesh):
        logits = _swin_forward(spec, images, kernels, resolve_device(device),
                               stage_paths, mlp_wt, fuse_parts)
        return coll.all_gather(logits, "data") if mesh is not None else logits


def _swin_forward(spec, images, kernels, dev, stage_paths, mlp_wt, fuse_parts):
    cfg = spec.config
    p = params_on(spec, dev)

    with torch.no_grad():
        x = quantized_patches(cfg, images, p["s_input"], dev)
        B = x.shape[0]
        with span("ivit.embed"):
            x = _requant(_gemm_bias(x, p["patch"]["w"], p["patch"]["b"]),
                         p["patch"]["m"], 8)
            # patch norm, its qact, then the 16-bit stage input
            x = _norm_site(cfg, x, p["patch"]["pn_bias_int"],
                           p["patch"]["pn_shift"], p["patch"]["m_norm"], kernels)
            x = torch.clamp(torch.round(x.float() * p["patch"]["m_x0"]),
                            -(2.0**15), 2.0**15 - 1).to(torch.int16)

        res, dim = cfg.img_size // cfg.patch_size, cfg.embed_dim
        attn_kernel, mlp_kernel = fused_halves(cfg)
        attn_kernel = attn_kernel and "attn" in fuse_parts
        mlp_kernel = mlp_kernel and bool({"mlp", "mlp_pad"} & set(fuse_parts))
        mlp_any_width = "mlp_nopad" not in fuse_parts or "mlp_pad" in fuse_parts
        for (kind, stage, shift), blk, wt in zip(
                cfg.layout, p["blocks"], mlp_wt or itertools.repeat({})):
            if kind == "merge":
                x = _merge(cfg, blk["merge"], x, B, res, dim, kernels)
                res, dim = res // 2, dim * 2
                continue
            heads = cfg.stage_heads[stage]
            ws = min(cfg.window_size, res)
            fused = kernels is True and (stage_paths is None
                                         or bool(stage_paths[stage]))
            if fused and attn_kernel:
                x = _attn_fused(cfg, blk, x, B, res, dim, heads, ws, shift)
            else:
                x = _attn_unfused(cfg, blk, x, B, res, dim, heads, ws, shift)
            if fused and mlp_kernel and (mlp_any_width or dim % 128 == 0):
                x = _mlp_fused(cfg, {**blk, **wt}, x)
            else:
                x = _mlp_unfused(cfg, blk, x)

        with span("ivit.head"):
            y = _norm_site(cfg, x, p["lnf_bias_int"], p["lnf_shift"],
                           p["m_lnf"], kernels)
            # exact-int average pool: two-limb int32 token sum, correctly
            # rounded divide by the token count, round once
            y = torch.round(rdiv(exact_int_sum(y.float().transpose(1, 2)),
                                 float(y.shape[1])))
            y = _requant(y[..., 0], p["m_pool"], 8)
            acc = _gemm_bias(y, p["head_w"], p["head_b"])
            return acc.float() * p["head_scale"]
