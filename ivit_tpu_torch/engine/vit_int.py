"""Integer-only ViT forward (counterpart of ``ivit_tpu/engine/vit_int.py``).

Two paths, bit-identical to each other and to the JAX engine:

* ``kernels=True`` (the JAX fused branch, ``vit_int.py:527-596``): each
  block is one :func:`~ivit_tpu_torch.ops.kernels.block.attn_block` and one
  :func:`~ivit_tpu_torch.ops.kernels.block.mlp_block` call -- the CUDA
  kernels for tensors on the card, their plain versions on the CPU;
* ``kernels=False`` (the JAX unfused branch, ``vit_int.py:598-655``): the
  plain per-op engine on either device, the reference the kernels are held
  against on the card.

The patch-embed and head GEMMs, the input quant and the final cls-row LN
run outside any kernel in both, as in the JAX package.  The JAX fused
branch pads tokens to a multiple of 8 for the TPU's tiles; the port runs
the ``N`` real tokens unpadded.  This slice ports the ibert family; the
ivit, ppoly and float branches raise.
"""

from __future__ import annotations

import torch

from .. import resolve_device
from ..ops import ibert as ib
from ..ops.kernels import block as kblock
from ..ops.kernels.block import container as _container
from ..ops.kernels.block import int8_matmul
from ..ops.quant import exact_int_sum, rdiv
from .convert import params_to_torch
from .freeze import EngineConfig, EngineSpec


def _require_ibert(cfg: EngineConfig):
    for which in ("softmax", "gelu", "ln"):
        base = cfg.base_type(which)
        if base != "ibert":
            raise NotImplementedError(
                f"{which} family {base!r}: the port runs the ibert family; "
                "ivit and ppoly come with the next slices of ROADMAP Queue 1 "
                "items 2-4, float with the QAT sim (item 9)")


def _gemm_bias(a_int, w_int8, b_int32):
    """int8 GEMM (the operand wrapped to int8, as JAX's ``_dot_i8``) + bias."""
    return int8_matmul(a_int.to(torch.int8), w_int8) + b_int32


def _requant(acc, m, bits):
    """round(acc * m) clamped and stored in the ``bits`` container."""
    n = 2 ** (bits - 1) - 1
    y = torch.round(acc.float() * m)
    return torch.clamp(y, -n - 1, n).to(_container(bits))


def _ln_requant(y_int, m, bits):
    """Requant of the exact LayerNorm integer; a NaN (zero-variance row) is
    pinned to 0 first, as the kernels do, since NaN -> int is undefined."""
    y_int = torch.where(torch.isnan(y_int), torch.zeros_like(y_int), y_int)
    return _requant(y_int, m, bits)


def _softmax_int(cfg, blk, scores_int):
    """int8 scores -> probs in the softmax container (ibert family)."""
    bit = cfg.bitwidths.softmax
    exp_int, _ = ib.ibert_softmax_exp_int(scores_int.float(), blk["s_attn"],
                                          fast_q=cfg.fast_exp,
                                          fast_poly=cfg.fast_poly)
    # internal 16-bit QuantAct on the raw exp ints, multiply form
    exp16 = torch.clamp(torch.round(exp_int * rdiv(1.0, blk["s_exp_act"])),
                        -(2.0**15), 2.0**15 - 1)
    factor = torch.floor(rdiv(2.0**32, exact_int_sum(exp16)))
    return torch.floor(exp16 * factor / 2 ** (32 - bit + 1)).to(_container(bit))


def _gelu_requant_int(cfg, blk, x_int, out_bits):
    y, _ = ib.ibert_gelu_int(x_int.float(), blk["s_gelu"],
                             fast_poly=cfg.fast_poly)
    return _requant(y, blk["m_gelu"], out_bits)


def _layernorm_int(cfg, x_int, bias_int, shift):
    use_int_sqrt = bool(cfg.type_params("ln").get("use_int_sqrt", False))
    return ib.ibert_layernorm_int(x_int.float(), shift,
                                  use_int_sqrt=use_int_sqrt) + bias_int


def _residual_requant(y, my, xr, mx, bits):
    lim = 2.0 ** (bits - 1)
    raw = torch.round(y.float() * my) + torch.round(xr.float() * mx)
    return torch.clamp(raw, -lim, lim - 1).to(_container(bits))


def _attn_unfused(cfg, blk, x):
    bw = cfg.bitwidths
    B, N, C = x.shape
    H, Dh = cfg.num_heads, cfg.head_dim
    y = _layernorm_int(cfg, x, blk["ln1_bias_int"], blk["ln1_shift"])
    y = _ln_requant(y, blk["m_ln1"], 8)
    y = _requant(_gemm_bias(y, blk["qkv_w"], blk["qkv_b"]), blk["m_qkv"], 8)
    qkv = y.reshape(B, N, 3, H, Dh)
    q = qkv[:, :, 0].permute(0, 2, 1, 3)                     # [B, H, N, Dh]
    k = qkv[:, :, 1].permute(0, 2, 3, 1)                     # [B, H, Dh, N]
    v = qkv[:, :, 2].permute(0, 2, 1, 3)
    scores = _requant(int8_matmul(q, k), blk["m_attn"], 8)
    probs = _softmax_int(cfg, blk, scores)
    y = _requant(int8_matmul(probs, v), blk["m_av"], 8)                        # [B, H, N, Dh]
    y = y.permute(0, 2, 1, 3).reshape(B, N, C)
    y = _requant(_gemm_bias(y, blk["proj_w"], blk["proj_b"]), blk["m_proj"],
                 bw.attention_out)
    return _residual_requant(y, blk["m_res1_x"], x, blk["m_res1_id"],
                             bw.norm2_in)


def _mlp_unfused(cfg, blk, x):
    bw = cfg.bitwidths
    y = _layernorm_int(cfg, x, blk["ln2_bias_int"], blk["ln2_shift"])
    y = _ln_requant(y, blk["m_ln2"], 8)
    y = _requant(_gemm_bias(y, blk["fc1_w"], blk["fc1_b"]), blk["m_fc1"], 8)
    y = _gelu_requant_int(cfg, blk, y, 8)
    y = _requant(_gemm_bias(y, blk["fc2_w"], blk["fc2_b"]), blk["m_fc2"],
                 bw.mlp_out)
    return _residual_requant(y, blk["m_res2_x"], x, blk["m_res2_id"],
                             bw.att_block_out)


def _attn_fused(cfg, blk, x):
    bw = cfg.bitwidths
    return kblock.attn_block(
        x, ln_bias=blk["ln1_bias_int"], m_ln=blk["m_ln1"],
        ln_shift=blk["ln1_shift"], qkv_w=blk["qkv_w"], qkv_b=blk["qkv_b"],
        m_qkv=blk["m_qkv"], m_attn=blk["m_attn"], s_attn=blk["s_attn"],
        s_exp_act=blk["s_exp_act"], m_av=blk["m_av"], proj_w=blk["proj_w"],
        proj_b=blk["proj_b"], m_proj=blk["m_proj"], m_res_x=blk["m_res1_x"],
        m_res_id=blk["m_res1_id"], num_heads=cfg.num_heads,
        n_valid=x.shape[1], sm_bit=bw.softmax, attn_bits=8,
        proj_bits=bw.attention_out, out_bits=bw.norm2_in,
        fast_exp=cfg.fast_exp, fast_poly=cfg.fast_poly,
        use_int_sqrt=bool(cfg.type_params("ln").get("use_int_sqrt", False)))


def _mlp_fused(cfg, blk, x):
    bw = cfg.bitwidths
    B, N, C = x.shape
    y = kblock.mlp_block(
        x.reshape(B * N, C), ln_bias=blk["ln2_bias_int"], m_ln=blk["m_ln2"],
        ln_shift=blk["ln2_shift"], fc1_w=blk["fc1_w"], fc1_b=blk["fc1_b"],
        m_fc1=blk["m_fc1"], s_gelu=blk["s_gelu"], m_gelu=blk["m_gelu"],
        fc2_w=blk["fc2_w"], fc2_b=blk["fc2_b"], m_fc2=blk["m_fc2"],
        m_res_x=blk["m_res2_x"], m_res_id=blk["m_res2_id"],
        mlp_bits=bw.mlp_out, out_bits=bw.att_block_out,
        fast_poly=cfg.fast_poly,
        use_int_sqrt=bool(cfg.type_params("ln").get("use_int_sqrt", False)))
    return y.reshape(B, N, C)


def engine_forward(spec: EngineSpec, images, kernels: bool = True,
                   device=None):
    """images: f32 NHWC [B, img, img, 3] -> f32 logits [B, classes].

    ``kernels``: the fused block kernels (True) or the unfused plain engine
    (False).  ``device``: where to run (default ``cuda``; raises without a
    card unless ``"cpu"``); params and images are moved there if needed.
    """
    dev = resolve_device(device)
    cfg = spec.config
    _require_ibert(cfg)
    p = params_to_torch(spec.params, dev)
    images = torch.as_tensor(images, dtype=torch.float32).to(dev)
    bw = cfg.bitwidths
    B = images.shape[0]
    ps = cfg.patch_size
    g = cfg.img_size // ps
    C = cfg.embed_dim

    with torch.no_grad():
        # input quantization (SymmetricQuantFunction on the raw image)
        x = torch.clamp(torch.round(rdiv(images, p["s_input"])), -128, 127)
        x = x.to(torch.int8).reshape(B, g, ps, g, ps, 3)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, g * g, ps * ps * 3)
        x = _requant(_gemm_bias(x, p["patch"]["w"], p["patch"]["b"]),
                     p["patch"]["m"], bw.patch_embed)

        # cls concat (shares the patch scale) + positional add at s_block0
        cls = p["cls_int"].to(torch.int32).expand(B, 1, C)
        x = torch.cat([cls, x.to(torch.int32)], dim=1)
        lim = 2.0 ** (bw.block_input - 1)
        x = torch.clamp(torch.round(x.float() * p["m_x0"]) + p["pos_addend"],
                        -lim, lim - 1).to(_container(bw.block_input))

        attn, mlp = (_attn_fused, _mlp_fused) if kernels else \
            (_attn_unfused, _mlp_unfused)
        for blk in p["blocks"]:
            x = mlp(cfg, blk, attn(cfg, blk, x))

        # final norm on the cls row only -> head
        y = _layernorm_int(cfg, x[:, :1], p["lnf_bias_int"], p["lnf_shift"])
        y = _ln_requant(y, p["m_lnf"], 8)[:, 0]
        acc = _gemm_bias(y, p["head_w"], p["head_b"])
        return acc.float() * p["head_scale"]


class Engine:
    """Callable integer inference engine for one frozen ViT spec.

    Moves the parameters to ``device`` once (default ``cuda``; raises
    without a card unless ``device="cpu"``) and runs :func:`engine_forward`
    on them.
    """

    def __init__(self, spec: EngineSpec, device=None, kernels: bool = True):
        self.device = resolve_device(device)
        _require_ibert(spec.config)
        self.spec = EngineSpec(spec.config,
                               params_to_torch(spec.params, self.device))
        self.kernels = kernels

    def __call__(self, images):
        return engine_forward(self.spec, images, kernels=self.kernels,
                              device=self.device)
