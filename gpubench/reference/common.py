"""Pieces the plain ViT and Swin references share: the integer GEMM, the
requants, the LayerNorm and the two nonlinearities by family, on a spec
tree of tensors."""

from __future__ import annotations

import numpy as np
import torch

from . import intops as io


def tensors(tree, device):
    """The benchmark's numpy spec tree as tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: tensors(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tensors(v, device) for v in tree]
    return torch.from_numpy(np.array(tree, order="C")).to(device)


def matmul(a, w):
    """Exact integer product over the last axis, int32 out: float64 holds
    every partial sum of int8 products exactly."""
    return torch.round(a.double() @ w.double()).to(torch.int32)


def requant(acc, m, bits):
    lim = 2.0 ** (bits - 1)
    return torch.clamp(torch.round(acc.float() * m), -lim, lim - 1)


def gemm_requant(x, w, b, m, bits):
    return requant(matmul(x, w) + b, m, bits)


def residual(y, my, x, mx, bits):
    lim = 2.0 ** (bits - 1)
    return torch.clamp(torch.round(y * my) + torch.round(x * mx), -lim, lim - 1)


def layernorm(fam, x, bias_int, shift, m):
    """The integer LayerNorm of the family, its frozen bias, the requant to
    int8 (a zero-variance row's NaN pinned to 0 first)."""
    if fam["ln"] == "ivit":
        y = io.ivit_layernorm(x) + bias_int
    else:
        y = io.ibert_layernorm(x, shift) + bias_int
    y = torch.where(torch.isnan(y), torch.zeros_like(y), y)
    return requant(y, m, 8)


def softmax(fam, blk, scores, bits, fast):
    """Integer scores -> probabilities at ``bits``, by softmax family."""
    if fam["softmax"] == "ivit":
        p = io.shiftmax(scores, blk["s_attn"], bits, fast_q=fast["fast_exp"])
    else:
        p = io.ibert_softmax(scores, blk["s_attn"], blk["s_exp_act"], bits,
                             fast["fast_exp"], fast["fast_poly"])
    return torch.clamp(p, -(2.0 ** (bits - 1)), 2.0 ** (bits - 1) - 1)


def gelu(fam, blk, h, fast):
    """The GELU of the family on the fc1 integers, requanted to int8."""
    if fam["gelu"] == "ivit":
        y = io.shift_gelu(h, blk["s_gelu"], fast_q=fast["fast_exp"])
    else:
        y = io.ibert_gelu(h, blk["s_gelu"], fast_poly=fast["fast_poly"])
    return requant(y, blk["m_gelu"], 8)


def families(cfg):
    fam = {"softmax": cfg["softmax_type"], "gelu": cfg["gelu_type"],
           "ln": cfg["layernorm_type"]}
    for which, base in fam.items():
        if base not in ("ivit", "ibert"):
            raise NotImplementedError(f"the reference runs the ivit and ibert "
                                      f"families; {which} is {base!r}")
    return fam


def head(p, y):
    """The classifier on int8 features: f32 logits."""
    return (matmul(y, p["head_w"]) + p["head_b"]).float() * p["head_scale"]


def input_patches(p, images, ps):
    """Input quant of f32 NHWC images, cut into flattened patches."""
    B, H, W, _ = images.shape
    g = H // ps
    x = torch.clamp(torch.round(io.rdiv(images, p["s_input"])), -128, 127)
    x = x.reshape(B, g, ps, g, ps, 3).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, g * g, ps * ps * 3)
