"""Plain reference of the integer-only Swin forward (Swin, Liu et al.,
arXiv:2103.14030; I-ViT's integer Swin, arXiv:2207.01405): f32 NHWC images
-> f32 logits, one torch operation after another, from the benchmark's own
spec tree.

The patch GEMM, the patch LayerNorm and the 16-bit residual stream; each
block's LayerNorm, the (shifted) window partition, qkv, scores plus the
relative-position addend and the shift mask, softmax, P.V, proj, the
window reverse and residual, then the MLP half; PatchMerging between
stages; the final LayerNorm, the exact integer average pool and the head.
It runs no kernel and knows nothing of the program's paths.
"""

from __future__ import annotations

import torch

from . import common as c
from . import intops as io


def _windows(x, B, res, dim, ws, shift):
    xw = x.reshape(B, res, res, dim)
    if shift:
        xw = torch.roll(xw, (-shift, -shift), (1, 2))
    xw = xw.reshape(B, res // ws, ws, res // ws, ws, dim).permute(0, 1, 3, 2, 4, 5)
    return xw.reshape(-1, ws * ws, dim)


def _unwindows(yw, B, res, dim, ws, shift):
    y = yw.reshape(B, res // ws, res // ws, ws, ws, dim).permute(0, 1, 3, 2, 4, 5)
    y = y.reshape(B, res, res, dim)
    if shift:
        y = torch.roll(y, (shift, shift), (1, 2))
    return y.reshape(B, res * res, dim)


def _block(cfg, fam, fast, blk, x, B, res, dim, heads, ws, shift):
    n, dh = ws * ws, dim // heads
    y = c.layernorm(fam, x, blk["ln1_bias_int"], blk["ln1_shift"], blk["m_ln1"])
    yw = _windows(y, B, res, dim, ws, shift)
    qkv = c.gemm_requant(yw, blk["qkv_w"], blk["qkv_b"], blk["m_qkv"], 8)
    qkv = qkv.reshape(-1, n, 3, heads, dh)
    q = qkv[:, :, 0].permute(0, 2, 1, 3)
    k = qkv[:, :, 1].permute(0, 2, 3, 1)
    v = qkv[:, :, 2].permute(0, 2, 1, 3)
    scores = c.requant(c.matmul(q, k), blk["m_attn"], 8)
    attn = torch.clamp(torch.round(scores * blk["m_attn2"])
                       + blk["rel_bias_addend"][None], -128, 127)
    if shift:
        nw = (res // ws) ** 2
        attn = (attn.reshape(B, nw, heads, n, n)
                + blk["mask_int"][None, :, None]).reshape(-1, heads, n, n)
    probs = c.softmax(fam, blk, attn, 8, fast)
    ctx = c.requant(c.matmul(probs, v), blk["m_av"], 8)
    ctx = ctx.permute(0, 2, 1, 3).reshape(-1, n, dim)
    yo = c.gemm_requant(ctx, blk["proj_w"], blk["proj_b"], blk["m_proj"], 16)
    yo = _unwindows(yo, B, res, dim, ws, shift)
    x = c.residual(yo, blk["m_res1_x"], x, blk["m_res1_id"], 16)

    y = c.layernorm(fam, x, blk["ln2_bias_int"], blk["ln2_shift"], blk["m_ln2"])
    h = c.gemm_requant(y, blk["fc1_w"], blk["fc1_b"], blk["m_fc1"], 8)
    y = c.gemm_requant(c.gelu(fam, blk, h, fast), blk["fc2_w"], blk["fc2_b"],
                       blk["m_fc2"], 8)
    return c.residual(y, blk["m_res2_x"], x, blk["m_res2_id"], 16)


def _merge(fam, mg, x, B, res, dim):
    xm = x.reshape(B, res, res, dim)
    xm = torch.cat([xm[:, 0::2, 0::2], xm[:, 1::2, 0::2],
                    xm[:, 0::2, 1::2], xm[:, 1::2, 1::2]], dim=-1)
    y = c.layernorm(fam, xm.reshape(B, -1, 4 * dim), mg["norm_bias_int"],
                    mg["norm_shift"], mg["m_norm"])
    return c.requant(c.matmul(y, mg["red_w"]), mg["m_red"], 8)


def forward(cfg, p, images):
    """``cfg``: the configuration's dict (with the spec maker's flags and
    ``layout``); ``p``: the spec tree as tensors on the images' device."""
    fam = c.families(cfg)
    fast = {"fast_exp": cfg["fast_exp"], "fast_poly": cfg["fast_poly"]}
    B = images.shape[0]
    pt = p["patch"]
    x = c.gemm_requant(c.input_patches(p, images, cfg["patch_size"]),
                       pt["w"], pt["b"], pt["m"], 8)
    x = c.layernorm(fam, x, pt["pn_bias_int"], pt["pn_shift"], pt["m_norm"])
    x = torch.clamp(torch.round(x * pt["m_x0"]), -(2.0**15), 2.0**15 - 1)
    res, dim = cfg["img_size"] // cfg["patch_size"], cfg["embed_dim"]
    for (kind, stage, shift), blk in zip(cfg["layout"], p["blocks"]):
        if kind == "merge":
            x = _merge(fam, blk["merge"], x, B, res, dim)
            res, dim = res // 2, dim * 2
            continue
        ws = min(cfg["window_size"], res)
        x = _block(cfg, fam, fast, blk, x, B, res, dim, cfg["stage_heads"][stage],
                   ws, shift)
    y = c.layernorm(fam, x, p["lnf_bias_int"], p["lnf_shift"], p["m_lnf"])
    pooled = torch.round(io.rdiv(io.int_sum(y.transpose(1, 2)), float(y.shape[1])))
    return c.head(p, c.requant(pooled[..., 0], p["m_pool"], 8))


def blocks(cfg, batch):
    """The shapes each block's two halves work on in one forward of
    ``batch`` images (what the roofline counts read): windows of ``n``
    tokens, the int8 stream into the first block after a merge, int16
    elsewhere."""
    out, merged = [], False
    grid = cfg["img_size"] // cfg["patch_size"]
    for kind, stage, shift in cfg["layout"]:
        if kind == "merge":
            merged = True
            continue
        res = grid >> stage
        ws = min(cfg["window_size"], res)
        dim = cfg["embed_dim"] * 2 ** stage
        nw = (res // ws) ** 2
        out.append(dict(attn="swin_attn_block", seqs=batch * nw, n=ws * ws, dim=dim,
                        heads=cfg["stage_heads"][stage],
                        hidden=int(dim * cfg["mlp_ratio"]), attn_in=1 if merged else 2,
                        attn_out=2, mlp_in=2, mlp_out=2, masked=nw if shift else 0))
        merged = False
    return out


def macs_per_image(cfg):
    """Multiply-accumulates of every matrix product of one image's forward:
    the patch embedding, qkv, scores, P.V, proj, fc1, fc2, each
    PatchMerging's reduction and the head."""
    grid = cfg["img_size"] // cfg["patch_size"]
    macs = grid * grid * cfg["patch_size"] ** 2 * 3 * cfg["embed_dim"]
    for blk in blocks(cfg, 1):
        rows, C = blk["seqs"] * blk["n"], blk["dim"]
        macs += rows * (4 * C * C + 2 * blk["n"] * C + 2 * C * blk["hidden"])
    for kind, stage, _ in cfg["layout"]:
        if kind == "merge":
            dim = cfg["embed_dim"] * 2 ** stage
            macs += (grid >> (stage + 1)) ** 2 * 4 * dim * 2 * dim
    last = cfg["embed_dim"] * 2 ** (len(cfg["depths"]) - 1)
    return macs + last * cfg["num_classes"]
