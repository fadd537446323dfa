"""Plain reference of the integer-only ViT/DeiT forward (I-ViT, Li and Gu,
arXiv:2207.01405; I-BERT's nonlinearities, arXiv:2101.01321): f32 NHWC
images -> f32 logits, one torch operation after another, from the
benchmark's own spec tree.

The patch embedding, the class token and positional addend, each block's
LayerNorm -> qkv -> scores -> softmax -> P.V -> proj -> residual, then
LayerNorm -> fc1 -> GELU -> fc2 -> residual, the final LayerNorm of the
class row and the head: every GEMM an exact integer product, every
activation requanted by its frozen multiplier.  It runs no kernel and
knows nothing of the program's paths, layouts or hoisted weights.
"""

from __future__ import annotations

import torch

from . import common as c


def forward(cfg, p, images):
    """``cfg``: the configuration's dict (with the spec maker's flags);
    ``p``: the spec tree as tensors on the images' device."""
    fam = c.families(cfg)
    fast = {"fast_exp": cfg["fast_exp"], "fast_poly": cfg["fast_poly"]}
    bw = cfg["bits"]
    B = images.shape[0]
    C, H = cfg["embed_dim"], cfg["num_heads"]
    Dh = C // H
    x = c.gemm_requant(c.input_patches(p, images, cfg["patch_size"]),
                       p["patch"]["w"], p["patch"]["b"], p["patch"]["m"],
                       bw["patch_embed"])
    x = torch.cat([p["cls_int"].expand(B, 1, C), x], dim=1)
    lim = 2.0 ** (bw["block_input"] - 1)
    x = torch.clamp(torch.round(x * p["m_x0"]) + p["pos_addend"], -lim, lim - 1)
    N = x.shape[1]
    for blk in p["blocks"]:
        y = c.layernorm(fam, x, blk["ln1_bias_int"], blk["ln1_shift"], blk["m_ln1"])
        qkv = c.gemm_requant(y, blk["qkv_w"], blk["qkv_b"], blk["m_qkv"], 8)
        qkv = qkv.reshape(B, N, 3, H, Dh)
        q = qkv[:, :, 0].permute(0, 2, 1, 3)
        k = qkv[:, :, 1].permute(0, 2, 3, 1)
        v = qkv[:, :, 2].permute(0, 2, 1, 3)
        scores = c.requant(c.matmul(q, k), blk["m_attn"], 8)
        probs = c.softmax(fam, blk, scores, bw["softmax"], fast)
        ctx = c.requant(c.matmul(probs, v), blk["m_av"], 8)
        ctx = ctx.permute(0, 2, 1, 3).reshape(B, N, C)
        y = c.gemm_requant(ctx, blk["proj_w"], blk["proj_b"], blk["m_proj"],
                           bw["attention_out"])
        x = c.residual(y, blk["m_res1_x"], x, blk["m_res1_id"], bw["norm2_in"])

        y = c.layernorm(fam, x, blk["ln2_bias_int"], blk["ln2_shift"], blk["m_ln2"])
        h = c.gemm_requant(y, blk["fc1_w"], blk["fc1_b"], blk["m_fc1"], 8)
        g = c.gelu(fam, blk, h, fast)
        y = c.gemm_requant(g, blk["fc2_w"], blk["fc2_b"], blk["m_fc2"], bw["mlp_out"])
        x = c.residual(y, blk["m_res2_x"], x, blk["m_res2_id"], bw["att_block_out"])

    y = c.layernorm(fam, x[:, :1], p["lnf_bias_int"], p["lnf_shift"], p["m_lnf"])
    return c.head(p, y[:, 0])


def blocks(cfg, batch):
    """The shapes each block's two halves work on in one forward of
    ``batch`` images (what the roofline counts read)."""
    C = cfg["embed_dim"]
    n = (cfg["img_size"] // cfg["patch_size"]) ** 2 + 1
    bw = cfg["bits"]
    nbytes = lambda b: 1 if b <= 8 else 2                      # noqa: E731
    out = []
    for i in range(cfg["depth"]):
        x_bits = bw["block_input"] if i == 0 else bw["att_block_out"]
        out.append(dict(attn="attn_block", seqs=batch, n=n, dim=C,
                        heads=cfg["num_heads"], hidden=int(C * cfg["mlp_ratio"]),
                        attn_in=nbytes(x_bits), attn_out=nbytes(bw["norm2_in"]),
                        mlp_in=nbytes(bw["norm2_in"]),
                        mlp_out=nbytes(bw["att_block_out"]), masked=0))
    return out


def macs_per_image(cfg):
    """Multiply-accumulates of every matrix product of one image's forward:
    the patch embedding, qkv, scores, P.V, proj, fc1, fc2 and the head."""
    C = cfg["embed_dim"]
    g = cfg["img_size"] // cfg["patch_size"]
    n = g * g + 1
    hidden = int(C * cfg["mlp_ratio"])
    per_block = n * C * 3 * C + 2 * n * n * C + n * C * C + 2 * n * C * hidden
    return (g * g * cfg["patch_size"] ** 2 * 3 * C + cfg["depth"] * per_block
            + C * cfg["num_classes"])
