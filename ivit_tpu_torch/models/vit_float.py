"""Plain float Vision Transformers (counterpart of
``ivit_tpu/models/vit_float.py``): the unquantized ViT/DeiT and Swin, the
distillation teacher (``train/distill.py``) and the float baseline.

Module for module as flax's, under its names and layouts (``Dense``
kernels ``[in, out]``, the patch conv HWIO, LayerNorm ``scale`` / ``bias``
with flax's epsilon 1e-6 and its one-pass variance ``E[x^2] - E[x]^2`` in
f32), so that ``models/convert.py::variables_to_torch(model, {"params":
params})`` carries a JAX float model's parameters across leaf for leaf.  ``dtype`` is the compute type
(``torch.bfloat16`` by default, as JAX's ``jnp.bfloat16``): the parameters
stay f32 and are cast where flax casts them; LayerNorm statistics, the Swin
softmax and the head run in f32.  Plain ``torch`` products: the JAX
package runs these models outside any Pallas kernel.  Built on ``cuda``
unless ``device=`` says otherwise, parameters drawn on the CPU from
``seed`` with flax's initializers (``lecun_normal`` kernels, truncated
normal 0.02 embeddings and bias tables).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import resolve_device
from .layers import trunc_normal_init
from .swin import (_DeviceConst, attention_mask, relative_position_index,
                   window_partition, window_reverse)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``x @ kernel + bias`` in ``dtype``."""

    def __init__(self, in_features: int, out_features: int, use_bias: bool = True,
                 dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.zeros(in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if use_bias else None

    def forward(self, x):
        y = x.to(self.dtype) @ self.kernel.to(self.dtype)
        return y if self.bias is None else y + self.bias.to(self.dtype)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` (epsilon 1e-6, fast variance, f32 statistics),
    its output cast to ``dtype``."""

    def __init__(self, features: int, dtype=torch.bfloat16, eps: float = 1e-6):
        super().__init__()
        self.dtype, self.eps = dtype, eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        mu2 = (xf * xf).mean(-1, keepdim=True)
        var = torch.clamp(mu2 - mu * mu, min=0.0)
        y = (xf - mu) * (torch.rsqrt(var + self.eps) * self.scale)
        return (y + self.bias).to(self.dtype)


class PatchConv(nn.Module):
    """flax ``nn.Conv`` with a ``p x p`` kernel, stride ``p``, VALID: one GEMM
    over the unfolded patches (HWIO kernel); NHWC in and out."""

    def __init__(self, patch: int, in_chans: int, out: int, dtype=torch.bfloat16):
        super().__init__()
        self.patch, self.dtype = patch, dtype
        self.kernel = nn.Parameter(torch.zeros(patch, patch, in_chans, out))
        self.bias = nn.Parameter(torch.zeros(out))

    def forward(self, x):
        b, h, w, c = x.shape
        p = self.patch
        cols = x.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
        cols = cols.reshape(b, h // p, w // p, p * p * c).to(self.dtype)
        y = cols @ self.kernel.reshape(p * p * c, -1).to(self.dtype)
        return y + self.bias.to(self.dtype)


def _mlp(block, x):
    h = block.fc1(block.norm2(x))
    return x + block.fc2(F.gelu(h, approximate="none"))


class FloatBlock(nn.Module):
    """Pre-norm transformer block (``vit_float.py:19``)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 dtype=torch.bfloat16):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.norm1 = LayerNorm(dim, dtype)
        self.qkv = Dense(dim, 3 * dim, dtype=dtype)
        self.proj = Dense(dim, dim, dtype=dtype)
        self.norm2 = LayerNorm(dim, dtype)
        self.fc1 = Dense(dim, int(dim * mlp_ratio), dtype=dtype)
        self.fc2 = Dense(int(dim * mlp_ratio), dim, dtype=dtype)

    def forward(self, x):
        h = self.norm1(x)
        b, n, c = h.shape
        hd = self.dim // self.num_heads
        qkv = self.qkv(h).reshape(b, n, 3, self.num_heads, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = torch.softmax((q @ k.transpose(-2, -1)) * (hd ** -0.5), dim=-1)
        ctx = (attn @ v).transpose(1, 2).reshape(b, n, c)
        return _mlp(self, x + self.proj(ctx))


class FloatVisionTransformer(nn.Module):
    """Float ViT/DeiT (``vit_float.py:47``): NHWC images in, f32 logits out."""

    def __init__(self, img_size: int = 224, patch_size: int = 16,
                 num_classes: int = 1000, embed_dim: int = 768, depth: int = 12,
                 num_heads: int = 12, mlp_ratio: float = 4.0, dtype=torch.bfloat16,
                 device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.embed_dim, self.dtype = embed_dim, dtype
        n = (img_size // patch_size) ** 2
        self.patch_embed = PatchConv(patch_size, 3, embed_dim, dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, n + 1, embed_dim))
        self.blocks = nn.ModuleList(FloatBlock(embed_dim, num_heads, mlp_ratio, dtype)
                                    for _ in range(depth))
        self.norm = LayerNorm(embed_dim, dtype)
        self.head = Dense(embed_dim, num_classes, dtype=torch.float32)
        _init(self, seed, ("cls_token", "pos_embed"))
        self.to(dev)

    def forward(self, x):
        x = torch.as_tensor(x, dtype=torch.float32, device=self.cls_token.device)
        b = x.shape[0]
        x = self.patch_embed(x.to(self.dtype)).reshape(b, -1, self.embed_dim)
        cls = self.cls_token.expand(b, 1, self.embed_dim).to(self.dtype)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(self.dtype)
        for blk in self.blocks:
            x = blk(x)
        return self.head(self.norm(x)[:, 0].float())


def timm_state_dict(model: FloatVisionTransformer) -> dict:
    """The float ViT's parameters under timm's DeiT names and layouts (the
    files the reference's factories download): ``blocks.N.attn.qkv``,
    ``blocks.N.mlp.fc1``, LayerNorm ``weight``, linear weights ``[out,
    in]``, the patch conv OIHW; f32 CPU tensors."""
    out = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "blocks" and parts[2] in ("qkv", "proj"):
            parts.insert(2, "attn")
        elif parts[0] == "blocks" and parts[2] in ("fc1", "fc2"):
            parts.insert(2, "mlp")
        elif parts[0] == "patch_embed":
            parts.insert(1, "proj")
        t = p.detach().float().cpu()
        if parts[-1] == "scale":
            parts[-1] = "weight"
        elif parts[-1] == "kernel":
            parts[-1] = "weight"
            t = t.permute(3, 2, 0, 1) if t.dim() == 4 else t.t()
        out[".".join(parts)] = t.contiguous()
    return out


FLOAT_ARCHS = {
    "deit_tiny_patch16_224": dict(embed_dim=192, depth=12, num_heads=3),
    "deit_small_patch16_224": dict(embed_dim=384, depth=12, num_heads=6),
    "deit_base_patch16_224": dict(embed_dim=768, depth=12, num_heads=12),
    "vit_base_patch16_224": dict(embed_dim=768, depth=12, num_heads=12),
    "vit_large_patch16_224": dict(embed_dim=1024, depth=24, num_heads=16),
}


def float_model(name: str, **kw) -> FloatVisionTransformer:
    return FloatVisionTransformer(**{**FLOAT_ARCHS[name], **kw})


class FloatSwinBlock(nn.Module):
    """Float Swin block (``vit_float.py:92``): (shifted) window attention
    with the relative-position bias, softmax in f32."""

    def __init__(self, dim: int, num_heads: int, resolution: int, window_size: int,
                 shift: int, mlp_ratio: float = 4.0, dtype=torch.bfloat16):
        super().__init__()
        self.dim, self.num_heads, self.dtype = dim, num_heads, dtype
        self.resolution, self.window_size, self.shift = resolution, window_size, shift
        ws = window_size
        self.norm1 = LayerNorm(dim, dtype)
        self.qkv = Dense(dim, 3 * dim, dtype=dtype)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * ws - 1) ** 2, num_heads))
        self.rel_index = _DeviceConst(relative_position_index(ws).reshape(-1))
        self.mask = (_DeviceConst(attention_mask((resolution, resolution), ws, shift))
                     if shift > 0 else None)
        self.proj = Dense(dim, dim, dtype=dtype)
        self.norm2 = LayerNorm(dim, dtype)
        self.fc1 = Dense(dim, int(dim * mlp_ratio), dtype=dtype)
        self.fc2 = Dense(int(dim * mlp_ratio), dim, dtype=dtype)

    def forward(self, x):
        b, length, c = x.shape
        res, ws, sh = self.resolution, self.window_size, self.shift
        n, heads = ws * ws, self.num_heads
        hd = self.dim // heads
        h = self.norm1(x).reshape(b, res, res, c)
        if sh > 0:
            h = torch.roll(h, (-sh, -sh), (1, 2))
        qkv = self.qkv(window_partition(h, ws))
        q, k, v = qkv.reshape(-1, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
        attn = (q @ k.transpose(-2, -1)) * (hd ** -0.5)
        bias = self.relative_position_bias_table[self.rel_index.on(x.device)]
        attn = attn + bias.reshape(n, n, heads).permute(2, 0, 1)[None].to(self.dtype)
        if sh > 0:
            mask = self.mask.on(x.device).to(self.dtype)
            nw = mask.shape[0]
            attn = attn.reshape(b, nw, heads, n, n) + mask[None, :, None]
            attn = attn.reshape(-1, heads, n, n)
        attn = torch.softmax(attn.float(), dim=-1).to(self.dtype)
        ctx = (attn @ v).transpose(1, 2).reshape(-1, n, c)
        ctx = window_reverse(self.proj(ctx), ws, res, res)
        if sh > 0:
            ctx = torch.roll(ctx, (sh, sh), (1, 2))
        return _mlp(self, x + ctx.reshape(b, length, c))


class FloatSwinTransformer(nn.Module):
    """Float Swin (``vit_float.py:151``): NHWC images in, f32 logits out;
    the stage's blocks and merges are the flat children
    ``layers_{i}_blocks_{d}``, ``layers_{i}_downsample_norm`` and
    ``layers_{i}_downsample_reduction``, flax's names."""

    def __init__(self, img_size: int = 224, patch_size: int = 4,
                 num_classes: int = 1000, embed_dim: int = 96,
                 depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window_size: int = 7,
                 mlp_ratio: float = 4.0, dtype=torch.bfloat16, device=None,
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.embed_dim, self.dtype = embed_dim, dtype
        self.patch_embed = PatchConv(patch_size, 3, embed_dim, dtype)
        self.patch_norm = LayerNorm(embed_dim, dtype)
        self.stages = []
        res, dim = img_size // patch_size, embed_dim
        for i, (depth, heads) in enumerate(zip(depths, num_heads)):
            blocks = []
            for d in range(depth):
                ws = min(window_size, res)
                shift = 0 if (d % 2 == 0 or res <= window_size) else ws // 2
                blk = FloatSwinBlock(dim, heads, res, ws, shift, mlp_ratio, dtype)
                self.add_module(f"layers_{i}_blocks_{d}", blk)
                blocks.append(blk)
            merge = None
            if i < len(depths) - 1:
                norm = LayerNorm(4 * dim, dtype)
                reduction = Dense(4 * dim, 2 * dim, use_bias=False, dtype=dtype)
                self.add_module(f"layers_{i}_downsample_norm", norm)
                self.add_module(f"layers_{i}_downsample_reduction", reduction)
                merge = (norm, reduction, res, dim)
                res //= 2
                dim *= 2
            self.stages.append((blocks, merge))
        self.norm = LayerNorm(dim, dtype)
        self.head = Dense(dim, num_classes, dtype=torch.float32)
        _init(self, seed, ("relative_position_bias_table",))
        self.to(dev)

    def forward(self, x):
        x = torch.as_tensor(x, dtype=torch.float32, device=self.head.kernel.device)
        b = x.shape[0]
        x = self.patch_embed(x.to(self.dtype)).reshape(b, -1, self.embed_dim)
        x = self.patch_norm(x)
        for blocks, merge in self.stages:
            for blk in blocks:
                x = blk(x)
            if merge is not None:
                norm, reduction, res, dim = merge
                xm = x.reshape(b, res, res, dim)
                xm = torch.cat([xm[:, 0::2, 0::2], xm[:, 1::2, 0::2],
                                xm[:, 0::2, 1::2], xm[:, 1::2, 1::2]], dim=-1)
                x = reduction(norm(xm.reshape(b, -1, 4 * dim)))
        x = torch.mean(self.norm(x), dim=1)
        return self.head(x.float())


FLOAT_SWIN_ARCHS = {
    "swin_tiny_patch4_window7_224": dict(embed_dim=96, depths=(2, 2, 6, 2),
                                         num_heads=(3, 6, 12, 24)),
    "swin_small_patch4_window7_224": dict(embed_dim=96, depths=(2, 2, 18, 2),
                                          num_heads=(3, 6, 12, 24)),
}


def float_swin_model(name: str, **kw) -> FloatSwinTransformer:
    return FloatSwinTransformer(**{**FLOAT_SWIN_ARCHS[name], **kw})


def _init(model, seed: int, embeddings):
    """flax's initializers from a seeded generator: ``lecun_normal`` for
    every Dense and conv kernel (truncated normal, std ``1/sqrt(fan_in)``),
    truncated normal 0.02 for the named embeddings; zero biases, unit
    LayerNorm scales (as built)."""
    gen = torch.Generator().manual_seed(seed)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "kernel":
            fan_in = math.prod(p.shape[:-1])
            trunc_normal_init(p, fan_in ** -0.5, gen)
        elif leaf in embeddings:
            trunc_normal_init(p, 0.02, gen)

