"""The quantized ViT/DeiT of the QAT sim (counterpart of
``ivit_tpu/models/vit.py``).

Every edge is a ``(tensor, scaling_factor)`` pair; the residual adds happen
inside ``QuantAct``'s identity branch (an integer-domain requant-add); the
attention head scale ``head_dim**-0.5`` is folded into the scaling factor.
Inputs are NHWC ``[B, img, img, 3]``, as the port's ``Engine`` takes them.

The model is built on ``cuda`` unless ``device=`` says otherwise (raising
without a card): its parameters are drawn on the CPU from a seeded
``torch.Generator``, so a seed gives the same model on either device, and
then moved.  ``forward(x, running_stat=True)`` calibrates (updates the
range buffers in place), ``running_stat=False`` evaluates with the frozen
ranges; ``train=True`` turns dropout and drop-path on, drawn from the
``generator`` the caller passes.

On a rank mesh (``parallel.shard_module``) the forward takes this rank's
rows of the batch, its heads and hidden columns; it makes the mesh active
(``parallel.collectives``), and draws every dropout and drop-path mask at
the global shape, keeping this rank's rows and head or hidden slice, so
that a sharded step draws the single-device step's masks.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn

from .. import resolve_device
from ..ops.quant import true_divide
from ..parallel import collectives as coll
from . import registry
from .layers import (QuantAct, QuantConv2d, QuantLinear, exact_f32, quant_matmul,
                     trunc_normal_init)


@dataclasses.dataclass(frozen=True)
class BitWidths:
    """The 8-position bitwidth vector (ref quant_train.py:151-157,295-319)."""

    patch_embed: int = 8
    pos_encoding: int = 8
    block_input: int = 8
    attention_out: int = 8
    softmax: int = 8
    mlp_out: int = 8
    norm2_in: int = 8
    att_block_out: int = 8

    @classmethod
    def from_spec(cls, spec) -> "BitWidths":
        """Parse ``8`` / ``"8"`` / ``"8,8,8,8,16,8,16,8"`` (the reference's
        INT16 run) or pass a ``BitWidths`` through."""
        if isinstance(spec, BitWidths):
            return spec
        parts = [int(p) for p in str(spec).split(",")]
        if len(parts) == 1:
            return cls(*(parts * 8))
        if len(parts) != 8:
            raise ValueError(f"bitwidth spec needs 1 or 8 values, got {spec!r}")
        return cls(*parts)

    def to_list(self) -> Sequence[int]:
        return [self.patch_embed, self.pos_encoding, self.block_input,
                self.attention_out, self.softmax, self.mlp_out,
                self.norm2_in, self.att_block_out]


def _uniform(shape, generator, device, model_dim=None):
    """Uniform draws from ``generator`` on its own device, then moved to
    ``device``: a CPU generator gives the same masks to a sim on the card
    as to its twin on the CPU.  On a rank mesh the draw is at the global
    shape (the batch over the data axis, ``model_dim`` over the model
    axis) and this rank's block of it is kept."""
    mesh = coll.active()
    if mesh is None:
        return torch.rand(shape, generator=generator,
                          device=generator.device).to(device)
    full = list(shape)
    full[0] *= mesh.dp
    if model_dim is not None:
        full[model_dim] *= mesh.tp
    u = torch.rand(full, generator=generator, device=generator.device)
    u = u.narrow(0, mesh.data_index * shape[0], shape[0])
    if model_dim is not None:
        u = u.narrow(model_dim, mesh.model_index * shape[model_dim], shape[model_dim])
    return u.to(device)


def _dropout(x, rate: float, train: bool, generator, model_dim=None):
    """flax ``nn.Dropout``: keep with probability ``1 - rate``, scaled;
    ``model_dim``: the axis cut over the model axis on a mesh."""
    if rate == 0.0 or not train:
        return x
    if generator is None:
        raise ValueError("dropout in training needs a torch.Generator")
    keep = _uniform(x.shape, generator, x.device, model_dim) < 1.0 - rate
    return torch.where(keep, true_divide(x, 1.0 - rate), torch.zeros_like(x))


class DropPath(nn.Module):
    """Per-sample stochastic depth (``vit.py:61``)."""

    def __init__(self, drop_prob: float = 0.0):
        super().__init__()
        self.drop_prob = drop_prob

    def forward(self, x, *, train: bool = False, generator=None):
        if self.drop_prob == 0.0 or not train:
            return x
        if generator is None:
            raise ValueError("drop-path in training needs a torch.Generator")
        keep_prob = 1.0 - self.drop_prob
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        mask = torch.floor(keep_prob + _uniform(shape, generator, x.device))
        return true_divide(x, keep_prob) * mask


class Mlp(nn.Module):
    """fc1 -> GELU family -> fc2, through QuantActs (``vit.py:79``)."""

    def __init__(self, in_features: int, hidden_features: int, out_features: int,
                 act_factory, drop: float = 0.0, bitwidth_out: int = 8):
        super().__init__()
        self.drop = drop
        self.fc1 = QuantLinear(in_features, hidden_features)
        self.qact_gelu = QuantAct()
        self.act = act_factory()
        self.qact1 = QuantAct()
        self.fc2 = QuantLinear(hidden_features, out_features)
        self.qact2 = QuantAct(bitwidth_out)

    def forward(self, x, act_scaling_factor, *, running_stat=False, train=False,
                generator=None):
        x, s = self.fc1(x, act_scaling_factor)
        x, s = self.qact_gelu(x, s, running_stat=running_stat)
        x, s = self.act(x, s, running_stat=running_stat)
        x, s = self.qact1(x, s, running_stat=running_stat)
        x = _dropout(x, self.drop, train, generator, model_dim=x.ndim - 1)
        x, s = self.fc2(x, s)
        x, s = self.qact2(x, s, running_stat=running_stat)
        return _dropout(x, self.drop, train, generator), s


class PatchEmbed(nn.Module):
    """Image -> patch tokens through a strided QuantConv2d (``vit.py:101``);
    with ``norm_factory`` (Swin) a LayerNorm after the projection."""

    def __init__(self, patch_size: int = 16, embed_dim: int = 768,
                 bitwidth_out: int = 8, norm_factory=None, in_chans: int = 3):
        super().__init__()
        p = patch_size
        self.proj = QuantConv2d(in_chans, embed_dim, (p, p), (p, p))
        if norm_factory is not None:
            self.qact_before_norm = QuantAct()
            self.norm = norm_factory(embed_dim)
        self.has_norm = norm_factory is not None
        self.qact = QuantAct(bitwidth_out)

    def forward(self, x, act_scaling_factor, *, running_stat=False):
        if x.ndim != 4 or x.shape[-1] not in (1, 3):
            raise ValueError(
                f"PatchEmbed expects NHWC input [B, H, W, C]; got {tuple(x.shape)}. "
                "(Torch-style NCHW must be transposed to channels-last.)")
        x, s = self.proj(x, act_scaling_factor)
        b, h, w, c = x.shape
        x = x.reshape(b, h * w, c)
        if self.has_norm:
            x, s = self.qact_before_norm(x, s, running_stat=running_stat)
            x, s, x_int = self.norm(x, s, running_stat=running_stat)
            return self.qact(x, s, running_stat=running_stat, exact_int=x_int)
        return self.qact(x, s, running_stat=running_stat)


class Attention(nn.Module):
    """Integer multi-head attention (``vit.py:128``)."""

    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = False,
                 qk_scale=None, attn_drop: float = 0.0, proj_drop: float = 0.0,
                 bitwidth_out: int = 8, softmax_factory=None):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.scale = qk_scale or (dim // num_heads) ** -0.5
        self.attn_drop, self.proj_drop = attn_drop, proj_drop
        self.qkv = QuantLinear(dim, dim * 3, use_bias=qkv_bias)
        self.qact1 = QuantAct()
        self.qact_attn1 = QuantAct()
        self.int_softmax = softmax_factory()
        self.qact2 = QuantAct()
        self.proj = QuantLinear(dim, dim)
        self.qact3 = QuantAct(bitwidth_out)

    def forward(self, x, act_scaling_factor, *, running_stat=False, train=False,
                generator=None):
        b, n, c = x.shape
        x, s = self.qkv(x, act_scaling_factor)
        x, s1 = self.qact1(x, s, running_stat=running_stat)
        # -1: this rank's heads on a tensor-parallel mesh
        qkv = x.reshape(b, n, 3, -1, self.dim // self.num_heads)
        q_, k_, v_ = qkv.permute(2, 0, 3, 1, 4)              # [B, H, N, Dh] each
        attn, s = quant_matmul(q_, s1, k_.transpose(-2, -1), s1)
        # head scale folded into the scaling factor (vit_quant.py:74-75)
        attn = attn * self.scale
        s = s * self.scale
        attn, s = self.qact_attn1(attn, s, running_stat=running_stat)
        attn, s = self.int_softmax(attn, s, running_stat=running_stat)
        attn = _dropout(attn, self.attn_drop, train, generator, model_dim=1)
        x, s = quant_matmul(attn, s, v_, s1)
        x = x.transpose(1, 2).reshape(b, n, -1)
        x, s = self.qact2(x, s, running_stat=running_stat)
        x, s = self.proj(x, s)
        x, s = self.qact3(x, s, running_stat=running_stat)
        return _dropout(x, self.proj_drop, train, generator), s


class Block(nn.Module):
    """Pre-norm transformer block with integer residual adds (``vit.py:172``)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = False, qk_scale=None, drop: float = 0.0,
                 attn_drop: float = 0.0, drop_path: float = 0.0,
                 gelu_factory=None, softmax_factory=None, norm_factory=None,
                 attention_out_bw: int = 8, mlp_out_bw: int = 8,
                 norm2_in_bw: int = 8, att_block_out_bw: int = 8):
        super().__init__()
        self.norm1 = norm_factory(dim)
        self.qact1 = QuantAct()
        self.attn = Attention(dim, num_heads=num_heads, qkv_bias=qkv_bias,
                              qk_scale=qk_scale, attn_drop=attn_drop,
                              proj_drop=drop, bitwidth_out=attention_out_bw,
                              softmax_factory=softmax_factory)
        self.drop_path = DropPath(drop_path)
        self.qact2 = QuantAct(norm2_in_bw)
        self.norm2 = norm_factory(dim)
        self.qact3 = QuantAct()
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, act_factory=gelu_factory,
                       drop=drop, bitwidth_out=mlp_out_bw)
        self.drop_path2 = DropPath(drop_path)
        self.qact4 = QuantAct(att_block_out_bw)

    def forward(self, x_1, s_1, *, running_stat=False, train=False, generator=None):
        rs, kw = running_stat, dict(train=train, generator=generator)
        x, s, x_int = self.norm1(x_1, s_1, running_stat=rs)
        x, s = self.qact1(x, s, running_stat=rs, exact_int=x_int)
        x, s = self.attn(x, s, running_stat=rs, **kw)
        x = self.drop_path(x, **kw)
        # residual add #1: integer-domain identity-fused requant (vit:147)
        x_2, s_2 = self.qact2(x, s, identity=x_1, identity_scale=s_1,
                              running_stat=rs)
        x, s, x_int = self.norm2(x_2, s_2, running_stat=rs)
        x, s = self.qact3(x, s, running_stat=rs, exact_int=x_int)
        x, s = self.mlp(x, s, running_stat=rs, **kw)
        x = self.drop_path2(x, **kw)
        # residual add #2 (vit:153)
        return self.qact4(x, s, identity=x_2, identity_scale=s_2, running_stat=rs)


class VisionTransformer(nn.Module):
    """Quantized ViT/DeiT (``vit.py:227``): NHWC images in, float logits
    out.  ``device``: where the model lives (default ``cuda``); ``seed``:
    the ``torch.Generator`` seed of its initial parameters (flax's
    initializers: truncated normal 0.02 for the kernels, the cls token and
    the positional embedding, zero biases, unit LayerNorm weights)."""

    def __init__(self, img_size: int = 224, patch_size: int = 16,
                 num_classes: int = 1000, embed_dim: int = 768, depth: int = 12,
                 num_heads: int = 12, mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 qk_scale=None, drop_rate: float = 0.0, attn_drop_rate: float = 0.0,
                 drop_path_rate: float = 0.0, bitwidths=BitWidths(),
                 gelu_type: str = "ivit", softmax_type: str = "ivit",
                 layernorm_type: str = "ivit", device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        bw = self.bitwidths = BitWidths.from_spec(bitwidths)
        self.img_size, self.patch_size = img_size, patch_size
        self.num_classes, self.embed_dim, self.depth = num_classes, embed_dim, depth
        self.num_heads, self.mlp_ratio, self.qk_scale = num_heads, mlp_ratio, qk_scale
        self.drop_rate = drop_rate
        self.gelu_type, self.softmax_type = gelu_type, softmax_type
        self.layernorm_type = layernorm_type
        gelu_factory = registry.get_gelu(gelu_type)
        softmax_factory = registry.get_softmax(softmax_type, bw.softmax)
        norm_factory = registry.get_layernorm(layernorm_type)
        num_patches = (img_size // patch_size) ** 2

        self.qact_input = QuantAct()
        self.patch_embed = PatchEmbed(patch_size, embed_dim, bw.patch_embed)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, num_patches + 1, embed_dim))
        self.qact_pos = QuantAct(bw.pos_encoding)
        self.qact1 = QuantAct(bw.block_input)
        dpr = [float(r) for r in np.linspace(0, drop_path_rate, depth)]
        self.blocks = nn.ModuleList(Block(
            embed_dim, num_heads, mlp_ratio=mlp_ratio, qkv_bias=qkv_bias,
            qk_scale=qk_scale, drop=drop_rate, attn_drop=attn_drop_rate,
            drop_path=dpr[i], gelu_factory=gelu_factory,
            softmax_factory=softmax_factory, norm_factory=norm_factory,
            attention_out_bw=bw.attention_out, mlp_out_bw=bw.mlp_out,
            norm2_in_bw=bw.norm2_in, att_block_out_bw=bw.att_block_out)
            for i in range(depth))
        self.norm = norm_factory(embed_dim)
        self.qact2 = QuantAct()
        self.head = QuantLinear(embed_dim, num_classes)
        gen = torch.Generator().manual_seed(seed)
        for name, p in self.named_parameters():
            if name.rsplit(".", 1)[-1] in ("kernel", "cls_token", "pos_embed"):
                trunc_normal_init(p, 0.02, gen)
        self.to(dev)
        self.mesh = None        # a rank mesh: parallel.shard_module

    @property
    def device(self) -> torch.device:
        return self.cls_token.device

    def embed(self, x, *, running_stat=False):
        """The input quant, the patch embedding, the cls token (sharing the
        patch scale, vit:290-293) and the positional add."""
        b = x.shape[0]
        x, s = self.qact_input(x, running_stat=running_stat)
        x, s = self.patch_embed(x, s, running_stat=running_stat)
        x = torch.cat([self.cls_token.expand(b, 1, self.embed_dim), x], dim=1)
        x_pos, s_pos = self.qact_pos(self.pos_embed, running_stat=running_stat)
        return self.qact1(x, s, identity=x_pos.expand_as(x), identity_scale=s_pos,
                          running_stat=running_stat)

    def tail(self, x, s, *, running_stat=False):
        """The final LN on the cls row and the head."""
        x, s, x_int = self.norm(x, s, running_stat=running_stat)
        x, s = self.qact2(x[:, 0], s, running_stat=running_stat,
                          exact_int=x_int[:, 0])
        return self.head(x, s)[0]

    def forward(self, x, *, running_stat: bool = False, train: bool = False,
                generator=None):
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        kw = dict(train=train, generator=generator)
        with exact_f32(), coll.use(self.mesh):
            x, s = self.embed(x, running_stat=running_stat)
            x = _dropout(x, self.drop_rate, train, generator)
            for blk in self.blocks:
                x, s = blk(x, s, running_stat=running_stat, **kw)
            return self.tail(x, s, running_stat=running_stat)
