"""The quantized Swin Transformer of the QAT sim (counterpart of
``ivit_tpu/models/swin.py``).

The geometry first: the relative-position index and the shift mask are
constants built in numpy (the freeze and the sim share them); the window
partition and its reverse are token permutations, in torch, of the sim's
activations and of the engine's integer stream.

Then the sim, module for module as JAX's and under the flax names, so that
``models/convert.py`` carries the variables across leaf for leaf (a
stage's blocks and its merge are the flat children ``layers_{i}_blocks_{d}``
and ``layers_{i}_downsample``): W-MSA with the relative-position bias table
quantized by ``qact_table`` and added through ``qact2``'s identity branch;
shifted windows (``torch.roll``, JAX's sign convention) with the 0/-100
mask snapped onto the score grid before the integer softmax; the 16-bit
residual QuantActs; PatchMerging's 2x2 concatenation, LN over 4C and
reduction; the exact-int average pool before the head.  Inputs are NHWC,
as for the ViT sim; the model lives on ``cuda`` unless ``device=`` says
otherwise, its parameters drawn on the CPU from ``seed``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn as nn

from .. import resolve_device
from ..ops import quant as q
from ..parallel import collectives as coll
from . import registry
from .layers import QuantAct, QuantLinear, exact_f32, quant_matmul, trunc_normal_init
from .vit import DropPath, Mlp, PatchEmbed


def window_partition(x, window_size: int):
    """[B, H, W, C] -> [B*nW, ws*ws, C] (swin_quant.py:18-32)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // window_size, window_size,
                  w // window_size, window_size, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window_size * window_size, c)


def window_reverse(windows, window_size: int, h: int, w: int):
    """[B*nW, ws*ws, C] -> [B, H, W, C] (swin_quant.py:35-50)."""
    b = windows.shape[0] // (h * w // window_size // window_size)
    x = windows.reshape(b, h // window_size, w // window_size,
                        window_size, window_size, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


def to_windows(x, B, res, dim, ws, shift):
    """A token stream [B, res*res, dim] -> rolled (by -shift),
    window-partitioned [B*nW, ws*ws, dim], as Swin's attention runs it."""
    xw = x.reshape(B, res, res, dim)
    if shift > 0:
        xw = torch.roll(xw, (-shift, -shift), (1, 2))
    return window_partition(xw, ws)


def from_windows(yw, B, res, dim, ws, shift):
    """The inverse of :func:`to_windows`: [B, res*res, dim]."""
    y = window_reverse(yw.reshape(-1, ws, ws, dim), ws, res, res)
    if shift > 0:
        y = torch.roll(y, (shift, shift), (1, 2))
    return y.reshape(B, res * res, dim)


def relative_position_index(window_size: int) -> np.ndarray:
    """Pairwise relative-position lookup table [N, N], N = ws*ws
    (swin_quant.py:79-94)."""
    coords = np.stack(np.meshgrid(np.arange(window_size),
                                  np.arange(window_size),
                                  indexing="ij"))           # [2, ws, ws]
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]               # [2, N, N]
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += window_size - 1
    rel[:, :, 1] += window_size - 1
    rel[:, :, 0] *= 2 * window_size - 1
    return rel.sum(-1)


def attention_mask(resolution, window_size: int, shift_size: int):
    """0/-100 additive mask [nW, N, N] of the shifted windows
    (swin_quant.py:223-247)."""
    h, w = resolution
    img_mask = np.zeros((1, h, w, 1), np.float32)
    cnt = 0
    for hs in (slice(0, -window_size), slice(-window_size, -shift_size),
               slice(-shift_size, None)):
        for ws in (slice(0, -window_size), slice(-window_size, -shift_size),
                   slice(-shift_size, None)):
            img_mask[:, hs, ws, :] = cnt
            cnt += 1
    mw = img_mask.reshape(1, h // window_size, window_size,
                          w // window_size, window_size, 1)
    mw = mw.transpose(0, 1, 3, 2, 4, 5).reshape(-1, window_size * window_size)
    attn_mask = mw[:, None, :] - mw[:, :, None]
    return np.where(attn_mask != 0, -100.0, 0.0).astype(np.float32)


class _DeviceConst:
    """A numpy constant of a module, copied to each device once (not a
    buffer: the flax variables have no such leaf)."""

    def __init__(self, array):
        self.array, self.copies = array, {}

    def on(self, device):
        if device not in self.copies:
            self.copies[device] = torch.from_numpy(self.array).to(device)
        return self.copies[device]


def stage_geometry(resolution: int, window_size: int, shift_size: int):
    """A block's window and shift: the window is clamped to the stage and
    the shift dropped where the stage is no larger than a window
    (``swin.py:175-177``)."""
    if resolution <= window_size:
        return resolution, 0
    return window_size, shift_size


class WindowAttention(nn.Module):
    """W-MSA with the quantized relative-position bias (``swin.py:86``);
    ``mask``: the [nW, N, N] shift mask as a tensor on the input's device,
    or None."""

    def __init__(self, dim: int, window_size: int, num_heads: int,
                 qkv_bias: bool = True, softmax_factory=None):
        super().__init__()
        self.dim, self.window_size, self.num_heads = dim, window_size, num_heads
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.rel_index = _DeviceConst(relative_position_index(window_size).reshape(-1))
        self.qkv = QuantLinear(dim, dim * 3, use_bias=qkv_bias)
        self.qact1 = QuantAct()
        self.qact_attn1 = QuantAct()
        self.qact_table = QuantAct()
        self.qact2 = QuantAct()
        self.int_softmax = softmax_factory()
        self.qact3 = QuantAct()
        self.proj = QuantLinear(dim, dim)
        self.qact4 = QuantAct(16)

    def forward(self, x, act_scaling_factor, mask=None, *, running_stat=False):
        b_, n, c = x.shape
        # this rank's heads on a tensor-parallel mesh (the qkv columns and
        # the bias table are cut by head)
        head_dim = self.dim // self.num_heads
        heads = self.relative_position_bias_table.shape[1]
        scale = head_dim ** -0.5
        rs = running_stat
        x, s = self.qkv(x, act_scaling_factor)
        x, s1 = self.qact1(x, s, running_stat=rs)
        q_, k_, v_ = x.reshape(b_, n, 3, heads, head_dim).permute(2, 0, 3, 1, 4)
        attn, s = quant_matmul(q_, s1, k_.transpose(-2, -1), s1)
        attn = attn * scale
        s = s * scale
        attn, s = self.qact_attn1(attn, s, running_stat=rs)

        # the quantized bias table, gathered to [1, nH, N, N] and added
        # through qact2's identity branch (swin.py:122-128)
        table_q, s_table = self.qact_table(self.relative_position_bias_table,
                                           running_stat=rs)
        rel_bias = table_q[self.rel_index.on(x.device)].reshape(n, n, heads)
        rel_bias = rel_bias.permute(2, 0, 1)[None]
        attn, s = self.qact2(attn, s, identity=rel_bias.expand_as(attn),
                             identity_scale=s_table, running_stat=rs)
        if mask is not None:
            # the mask snapped onto the score grid, so that the engine's
            # integer add round(mask / s) is the same value (swin.py:130-143)
            nw = mask.shape[0]
            s1d = s.detach().reshape(())
            mask_q = torch.round(q.rdiv(mask, s1d)) * s1d
            attn = attn.reshape(b_ // nw, nw, heads, n, n) + mask_q[None, :, None]
            attn = attn.reshape(-1, heads, n, n)
        attn, s = self.int_softmax(attn, s, running_stat=rs)

        x, s = quant_matmul(attn, s, v_, s1)
        x = x.transpose(1, 2).reshape(b_, n, heads * head_dim)
        x, s = self.qact3(x, s, running_stat=rs)
        x, s = self.proj(x, s)
        return self.qact4(x, s, running_stat=rs)


class SwinBlock(nn.Module):
    """Swin block with 16-bit integer residual adds (``swin.py:150``)."""

    def __init__(self, dim: int, input_resolution: int, num_heads: int,
                 window_size: int = 7, shift_size: int = 0, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, drop_path: float = 0.0, gelu_factory=None,
                 softmax_factory=None, norm_factory=None):
        super().__init__()
        self.dim, self.resolution = dim, input_resolution
        self.window_size, self.shift_size = stage_geometry(
            input_resolution, window_size, shift_size)
        self.mask = (_DeviceConst(attention_mask(
            (input_resolution, input_resolution), self.window_size, self.shift_size))
            if self.shift_size > 0 else None)
        self.norm1 = norm_factory(dim)
        self.qact1 = QuantAct()
        self.attn = WindowAttention(dim, self.window_size, num_heads, qkv_bias,
                                    softmax_factory=softmax_factory)
        self.drop_path = DropPath(drop_path)
        self.qact2 = QuantAct(16)
        self.norm2 = norm_factory(dim)
        self.qact3 = QuantAct()
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, act_factory=gelu_factory)
        self.drop_path2 = DropPath(drop_path)
        self.qact4 = QuantAct(16)

    def forward(self, x_1, s_1, *, running_stat=False, train=False, generator=None):
        rs, kw = running_stat, dict(train=train, generator=generator)
        h = w = self.resolution
        b, _, c = x_1.shape
        ws, shift = self.window_size, self.shift_size
        x, s, x_int = self.norm1(x_1, s_1, running_stat=rs)
        x, s = self.qact1(x, s, running_stat=rs, exact_int=x_int)
        x = x.reshape(b, h, w, c)
        mask = None
        if shift > 0:
            x = torch.roll(x, (-shift, -shift), (1, 2))
            mask = self.mask.on(x.device)
        x, s = self.attn(window_partition(x, ws), s, mask, running_stat=rs)
        x = window_reverse(x, ws, h, w)
        if shift > 0:
            x = torch.roll(x, (shift, shift), (1, 2))
        x = self.drop_path(x.reshape(b, h * w, c), **kw)
        x_2, s_2 = self.qact2(x, s, identity=x_1, identity_scale=s_1, running_stat=rs)
        x, s, x_int = self.norm2(x_2, s_2, running_stat=rs)
        x, s = self.qact3(x, s, running_stat=rs, exact_int=x_int)
        x, s = self.mlp(x, s, running_stat=rs, **kw)
        x = self.drop_path2(x, **kw)
        return self.qact4(x, s, identity=x_2, identity_scale=s_2, running_stat=rs)


class PatchMerging(nn.Module):
    """4C -> 2C downsampling (``swin.py:225``)."""

    def __init__(self, input_resolution: int, dim: int, norm_factory=None):
        super().__init__()
        self.resolution = input_resolution
        self.norm = norm_factory(4 * dim)
        self.qact1 = QuantAct()
        self.reduction = QuantLinear(4 * dim, 2 * dim, use_bias=False)
        self.qact2 = QuantAct()

    def forward(self, x, s, *, running_stat=False):
        b, _, c = x.shape
        x = x.reshape(b, self.resolution, self.resolution, c)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        x = x.reshape(b, -1, 4 * c)
        x, s, x_int = self.norm(x, s, running_stat=running_stat)
        x, s = self.qact1(x, s, running_stat=running_stat, exact_int=x_int)
        x, s = self.reduction(x, s)
        return self.qact2(x, s, running_stat=running_stat)


def exact_int_pool(x, s):
    """The average pool over tokens on the exact integers:
    ``round(rdiv(exact_int_sum(x_int^T), N)) * s`` (``swin.py:320-328``)."""
    x_int = q.round_ste(q.rdiv(x, s))
    pooled = q.round_ste(q.rdiv(q.exact_int_sum(x_int.transpose(1, 2)),
                                float(x_int.shape[1])))[..., 0]
    return pooled * s


class SwinTransformer(nn.Module):
    """Quantized Swin (``swin.py:253``): NHWC images in, float logits out.
    ``ape``: the absolute position embedding through ``qact_pos``;
    ``device`` and ``seed`` as for the ViT sim (flax's initializers:
    truncated normal 0.02 for the kernels, the bias table and the position
    embedding)."""

    def __init__(self, img_size: int = 224, patch_size: int = 4,
                 num_classes: int = 1000, embed_dim: int = 96,
                 depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window_size: int = 7,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 drop_path_rate: float = 0.1, ape: bool = False,
                 patch_norm: bool = True, gelu_type: str = "ivit",
                 softmax_type: str = "ivit", layernorm_type: str = "ivit",
                 device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.img_size, self.patch_size, self.num_classes = img_size, patch_size, num_classes
        self.embed_dim, self.depths = embed_dim, tuple(depths)
        self.num_heads, self.window_size = tuple(num_heads), window_size
        self.mlp_ratio, self.ape, self.patch_norm = mlp_ratio, ape, patch_norm
        self.gelu_type, self.softmax_type = gelu_type, softmax_type
        self.layernorm_type = layernorm_type
        gelu_factory = registry.get_gelu(gelu_type)
        softmax_factory = registry.get_softmax(softmax_type)
        norm_factory = registry.get_layernorm(layernorm_type)
        grid = img_size // patch_size

        self.qact_input = QuantAct()
        self.patch_embed = PatchEmbed(patch_size, embed_dim,
                                      norm_factory=norm_factory if patch_norm else None)
        if ape:
            self.absolute_pos_embed = nn.Parameter(torch.zeros(1, grid * grid, embed_dim))
            self.qact_pos = QuantAct(16)
        self.qact1 = QuantAct(16)
        dpr = [float(r) for r in np.linspace(0, drop_path_rate, sum(self.depths))]
        self.stages = []          # (blocks, merge or None), in forward order
        bi = 0
        for i, depth in enumerate(self.depths):
            dim, res = embed_dim * 2 ** i, grid // 2 ** i
            blocks = []
            for d in range(depth):
                blk = SwinBlock(dim, res, self.num_heads[i], window_size,
                                0 if d % 2 == 0 else window_size // 2, mlp_ratio,
                                qkv_bias, dpr[bi], gelu_factory, softmax_factory,
                                norm_factory)
                self.add_module(f"layers_{i}_blocks_{d}", blk)
                blocks.append(blk)
                bi += 1
            merge = None
            if i < len(self.depths) - 1:
                merge = PatchMerging(res, dim, norm_factory=norm_factory)
                self.add_module(f"layers_{i}_downsample", merge)
            self.stages.append((blocks, merge))
        num_features = embed_dim * 2 ** (len(self.depths) - 1)
        self.norm = norm_factory(num_features)
        self.qact2 = QuantAct()
        self.qact3 = QuantAct()
        self.head = QuantLinear(num_features, num_classes)
        gen = torch.Generator().manual_seed(seed)
        for name, p in self.named_parameters():
            if name.rsplit(".", 1)[-1] in ("kernel", "relative_position_bias_table",
                                           "absolute_pos_embed"):
                trunc_normal_init(p, 0.02, gen)
        self.to(dev)
        self.mesh = None

    @property
    def device(self) -> torch.device:
        return self.head.kernel.device

    def embed(self, x, *, running_stat=False):
        """The input quant, the patch embedding and the 16-bit stage input
        (with the absolute position embedding where ``ape``)."""
        x, s = self.qact_input(x, running_stat=running_stat)
        x, s = self.patch_embed(x, s, running_stat=running_stat)
        if not self.ape:
            return self.qact1(x, s, running_stat=running_stat)
        x_pos, s_pos = self.qact_pos(self.absolute_pos_embed, running_stat=running_stat)
        return self.qact1(x, s, identity=x_pos.expand_as(x), identity_scale=s_pos,
                          running_stat=running_stat)

    def tail(self, x, s, *, running_stat=False):
        """The final LN, the exact-int pool and the head."""
        x, s, x_int = self.norm(x, s, running_stat=running_stat)
        x, s = self.qact2(x, s, running_stat=running_stat, exact_int=x_int)
        x, s = self.qact3(exact_int_pool(x, s), s, running_stat=running_stat)
        return self.head(x, s)[0]

    def forward(self, x, *, running_stat: bool = False, train: bool = False,
                generator=None):
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        with exact_f32(), coll.use(self.mesh):
            x, s = self.embed(x, running_stat=running_stat)
            for blocks, merge in self.stages:
                for blk in blocks:
                    x, s = blk(x, s, running_stat=running_stat, train=train,
                               generator=generator)
                if merge is not None:
                    x, s = merge(x, s, running_stat=running_stat)
            return self.tail(x, s, running_stat=running_stat)


def swin_tiny_patch4_window7_224(**kw):
    kw.setdefault("depths", (2, 2, 6, 2))
    kw.setdefault("num_heads", (3, 6, 12, 24))
    kw.setdefault("embed_dim", 96)
    return SwinTransformer(patch_size=4, window_size=7, **kw)


def swin_small_patch4_window7_224(**kw):
    kw.setdefault("depths", (2, 2, 18, 2))
    kw.setdefault("num_heads", (3, 6, 12, 24))
    kw.setdefault("embed_dim", 96)
    return SwinTransformer(patch_size=4, window_size=7, **kw)


def swin_base_patch4_window7_224(**kw):
    kw.setdefault("depths", (2, 2, 18, 2))
    kw.setdefault("num_heads", (4, 8, 16, 32))
    kw.setdefault("embed_dim", 128)
    return SwinTransformer(patch_size=4, window_size=7, **kw)


def swin_base_patch4_window12_384(**kw):
    """Swin-B fine-tuned at 384 px with 12 x 12 windows (arXiv:2103.14030
    Table 1; ``swin_base_patch4_window12_384``): stage 3's 12 x 12 grid is
    one window, so it has no shift."""
    kw.setdefault("depths", (2, 2, 18, 2))
    kw.setdefault("num_heads", (4, 8, 16, 32))
    kw.setdefault("embed_dim", 128)
    kw.setdefault("img_size", 384)
    return SwinTransformer(patch_size=4, window_size=12, **kw)
