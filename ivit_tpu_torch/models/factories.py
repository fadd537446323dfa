"""Model factories (counterpart of ``ivit_tpu/models/factories.py``; ref
vit_quant.py:315-406).  Each builds the QAT sim on ``cuda`` unless
``device=`` says otherwise; ``seed=`` picks its initial parameters, and
any architecture keyword (``depth=`` or ``depths=`` to cut a model for a
test) overrides the published one."""

from __future__ import annotations

from .swin import (swin_base_patch4_window7_224, swin_small_patch4_window7_224,
                   swin_tiny_patch4_window7_224)
from .vit import BitWidths, VisionTransformer


def _vit(arch, **kwargs):
    kwargs.setdefault("bitwidths", BitWidths.from_spec(kwargs.pop("bitwidth", 8)))
    embed_dim, depth, num_heads = arch
    return VisionTransformer(**{
        **dict(patch_size=16, embed_dim=embed_dim, depth=depth,
               num_heads=num_heads, mlp_ratio=4.0, qkv_bias=True), **kwargs})


def deit_tiny_patch16_224(**kwargs):
    return _vit((192, 12, 3), **kwargs)


def deit_small_patch16_224(**kwargs):
    return _vit((384, 12, 6), **kwargs)


def deit_base_patch16_224(**kwargs):
    return _vit((768, 12, 12), **kwargs)


def vit_base_patch16_224(**kwargs):
    return _vit((768, 12, 12), **kwargs)


def vit_large_patch16_224(**kwargs):
    return _vit((1024, 24, 16), **kwargs)


MODEL_REGISTRY = {
    "deit_tiny_patch16_224": deit_tiny_patch16_224,
    "deit_small_patch16_224": deit_small_patch16_224,
    "deit_base_patch16_224": deit_base_patch16_224,
    "vit_base_patch16_224": vit_base_patch16_224,
    "vit_large_patch16_224": vit_large_patch16_224,
    "swin_tiny_patch4_window7_224": swin_tiny_patch4_window7_224,
    "swin_small_patch4_window7_224": swin_small_patch4_window7_224,
    "swin_base_patch4_window7_224": swin_base_patch4_window7_224,
}


def str2model(name: str):
    """Model-name lookup (ref quant_train.py:188-196)."""
    try:
        return MODEL_REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown model {name!r}; options: "
                         f"{sorted(MODEL_REGISTRY)}") from None
