from .factories import (MODEL_REGISTRY, deit_base_patch16_224, deit_small_patch16_224,
                        deit_tiny_patch16_224, str2model, vit_base_patch16_224,
                        vit_large_patch16_224)
from .registry import get_gelu, get_layernorm, get_softmax, parse_layer_name
from .swin import (SwinTransformer, swin_base_patch4_window7_224,
                   swin_small_patch4_window7_224, swin_tiny_patch4_window7_224)
from .vit import BitWidths, VisionTransformer

__all__ = ["BitWidths", "MODEL_REGISTRY", "SwinTransformer", "VisionTransformer",
           "deit_base_patch16_224", "deit_small_patch16_224", "deit_tiny_patch16_224",
           "get_gelu", "get_layernorm", "get_softmax", "parse_layer_name", "str2model",
           "swin_base_patch4_window7_224", "swin_small_patch4_window7_224",
           "swin_tiny_patch4_window7_224", "vit_base_patch16_224",
           "vit_large_patch16_224"]
