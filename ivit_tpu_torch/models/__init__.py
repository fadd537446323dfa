from .factories import (MODEL_REGISTRY, deit_base_patch16_224, deit_small_patch16_224,
                        deit_tiny_patch16_224, str2model, vit_base_patch16_224,
                        vit_large_patch16_224)
from .registry import get_gelu, get_layernorm, get_softmax, parse_layer_name
from .vit import BitWidths, VisionTransformer

__all__ = ["BitWidths", "MODEL_REGISTRY", "VisionTransformer", "deit_base_patch16_224",
           "deit_small_patch16_224", "deit_tiny_patch16_224", "get_gelu",
           "get_layernorm", "get_softmax", "parse_layer_name", "str2model",
           "vit_base_patch16_224", "vit_large_patch16_224"]
