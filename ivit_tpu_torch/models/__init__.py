from .registry import parse_layer_name
from .vit import BitWidths

__all__ = ["BitWidths", "parse_layer_name"]
