from .export import load_engine, save_engine
from .freeze import EngineConfig, EngineSpec
from .swin_int import SwinEngineConfig, SwinEngineSpec, swin_engine_forward
from .vit_int import Engine, engine_forward

__all__ = ["Engine", "EngineConfig", "EngineSpec", "SwinEngineConfig",
           "SwinEngineSpec", "engine_forward", "load_engine", "save_engine",
           "swin_engine_forward"]
