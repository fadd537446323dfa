from .export import load_engine, save_engine
from .freeze import EngineConfig, EngineSpec
from .vit_int import Engine, engine_forward

__all__ = ["Engine", "EngineConfig", "EngineSpec", "engine_forward",
           "load_engine", "save_engine"]
