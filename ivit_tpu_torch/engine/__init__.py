from . import dispatch
from .export import load_engine, save_engine
from .freeze import EngineConfig, EngineSpec, freeze_model
from .serving import DeadlineExceeded, QueueFull, ServingEngine, ServingMetrics
from .swin_int import (SwinEngineConfig, SwinEngineSpec, freeze_swin_model,
                       swin_engine_forward)
from .vit_int import Engine, engine_forward

__all__ = ["DeadlineExceeded", "Engine", "EngineConfig", "EngineSpec", "QueueFull",
           "ServingEngine", "ServingMetrics", "SwinEngineConfig", "SwinEngineSpec",
           "engine_forward", "freeze_model", "freeze_swin_model", "load_engine",
           "save_engine", "swin_engine_forward"]
