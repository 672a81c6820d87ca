"""Serving: compiled forests in a multi-model registry behind a
micro-batching server, with hot swap, delta swap and cross-model packing."""
from .batcher import MicroBatcher
from .cache import DEFAULT_BUCKETS, CompiledForestCache, ModelPack
from .delta import (DELTA_FORMAT, DeltaMismatch, apply_delta, delta_bytes,
                    make_delta)
from .registry import DEFAULT_MODEL, ModelEntry, ModelRegistry
from .server import ForestServer, ServeResult
from .stats import ServeStats
from .swap import SwapController, load_booster

__all__ = ["MicroBatcher", "DEFAULT_BUCKETS", "CompiledForestCache",
           "ModelPack", "DELTA_FORMAT", "DeltaMismatch", "apply_delta",
           "delta_bytes", "make_delta", "DEFAULT_MODEL", "ModelEntry",
           "ModelRegistry", "ForestServer", "ServeResult", "ServeStats",
           "SwapController", "load_booster"]
