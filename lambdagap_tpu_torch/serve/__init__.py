"""Serving: one compiled forest behind a micro-batching server."""
from .batcher import MicroBatcher
from .cache import DEFAULT_BUCKETS, CompiledForestCache
from .server import ForestServer, ServeResult
from .stats import ServeStats

__all__ = ["MicroBatcher", "DEFAULT_BUCKETS", "CompiledForestCache",
           "ForestServer", "ServeResult", "ServeStats"]
