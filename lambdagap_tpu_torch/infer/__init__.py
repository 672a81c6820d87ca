"""Compiled inference: the forest compiler (host numpy) and the CUDA
traversal engine (``predict_engine=compiled``)."""
from .compile import (ArtifactMismatch, ArtifactStore, ForestArtifact,
                      compile_forest, source_key_of)
from .engine import TRAVERSE_LAUNCHES, CompiledForest, traverse_forest

__all__ = ["ArtifactMismatch", "ArtifactStore", "ForestArtifact",
           "compile_forest", "source_key_of", "CompiledForest",
           "traverse_forest", "TRAVERSE_LAUNCHES"]
