"""Compiled inference: the forest compiler (host numpy) and the CUDA
traversal engine (``predict_engine=compiled``)."""
from .compile import (ArtifactMismatch, ArtifactStore, ForestArtifact,
                      compile_forest, source_key_of)
from .engine import (ACCUMULATE_LAUNCHES, PREDICT_LAUNCHES, TRAVERSE_LAUNCHES,
                     CompiledForest, accumulate_forest, predict_forest,
                     traverse_forest)

__all__ = ["ArtifactMismatch", "ArtifactStore", "ForestArtifact",
           "compile_forest", "source_key_of", "CompiledForest",
           "predict_forest", "traverse_forest", "accumulate_forest",
           "PREDICT_LAUNCHES", "TRAVERSE_LAUNCHES", "ACCUMULATE_LAUNCHES"]
