"""Objectives: output conversions for loaded models; gradients for the
objectives that train (binary, L2 regression, lambdarank, rank_xendcg)."""
from . import binary, multiclass, rank, regression  # noqa: F401 (registry)
from .base import ObjectiveFunction, create_objective

__all__ = ["ObjectiveFunction", "create_objective"]
