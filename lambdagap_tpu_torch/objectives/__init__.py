"""Objectives: output conversions for loaded models (gradients wait for
the training slice)."""
from . import binary, multiclass, regression  # noqa: F401  (registration)
from .base import ObjectiveFunction, create_objective

__all__ = ["ObjectiveFunction", "create_objective"]
