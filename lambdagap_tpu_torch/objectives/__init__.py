"""Objectives: output conversions for loaded models; gradients for the
objectives that train (binary, L2 regression)."""
from . import binary, multiclass, regression  # noqa: F401  (registration)
from .base import ObjectiveFunction, create_objective

__all__ = ["ObjectiveFunction", "create_objective"]
