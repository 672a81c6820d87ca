"""Objectives: gradients, init scores and output conversions of every
objective the JAX package has — regression (L2, L1, huber, fair, poisson,
quantile, mape, gamma, tweedie), binary, multiclass and multiclassova,
cross_entropy and cross_entropy_lambda, lambdarank and rank_xendcg."""
from . import binary, multiclass, rank, regression, xentropy  # noqa: F401
from .base import ObjectiveFunction, create_objective

__all__ = ["ObjectiveFunction", "create_objective"]
