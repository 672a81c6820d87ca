"""Regression-family output conversions (reference:
src/objective/regression_objective.hpp ConvertOutput): identity, the
``reg_sqrt`` square-back, and ``exp`` for the log-link objectives."""
from __future__ import annotations

import torch

from ..config import Config
from .base import ObjectiveFunction, register_objective


@register_objective
class RegressionL2(ObjectiveFunction):
    name = "regression"

    def __init__(self, config: Config) -> None:
        super().__init__(config)
        self.sqrt = config.reg_sqrt

    def convert_output(self, scores: torch.Tensor) -> torch.Tensor:
        if self.sqrt:
            return torch.sign(scores) * scores * scores
        return scores


@register_objective
class RegressionL1(ObjectiveFunction):
    name = "regression_l1"


@register_objective
class RegressionHuber(ObjectiveFunction):
    name = "huber"


@register_objective
class RegressionFair(ObjectiveFunction):
    name = "fair"


@register_objective
class RegressionQuantile(ObjectiveFunction):
    name = "quantile"


@register_objective
class RegressionMAPE(ObjectiveFunction):
    name = "mape"


@register_objective
class RegressionPoisson(ObjectiveFunction):
    """Log-link output: poisson, and gamma and tweedie below."""
    name = "poisson"

    def convert_output(self, scores: torch.Tensor) -> torch.Tensor:
        return torch.exp(scores)


@register_objective
class RegressionGamma(RegressionPoisson):
    name = "gamma"


@register_objective
class RegressionTweedie(RegressionPoisson):
    name = "tweedie"
