"""Regression-family output conversions (reference:
src/objective/regression_objective.hpp ConvertOutput): identity, the
``reg_sqrt`` square-back, and ``exp`` for the log-link objectives. L2
regression also trains (gradients, boost from average); the other losses
convert loaded models' outputs only."""
from __future__ import annotations

import numpy as np
import torch

from ..config import Config
from .base import K_EPSILON, ObjectiveFunction, register_objective


@register_objective
class RegressionL2(ObjectiveFunction):
    """(reference: regression_objective.hpp:127-143 RegressionL2loss)"""
    name = "regression"
    trains = True

    def __init__(self, config: Config) -> None:
        super().__init__(config)
        self.sqrt = config.reg_sqrt

    def init(self, metadata, num_data: int, device: torch.device) -> None:
        super().init(metadata, num_data, device)
        if self.sqrt:
            self.label_np = (np.sign(self.label_np)
                             * np.sqrt(np.abs(self.label_np))
                             ).astype(np.float32)
            self.label = torch.from_numpy(self.label_np).to(device)

    def get_gradients_fast(self, scores):
        grad = scores - self.label[None, :]
        if self.weight is None:
            return grad, torch.ones_like(scores)
        return (grad * self.weight[None, :],
                self.weight[None, :].expand_as(scores).contiguous())

    def boost_from_score(self, class_id: int) -> float:
        if not self.config.boost_from_average:
            return 0.0
        if self.weight_np is not None:
            return float(np.sum(self.label_np * self.weight_np)
                         / max(np.sum(self.weight_np), K_EPSILON))
        return float(np.mean(self.label_np))

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
