"""Regression objectives (reference:
src/objective/regression_objective.hpp:100-763): L2 (+ ``reg_sqrt``), L1,
Huber, Fair, Poisson, Quantile, MAPE, Gamma and Tweedie — the port of
``lambdagap_tpu/objectives/regression.py``, its float32 operations in the
same order, with each ``exp`` taken in float64 and rounded once
(``exp64``). L1, quantile and MAPE refit their leaves on the host
(``renew_tree_output``)."""
from __future__ import annotations

import numpy as np
import torch

from ..config import Config
from ..utils import log
from .base import (K_EPSILON, ObjectiveFunction, exp64, register_objective,
                   weighted_percentile)


def _w(x, weight):
    return x if weight is None else x * weight[None, :]


@register_objective
class RegressionL2(ObjectiveFunction):
    """(reference: regression_objective.hpp:127-143 RegressionL2loss)"""
    name = "regression"

    def __init__(self, config: Config) -> None:
        super().__init__(config)
        # reg_sqrt is L2's alone; the losses below extend L2 for its init
        # and constant hessian
        self.sqrt = config.reg_sqrt and self.name == "regression"

    def init(self, metadata, num_data: int, device: torch.device) -> None:
        super().init(metadata, num_data, device)
        if self.sqrt:
            self.label_np = (np.sign(self.label_np)
                             * np.sqrt(np.abs(self.label_np))
                             ).astype(np.float32)
            self.label = torch.from_numpy(self.label_np).to(device)

    def get_gradients_fast(self, scores):
        return _w(scores - self.label[None, :], self.weight), \
            self._hess(scores)

    def _hess(self, scores):
        """Ones, or the weights, as the constant hessian."""
        if self.weight is None:
            return torch.ones_like(scores)
        return self.weight[None, :].expand_as(scores).contiguous()

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
class RegressionL1(RegressionL2):
    """(reference: regression_objective.hpp:210-290 RegressionL1loss)"""
    name = "regression_l1"

    def get_gradients_fast(self, scores):
        return (_w(torch.sign(scores - self.label[None, :]), self.weight),
                self._hess(scores))

    def boost_from_score(self, class_id: int) -> float:
        # the weighted median (reference: RegressionL1loss::BoostFromScore)
        return weighted_percentile(self.label_np, self.weight_np, 0.5)

    @property
    def is_renew_tree_output(self) -> bool:
        return True

    def renew_tree_output(self, leaf_rows, score) -> float:
        resid = self.label_np[leaf_rows] - score[leaf_rows]
        w = None if self.weight_np is None else self.weight_np[leaf_rows]
        return weighted_percentile(resid, w, 0.5)


@register_objective
class RegressionHuber(RegressionL2):
    """(reference: regression_objective.hpp:292-350 RegressionHuberLoss)"""
    name = "huber"

    def __init__(self, config: Config) -> None:
        super().__init__(config)
        self.alpha = config.alpha

    def get_gradients_fast(self, scores):
        diff = scores - self.label[None, :]
        grad = torch.where(diff.abs() <= self.alpha, diff,
                           torch.sign(diff) * self.alpha)
        return _w(grad, self.weight), self._hess(scores)


@register_objective
class RegressionFair(RegressionL2):
    """(reference: regression_objective.hpp:353-395 RegressionFairLoss)"""
    name = "fair"

    def __init__(self, config: Config) -> None:
        super().__init__(config)
        self.c = config.fair_c

    def get_gradients_fast(self, scores):
        x = scores - self.label[None, :]
        c = self.c
        grad = _w(c * x / (x.abs() + c), self.weight)
        # a true division: ``scalar / tensor`` is a reciprocal times the
        # scalar in torch, two roundings
        hess = _w(torch.div(x.new_tensor(c * c), (x.abs() + c) ** 2),
                  self.weight)
        return grad, hess

    def boost_from_score(self, class_id: int) -> float:
        return 0.0


@register_objective
class RegressionPoisson(RegressionL2):
    """Log-link Poisson (reference: regression_objective.hpp:398-478);
    gamma and tweedie below share its init, init score and output."""
    name = "poisson"

    def __init__(self, config: Config) -> None:
        super().__init__(config)
        self.max_delta = config.poisson_max_delta_step

    def init(self, metadata, num_data: int, device: torch.device) -> None:
        super().init(metadata, num_data, device)
        if np.any(self.label_np < 0):
            log.fatal("[%s]: at least one target label is negative",
                      self.name)

    def get_gradients_fast(self, scores):
        exp_score = exp64(scores)
        grad = _w(exp_score - self.label[None, :], self.weight)
        hess = _w(exp_score * float(np.exp(self.max_delta)), self.weight)
        return grad, hess

    def boost_from_score(self, class_id: int) -> float:
        mean = (super().boost_from_score(0) if self.config.boost_from_average
                else float(np.mean(self.label_np)))
        return float(np.log(max(mean, K_EPSILON)))

    def convert_output(self, scores: torch.Tensor) -> torch.Tensor:
        return torch.exp(scores)


@register_objective
class RegressionQuantile(RegressionL2):
    """Pinball loss (reference: regression_objective.hpp:481-560)."""
    name = "quantile"

    def __init__(self, config: Config) -> None:
        super().__init__(config)
        self.alpha = config.alpha

    def get_gradients_fast(self, scores):
        diff = scores - self.label[None, :]
        one = torch.ones_like(diff)
        grad = torch.where(diff >= 0, one * (1.0 - self.alpha),
                           one * -self.alpha)
        return _w(grad, self.weight), self._hess(scores)

    def boost_from_score(self, class_id: int) -> float:
        return weighted_percentile(self.label_np, self.weight_np, self.alpha)

    @property
    def is_renew_tree_output(self) -> bool:
        return True

    def renew_tree_output(self, leaf_rows, score) -> float:
        resid = self.label_np[leaf_rows] - score[leaf_rows]
        w = None if self.weight_np is None else self.weight_np[leaf_rows]
        return weighted_percentile(resid, w, self.alpha)


@register_objective
class RegressionMAPE(RegressionL1):
    """(reference: regression_objective.hpp:563-637 RegressionMAPELOSS):
    L1 on residuals weighted by 1/max(1, |label|); the hessian is one
    whatever the weights."""
    name = "mape"

    def init(self, metadata, num_data: int, device: torch.device) -> None:
        super().init(metadata, num_data, device)
        lw = 1.0 / np.maximum(1.0, np.abs(self.label_np))
        if self.weight_np is not None:
            lw = lw * self.weight_np
        self.label_weight_np = lw.astype(np.float32)
        self.label_weight = torch.from_numpy(self.label_weight_np).to(device)

    def get_gradients_fast(self, scores):
        diff = scores - self.label[None, :]
        return (torch.sign(diff) * self.label_weight[None, :],
                torch.ones_like(scores))

    def boost_from_score(self, class_id: int) -> float:
        return weighted_percentile(self.label_np, self.label_weight_np, 0.5)

    def renew_tree_output(self, leaf_rows, score) -> float:
        resid = self.label_np[leaf_rows] - score[leaf_rows]
        return weighted_percentile(resid, self.label_weight_np[leaf_rows],
                                   0.5)


@register_objective
class RegressionGamma(RegressionPoisson):
    """(reference: regression_objective.hpp:678-717 RegressionGammaLoss)"""
    name = "gamma"

    def get_gradients_fast(self, scores):
        exp_neg = exp64(-scores)
        y = self.label[None, :]
        return (_w(1.0 - y * exp_neg, self.weight),
                _w(y * exp_neg, self.weight))


@register_objective
class RegressionTweedie(RegressionPoisson):
    """(reference: regression_objective.hpp:720-763 RegressionTweedieLoss)"""
    name = "tweedie"

    def __init__(self, config: Config) -> None:
        super().__init__(config)
        self.rho = config.tweedie_variance_power

    def get_gradients_fast(self, scores):
        rho = self.rho
        e1 = exp64((1 - rho) * scores)
        e2 = exp64((2 - rho) * scores)
        y = self.label[None, :]
        return (_w(-y * e1 + e2, self.weight),
                _w(-y * (1 - rho) * e1 + (2 - rho) * e2, self.weight))
