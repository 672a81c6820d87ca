"""Regression metrics (reference: src/metric/regression_metric.hpp:322)."""
from __future__ import annotations

import numpy as np

from .base import Metric, register_metric

EPS = 1e-15


@register_metric
class L2Metric(Metric):
    name = "l2"

    def eval(self, scores):
        return [("l2", self._avg((scores - self.label) ** 2))]


@register_metric
class RMSEMetric(Metric):
    name = "rmse"

    def eval(self, scores):
        return [("rmse", float(np.sqrt(self._avg((scores - self.label) ** 2))))]


@register_metric
class L1Metric(Metric):
    name = "l1"

    def eval(self, scores):
        return [("l1", self._avg(np.abs(scores - self.label)))]


@register_metric
class QuantileMetric(Metric):
    name = "quantile"

    def eval(self, scores):
        alpha = self.config.alpha
        d = self.label - scores
        loss = np.where(d >= 0, alpha * d, (alpha - 1) * d)
        return [("quantile", self._avg(loss))]


@register_metric
class HuberMetric(Metric):
    name = "huber"

    def eval(self, scores):
        alpha = self.config.alpha
        d = scores - self.label
        loss = np.where(np.abs(d) <= alpha, 0.5 * d * d,
                        alpha * (np.abs(d) - 0.5 * alpha))
        return [("huber", self._avg(loss))]


@register_metric
class FairMetric(Metric):
    name = "fair"

    def eval(self, scores):
        c = self.config.fair_c
        x = np.abs(scores - self.label)
        return [("fair", self._avg(c * x - c * c * np.log1p(x / c)))]


@register_metric
class PoissonMetric(Metric):
    name = "poisson"

    def eval(self, scores):
        # converted scores (exp of the raw score): score - label * log(score)
        s = np.maximum(scores, EPS)
        return [("poisson", self._avg(s - self.label * np.log(s)))]


@register_metric
class MAPEMetric(Metric):
    name = "mape"

    def eval(self, scores):
        loss = np.abs((self.label - scores)
                      / np.maximum(1.0, np.abs(self.label)))
        return [("mape", self._avg(loss))]


@register_metric
class GammaMetric(Metric):
    """Negative log-likelihood of a gamma with shape 1 (reference:
    regression_metric.hpp GammaMetric)."""
    name = "gamma"

    def eval(self, scores):
        s = np.maximum(scores, EPS)
        return [("gamma", self._avg(self.label / s + np.log(s)))]


@register_metric
class GammaDevianceMetric(Metric):
    """2 * (log(pred / label) + label / pred - 1) (reference:
    regression_metric.hpp GammaDevianceMetric)."""
    name = "gamma_deviance"

    def eval(self, scores):
        s = np.maximum(scores, EPS)
        y = np.maximum(self.label, EPS)
        return [("gamma_deviance",
                 self._avg(2.0 * (np.log(s / y) + y / s - 1.0)))]


@register_metric
class TweedieMetric(Metric):
    name = "tweedie"

    def eval(self, scores):
        rho = self.config.tweedie_variance_power
        s = np.maximum(scores, EPS)
        a = self.label * np.power(s, 1 - rho) / (1 - rho)
        b = np.power(s, 2 - rho) / (2 - rho)
        return [("tweedie", self._avg(-a + b))]
