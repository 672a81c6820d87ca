"""Regression metrics (reference: src/metric/regression_metric.hpp:322)."""
from __future__ import annotations

import numpy as np

from .base import Metric, register_metric


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
