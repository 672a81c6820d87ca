"""Cross-entropy metrics (reference: src/metric/xentropy_metric.hpp): the
port of ``lambdagap_tpu/metrics/xentropy.py``, its numpy arithmetic
unchanged — ``cross_entropy_lambda`` included, which averages with an
unweighted mean there."""
from __future__ import annotations

import numpy as np

from .base import Metric, register_metric

EPS = 1e-15


@register_metric
class CrossEntropyMetric(Metric):
    name = "cross_entropy"

    def eval(self, scores):
        p = np.clip(scores, EPS, 1 - EPS)
        y = self.label
        loss = -(y * np.log(p) + (1 - y) * np.log(1 - p))
        return [("cross_entropy", self._avg(loss))]


@register_metric
class CrossEntropyLambdaMetric(Metric):
    name = "cross_entropy_lambda"

    def eval(self, scores):
        # scores converted by the objective: log1p(exp(raw))
        hhat = np.maximum(np.asarray(scores), EPS)
        y = self.label
        w = self.weight if self.weight is not None else np.ones_like(y)
        z = np.clip(1.0 - np.exp(-w * hhat), EPS, 1 - EPS)
        loss = -(y * np.log(z) + (1 - y) * np.log(1 - z))
        return [("cross_entropy_lambda", float(np.mean(loss)))]


@register_metric
class KLDivergenceMetric(Metric):
    name = "kldiv"

    def eval(self, scores):
        p = np.clip(scores, EPS, 1 - EPS)
        y = np.clip(self.label, EPS, 1 - EPS)
        kl = y * np.log(y / p) + (1 - y) * np.log((1 - y) / (1 - p))
        return [("kldiv", self._avg(kl))]
