"""Binary metrics (reference: src/metric/binary_metric.hpp:388)."""
from __future__ import annotations

import numpy as np

from .base import Metric, register_metric

EPS = 1e-15


@register_metric
class BinaryLoglossMetric(Metric):
    name = "binary_logloss"

    def eval(self, scores):
        p = np.clip(scores, EPS, 1 - EPS)
        loss = -(self.label * np.log(p) + (1 - self.label) * np.log(1 - p))
        return [("binary_logloss", self._avg(loss))]


@register_metric
class BinaryErrorMetric(Metric):
    name = "binary_error"

    def eval(self, scores):
        pred = (scores > 0.5).astype(np.float64)
        return [("binary_error",
                 self._avg((pred != self.label).astype(np.float64)))]


def _weighted_auc(label: np.ndarray, score: np.ndarray, weight) -> float:
    """Trapezoid AUC with weights (reference: binary_metric.hpp AUCMetric)."""
    order = np.argsort(-score, kind="stable")
    y = label[order]
    s = score[order]
    w = np.ones_like(y) if weight is None else weight[order]
    pos = np.sum(w * (y == 1))
    neg = np.sum(w * (y != 1))
    if pos <= 0 or neg <= 0:
        return 1.0
    # group ties: cumulative TPs/FPs at distinct score boundaries
    wp = w * (y == 1)
    wn = w * (y != 1)
    boundary = np.concatenate([s[1:] != s[:-1], [True]])
    tp = np.concatenate([[0.0], np.cumsum(wp)[boundary]])
    fp = np.concatenate([[0.0], np.cumsum(wn)[boundary]])
    area = (np.trapezoid(tp, fp) if hasattr(np, "trapezoid")
            else np.trapz(tp, fp))
    return float(area / (pos * neg))


@register_metric
class AUCMetric(Metric):
    name = "auc"
    greater_is_better = True

    def eval(self, scores):
        return [("auc", _weighted_auc(self.label, np.asarray(scores),
                                      self.weight))]


@register_metric
class AveragePrecisionMetric(Metric):
    name = "average_precision"
    greater_is_better = True

    def eval(self, scores):
        """(reference: binary_metric.hpp AveragePrecisionMetric)"""
        order = np.argsort(-np.asarray(scores), kind="stable")
        y = self.label[order]
        w = np.ones_like(y) if self.weight is None else self.weight[order]
        tp = np.cumsum(w * (y == 1))
        fp = np.cumsum(w * (y != 1))
        total_pos = tp[-1]
        if total_pos <= 0:
            return [("average_precision", 1.0)]
        precision = tp / np.maximum(tp + fp, EPS)
        recall_delta = np.diff(np.concatenate([[0.0], tp])) / total_pos
        return [("average_precision",
                 float(np.sum(precision * recall_delta)))]
