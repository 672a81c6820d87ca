"""Multiclass metrics (reference: src/metric/multiclass_metric.hpp): the
port of ``lambdagap_tpu/metrics/multiclass.py`` over ``[K, N]`` converted
scores, its numpy arithmetic unchanged."""
from __future__ import annotations

import numpy as np

from ..utils import log
from .base import Metric, register_metric
from .binary import _weighted_auc

EPS = 1e-15


@register_metric
class MultiLoglossMetric(Metric):
    name = "multi_logloss"

    def eval(self, scores):
        p = np.clip(scores, EPS, 1.0)
        y = self.label.astype(np.int64)
        return [("multi_logloss",
                 self._avg(-np.log(p[y, np.arange(len(y))])))]


@register_metric
class MultiErrorMetric(Metric):
    """Top-k error (reference: MultiErrorMetric with multi_error_top_k):
    a row errs when at least k classes score strictly above its own."""
    name = "multi_error"

    def eval(self, scores):
        k = max(1, self.config.multi_error_top_k)
        y = self.label.astype(np.int64)
        s = np.asarray(scores)
        true_score = s[y, np.arange(len(y))]
        rank = np.sum(s > true_score[None, :], axis=0)
        name = "multi_error" if k == 1 else f"multi_error@{k}"
        return [(name, self._avg((rank >= k).astype(np.float64)))]


@register_metric
class AucMuMetric(Metric):
    """AUC-mu (reference: multiclass_metric.hpp AucMuMetric, Kleiman &
    Page 2019): the mean over class pairs (a, b) of the weighted AUC of
    ``t1 * (v . scores)``, ``v = W[a] - W[b]``, ``t1 = v[a] - v[b]``, with
    ``W`` the ``auc_mu_weights`` cost matrix (default: ones off the
    diagonal)."""
    name = "auc_mu"
    greater_is_better = True

    def eval(self, scores):
        s = np.asarray(scores)
        K = s.shape[0]
        y = self.label.astype(np.int64)
        w = self.weight if self.weight is not None else np.ones(len(y))
        amw = list(self.config.auc_mu_weights or [])
        if amw:
            if len(amw) != K * K:
                log.fatal("auc_mu_weights must have num_class^2 = %d "
                          "entries, got %d", K * K, len(amw))
            W = np.asarray(amw, np.float64).reshape(K, K)
        else:
            W = 1.0 - np.eye(K)
        total = 0.0
        pairs = 0
        for a in range(K):
            for b in range(a + 1, K):
                mask = (y == a) | (y == b)
                if not mask.any():
                    continue
                ya = (y[mask] == a).astype(np.float64)
                v = W[a] - W[b]
                t1 = v[a] - v[b]
                total += _weighted_auc(ya, t1 * (v @ s[:, mask]), w[mask])
                pairs += 1
        return [("auc_mu", total / max(pairs, 1))]
