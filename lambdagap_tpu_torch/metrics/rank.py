"""Ranking metrics: NDCG@k, MAP@k, precision@k.

The port of ``lambdagap_tpu/metrics/rank.py`` with its host numpy
arithmetic unchanged (reference: src/metric/rank_metric.hpp NDCGMetric,
src/metric/map_metric.hpp MapMetric, and the fork-added
src/metric/precision_metric.hpp:16 PrecisionMetric with its cumulative-hit
bucket formula). Each reports one value per ``eval_at`` position, named
``<metric>@<k>``, greater is better.
"""
from __future__ import annotations

from typing import List

import numpy as np

from ..utils import log
from .base import Metric, register_metric


def _default_label_gain(max_label: int) -> np.ndarray:
    return np.asarray([(1 << i) - 1 if i < 31 else 2.0 ** 31 - 1
                       for i in range(max(max_label + 1, 32))],
                      dtype=np.float64)


class _RankMetricBase(Metric):
    greater_is_better = True

    def init(self, metadata, num_data: int) -> None:
        super().init(metadata, num_data)
        if metadata.query_boundaries is None:
            log.fatal("For %s metric, there should be query information",
                      self.name)
        self.qb = np.asarray(metadata.query_boundaries)
        self.num_queries = metadata.num_queries
        self.query_weights = metadata.query_weights
        self.sum_qw = (float(np.sum(self.query_weights))
                       if self.query_weights is not None
                       else float(self.num_queries))
        self.eval_at = list(self.config.eval_at) or [1, 2, 3, 4, 5]

    def _per_query(self, label: np.ndarray, score: np.ndarray) -> List[float]:
        raise NotImplementedError

    def eval(self, scores):
        scores = np.asarray(scores)
        totals = np.zeros(len(self.eval_at))
        for qi in range(self.num_queries):
            lo, hi = self.qb[qi], self.qb[qi + 1]
            vals = np.asarray(self._per_query(self.label[lo:hi],
                                              scores[lo:hi]))
            w = (self.query_weights[qi] if self.query_weights is not None
                 else 1.0)
            totals += vals * w
        totals /= self.sum_qw
        return [(f"{self.name}@{k}", float(v))
                for k, v in zip(self.eval_at, totals)]


@register_metric
class NDCGMetric(_RankMetricBase):
    """(reference: rank_metric.hpp NDCGMetric; empty queries score 1)."""
    name = "ndcg"

    def init(self, metadata, num_data: int) -> None:
        super().init(metadata, num_data)
        max_label = int(np.max(self.label)) if num_data else 0
        gains = self.config.label_gain
        self.label_gain = (np.asarray(gains, dtype=np.float64) if gains
                           else _default_label_gain(max_label))

    def _per_query(self, label, score):
        order = np.argsort(-score, kind="stable")
        sorted_labels = label[order].astype(np.int64)
        disc = 1.0 / np.log2(2.0 + np.arange(len(label)))
        out = []
        ideal = np.sort(label.astype(np.int64))[::-1]
        for k in self.eval_at:
            kk = min(k, len(label))
            dcg = float(np.sum(self.label_gain[sorted_labels[:kk]]
                               * disc[:kk]))
            max_dcg = float(np.sum(self.label_gain[ideal[:kk]] * disc[:kk]))
            out.append(dcg / max_dcg if max_dcg > 0 else 1.0)
        return out


@register_metric
class MapMetric(_RankMetricBase):
    """Mean average precision@k (reference: map_metric.hpp)."""
    name = "map"

    def _per_query(self, label, score):
        order = np.argsort(-score, kind="stable")
        rel = (label[order] > 0).astype(np.float64)
        hits = np.cumsum(rel)
        prec = hits / np.arange(1, len(rel) + 1)
        out = []
        for k in self.eval_at:
            kk = min(k, len(rel))
            num_hit = hits[kk - 1] if kk > 0 else 0.0
            if num_hit > 0:
                out.append(float(np.sum(prec[:kk] * rel[:kk]) / num_hit))
            else:
                out.append(1.0 if np.sum(rel) == 0 else 0.0)
        return out


@register_metric
class PrecisionMetric(_RankMetricBase):
    """Fork-added precision@k (reference: precision_metric.hpp:16
    CalPrecisionAtK — hits accumulate across the eval_at buckets and each
    bucket divides by min(k, remaining docs))."""
    name = "precision"

    def _per_query(self, label, score):
        order = np.argsort(-score, kind="stable")
        rel = label[order] > 0.5
        out = []
        num_hit = 0
        cur_left = 0
        n = len(rel)
        for k in self.eval_at:
            num_hit += int(np.sum(rel[cur_left:min(k, n)]))
            denom = min(k, max(n - cur_left, 0))
            out.append(num_hit / denom if denom > 0 else 0.0)
            cur_left = k
        return out
