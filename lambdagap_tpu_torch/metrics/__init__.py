"""Evaluation metrics: host numpy over converted scores.

The port of ``lambdagap_tpu/metrics/`` for the metrics of the training
slices: ``auc``, ``binary_logloss``, ``binary_error``, ``l2``, ``rmse``,
``l1``, and ``ndcg``, ``map`` and ``precision`` at each ``eval_at``
position (reference: src/metric/binary_metric.hpp,
src/metric/regression_metric.hpp, src/metric/rank_metric.hpp), with the
JAX package's numpy arithmetic unchanged. Metrics the port does not have
raise NotImplementedError.
"""
from .base import Metric, create_metrics, metric_names_for, register_metric
from . import binary, rank, regression  # noqa: F401,E402 (registry)

__all__ = ["Metric", "create_metrics", "metric_names_for", "register_metric"]
