"""Evaluation metrics: host numpy over converted scores.

The port of ``lambdagap_tpu/metrics/``, all 24 of its metrics with its
numpy arithmetic unchanged (reference: src/metric/*.hpp): regression (l1,
l2, rmse, quantile, huber, fair, poisson, mape, gamma, gamma_deviance,
tweedie), binary (auc, average_precision, binary_logloss, binary_error),
multiclass over ``[K, N]`` scores (multi_logloss, multi_error and
``multi_error@k``, auc_mu), cross-entropy (cross_entropy,
cross_entropy_lambda, kldiv) and ranking (ndcg, map and precision at each
``eval_at`` position). A name no metric answers to is refused.
"""
from .base import Metric, create_metrics, metric_names_for, register_metric
from . import binary, multiclass, rank, regression, xentropy  # noqa: F401,E402

__all__ = ["Metric", "create_metrics", "metric_names_for", "register_metric"]
