"""Metric interface + factory (reference: include/LightGBM/metric.h:24
Metric, src/metric/metric.cpp:24-133 factory). Metrics consume converted
scores as float64 numpy on the host, once per iteration."""
from __future__ import annotations

from typing import Dict, List, Tuple, Type

import numpy as np

from ..config import Config
from ..utils import log

_REGISTRY: Dict[str, Type["Metric"]] = {}

_METRIC_ALIASES = {
    "l1": "l1", "mean_absolute_error": "l1", "mae": "l1", "regression_l1": "l1",
    "l2": "l2", "mean_squared_error": "l2", "mse": "l2", "regression_l2": "l2",
    "regression": "l2",
    "rmse": "rmse", "root_mean_squared_error": "rmse", "l2_root": "rmse",
    "quantile": "quantile", "mape": "mape",
    "mean_absolute_percentage_error": "mape",
    "huber": "huber", "fair": "fair", "poisson": "poisson",
    "gamma": "gamma", "gamma_deviance": "gamma_deviance", "tweedie": "tweedie",
    "ndcg": "ndcg", "lambdarank": "ndcg", "rank_xendcg": "ndcg",
    "xendcg": "ndcg", "xe_ndcg": "ndcg", "xe_ndcg_mart": "ndcg",
    "xendcg_mart": "ndcg",
    "map": "map", "mean_average_precision": "map",
    "precision": "precision",
    "auc": "auc", "average_precision": "average_precision",
    "binary_logloss": "binary_logloss", "binary": "binary_logloss",
    "binary_error": "binary_error",
    "auc_mu": "auc_mu",
    "multi_logloss": "multi_logloss", "multiclass": "multi_logloss",
    "softmax": "multi_logloss", "multiclassova": "multi_logloss",
    "multi_error": "multi_error",
    "cross_entropy": "cross_entropy", "xentropy": "cross_entropy",
    "cross_entropy_lambda": "cross_entropy_lambda",
    "xentlambda": "cross_entropy_lambda",
    "kullback_leibler": "kldiv", "kldiv": "kldiv",
}

# default metric per objective (reference: Config::GetMetricType)
_OBJECTIVE_DEFAULT_METRIC = {
    "regression": "l2", "regression_l1": "l1", "huber": "huber",
    "fair": "fair", "poisson": "poisson", "quantile": "quantile",
    "mape": "mape", "gamma": "gamma", "tweedie": "tweedie",
    "binary": "binary_logloss",
    "multiclass": "multi_logloss", "multiclassova": "multi_logloss",
    "cross_entropy": "cross_entropy",
    "cross_entropy_lambda": "cross_entropy_lambda",
    "lambdarank": "ndcg", "rank_xendcg": "ndcg",
}


class Metric:
    name = "base"
    greater_is_better = False

    def __init__(self, config: Config) -> None:
        self.config = config

    def init(self, metadata, num_data: int) -> None:
        self.num_data = num_data
        self.label = (None if metadata.label is None
                      else np.asarray(metadata.label, np.float64))
        self.weight = (None if metadata.weight is None
                       else np.asarray(metadata.weight, np.float64))
        self.sum_weight = (float(np.sum(self.weight)) if self.weight is not None
                           else float(num_data))

    def eval(self, scores: np.ndarray) -> List[Tuple[str, float]]:
        """scores: converted predictions, [N], or [K, N] for the multiclass
        metrics. Returns [(name, value)]."""
        raise NotImplementedError

    def _avg(self, pointwise: np.ndarray) -> float:
        if self.weight is not None:
            return float(np.sum(pointwise * self.weight) / self.sum_weight)
        return float(np.mean(pointwise))


def register_metric(cls: Type[Metric]) -> Type[Metric]:
    _REGISTRY[cls.name] = cls
    return cls


def metric_names_for(config: Config) -> List[str]:
    """Canonical metric names for ``config.metric`` (the objective's
    default when empty)."""
    if not config.metric:
        default = _OBJECTIVE_DEFAULT_METRIC.get(config.objective)
        return [default] if default else []
    names: List[str] = []
    for m in config.metric:
        key = str(m).strip().lower()
        if key in ("", "none", "na", "null", "custom"):
            continue
        canon = _METRIC_ALIASES.get(key, key)
        if canon not in names:
            names.append(canon)
    return names


def create_metrics(config: Config, metadata, num_data: int) -> List[Metric]:
    out: List[Metric] = []
    for name in metric_names_for(config):
        if name not in _REGISTRY:
            # the JAX package warns and skips; the port ignores no option
            log.fatal("Unknown metric %s", name)
        m = _REGISTRY[name](config)
        m.init(metadata, num_data)
        out.append(m)
    return out
