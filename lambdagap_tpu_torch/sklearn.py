"""scikit-learn estimator wrappers over the port's ``train``.

The port of ``lambdagap_tpu/sklearn.py`` (reference:
python-package/lightgbm/sklearn.py — LGBMModel, LGBMClassifier,
LGBMRegressor, LGBMRanker). Names keep the LGBM prefix so a user switches
imports without code changes. Estimators train on the card unless
``device_type="cpu"`` is passed (it rides ``**kwargs`` into the params).
A callable ``objective`` or ``eval_metric`` raises NotImplementedError
naming the knob: the JAX package's wrappers have no such path (custom
gradients and metrics go through ``Booster.update(fobj=)`` and
``train(feval=)``). ``fit(init_model=)`` (a Booster or a model file)
continues training.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from .basic import Booster, Dataset
from .engine import train as train_fn
from .utils import log


class LGBMModel:
    """Base sklearn-style estimator (reference: sklearn.py LGBMModel)."""

    _objective_default = "regression"

    def __init__(self, boosting_type: str = "gbdt", num_leaves: int = 31,
                 max_depth: int = -1, learning_rate: float = 0.1,
                 n_estimators: int = 100, subsample_for_bin: int = 200000,
                 objective: Optional[str] = None, class_weight=None,
                 min_split_gain: float = 0.0, min_child_weight: float = 1e-3,
                 min_child_samples: int = 20, subsample: float = 1.0,
                 subsample_freq: int = 0, colsample_bytree: float = 1.0,
                 reg_alpha: float = 0.0, reg_lambda: float = 0.0,
                 random_state: Optional[int] = None, n_jobs: int = -1,
                 importance_type: str = "split", **kwargs: Any) -> None:
        self.boosting_type = boosting_type
        self.num_leaves = num_leaves
        self.max_depth = max_depth
        self.learning_rate = learning_rate
        self.n_estimators = n_estimators
        self.subsample_for_bin = subsample_for_bin
        self.objective = objective
        self.class_weight = class_weight
        self.min_split_gain = min_split_gain
        self.min_child_weight = min_child_weight
        self.min_child_samples = min_child_samples
        self.subsample = subsample
        self.subsample_freq = subsample_freq
        self.colsample_bytree = colsample_bytree
        self.reg_alpha = reg_alpha
        self.reg_lambda = reg_lambda
        self.random_state = random_state
        self.n_jobs = n_jobs
        self.importance_type = importance_type
        self._other_params = dict(kwargs)
        self._Booster: Optional[Booster] = None
        self._n_features: Optional[int] = None
        self._classes: Optional[np.ndarray] = None
        self.best_iteration_: int = -1

    # -- sklearn protocol ------------------------------------------------
    def get_params(self, deep: bool = True) -> Dict[str, Any]:
        params = {k: getattr(self, k) for k in (
            "boosting_type", "num_leaves", "max_depth", "learning_rate",
            "n_estimators", "subsample_for_bin", "objective", "class_weight",
            "min_split_gain", "min_child_weight", "min_child_samples",
            "subsample", "subsample_freq", "colsample_bytree", "reg_alpha",
            "reg_lambda", "random_state", "n_jobs", "importance_type")}
        params.update(self._other_params)
        return params

    def set_params(self, **params: Any) -> "LGBMModel":
        for k, v in params.items():
            if hasattr(self, k):
                setattr(self, k, v)
            else:
                self._other_params[k] = v
        return self

    def _train_params(self) -> Dict[str, Any]:
        if callable(self.objective):
            raise NotImplementedError(
                "a callable objective is not supported by the wrappers, as "
                "in the JAX package; train custom gradients with "
                "Booster.update(fobj=)")
        p = {
            "boosting": self.boosting_type,
            "num_leaves": self.num_leaves,
            "max_depth": self.max_depth,
            "learning_rate": self.learning_rate,
            "num_iterations": self.n_estimators,
            "bin_construct_sample_cnt": self.subsample_for_bin,
            "objective": self.objective or self._objective_default,
            "min_gain_to_split": self.min_split_gain,
            "min_sum_hessian_in_leaf": self.min_child_weight,
            "min_data_in_leaf": self.min_child_samples,
            "bagging_fraction": self.subsample,
            "bagging_freq": self.subsample_freq,
            "feature_fraction": self.colsample_bytree,
            "lambda_l1": self.reg_alpha,
            "lambda_l2": self.reg_lambda,
            "verbose": -1,
        }
        if self.random_state is not None:
            p["seed"] = int(self.random_state)
        p.update(self._other_params)
        return p

    def _sample_weight(self, y, sample_weight):
        if self.class_weight is not None and self._classes is not None:
            if self.class_weight == "balanced":
                counts = np.bincount(y.astype(int),
                                     minlength=len(self._classes))
                w_per_class = len(y) / np.maximum(
                    counts * len(self._classes), 1)
            else:
                w_per_class = np.asarray(
                    [self.class_weight.get(c, 1.0) for c in self._classes])
            cw = w_per_class[y.astype(int)]
            sample_weight = cw if sample_weight is None else sample_weight * cw
        return sample_weight

    def fit(self, X, y, sample_weight=None, init_score=None, group=None,
            eval_set=None, eval_names=None, eval_sample_weight=None,
            eval_group=None, eval_metric=None, feature_name="auto",
            categorical_feature="auto", callbacks=None,
            init_model=None) -> "LGBMModel":
        params = self._train_params()
        if eval_metric is not None:
            if callable(eval_metric) or (
                    isinstance(eval_metric, (list, tuple))
                    and any(callable(m) for m in eval_metric)):
                raise NotImplementedError(
                    "a callable eval_metric is not supported by the "
                    "wrappers, as in the JAX package; pass feval= to "
                    "lgt.train")
            params["metric"] = eval_metric
        y = np.asarray(y)
        sample_weight = self._sample_weight(y, sample_weight)
        ds = Dataset(X, label=y, weight=sample_weight, init_score=init_score,
                     group=group, feature_name=feature_name,
                     categorical_feature=categorical_feature)
        valid_sets: List[Dataset] = []
        if eval_set is not None:
            for i, (Xe, ye) in enumerate(eval_set):
                vw = (eval_sample_weight[i]
                      if eval_sample_weight is not None else None)
                vg = eval_group[i] if eval_group is not None else None
                valid_sets.append(ds.create_valid(Xe, label=np.asarray(ye),
                                                  weight=vw, group=vg))
        self._Booster = train_fn(params, ds,
                                 num_boost_round=self.n_estimators,
                                 valid_sets=valid_sets,
                                 valid_names=eval_names,
                                 init_model=init_model,
                                 callbacks=callbacks)
        self.best_iteration_ = self._Booster.best_iteration
        self._n_features = ds.num_feature()
        return self

    def predict(self, X, raw_score: bool = False, start_iteration: int = 0,
                num_iteration: Optional[int] = None, pred_leaf: bool = False,
                pred_contrib: bool = False, **kwargs) -> np.ndarray:
        self._check_fitted()
        ni = -1 if num_iteration is None else num_iteration
        return self._Booster.predict(X, raw_score=raw_score,
                                     start_iteration=start_iteration,
                                     num_iteration=ni, pred_leaf=pred_leaf,
                                     pred_contrib=pred_contrib)

    def _check_fitted(self) -> None:
        if self._Booster is None:
            raise RuntimeError("Estimator not fitted; call fit() first")

    # -- sklearn attributes ----------------------------------------------
    @property
    def booster_(self) -> Booster:
        self._check_fitted()
        return self._Booster

    @property
    def feature_importances_(self) -> np.ndarray:
        self._check_fitted()
        return self._Booster.feature_importance(self.importance_type)

    @property
    def n_features_(self) -> int:
        self._check_fitted()
        return self._n_features

    @property
    def n_features_in_(self) -> int:
        return self.n_features_

    @property
    def n_estimators_(self) -> int:
        self._check_fitted()
        return self._Booster.num_trees() // max(
            self._Booster.num_model_per_iteration(), 1)

    @property
    def feature_name_(self) -> List[str]:
        self._check_fitted()
        return self._Booster.feature_name()


class LGBMRegressor(LGBMModel):
    _objective_default = "regression"

    def _more_tags(self):
        return {"estimator_type": "regressor"}


class LGBMClassifier(LGBMModel):
    _objective_default = "binary"

    def fit(self, X, y, **kwargs) -> "LGBMClassifier":
        y = np.asarray(y)
        self._classes = np.unique(y)
        n_classes = len(self._classes)
        y_enc = np.searchsorted(self._classes, y).astype(np.float64)
        if n_classes > 2:
            if self.objective is None:
                self.objective = "multiclass"
            self._other_params.setdefault("num_class", n_classes)
        elif self.objective is None:
            self.objective = "binary"
        return super().fit(X, y_enc, **kwargs)

    @property
    def classes_(self) -> np.ndarray:
        self._check_fitted()
        return self._classes

    @property
    def n_classes_(self) -> int:
        return len(self._classes)

    def predict_proba(self, X, **kwargs) -> np.ndarray:
        p = super().predict(X, **kwargs)
        if p.ndim == 1:
            return np.column_stack([1.0 - p, p])
        return p

    def predict(self, X, raw_score: bool = False, **kwargs) -> np.ndarray:
        p = super().predict(X, raw_score=raw_score, **kwargs)
        if raw_score or kwargs.get("pred_leaf") or kwargs.get("pred_contrib"):
            return p
        if p.ndim == 1:
            idx = (p > 0.5).astype(int)
        else:
            idx = np.argmax(p, axis=1)
        return self._classes[idx]


class LGBMRanker(LGBMModel):
    _objective_default = "lambdarank"

    def fit(self, X, y, group=None, **kwargs) -> "LGBMRanker":
        if group is None and "eval_group" not in kwargs:
            log.fatal("LGBMRanker.fit requires the `group` argument")
        return super().fit(X, y, group=group, **kwargs)
