"""The user-facing ``Dataset`` and ``Booster``.

The port of ``lambdagap_tpu/basic.py`` for dense numpy data and every
objective's training flow: ``Dataset(X, label=, weight=,
group=, position=, reference=, categorical_feature=, params=)`` bins
lazily on first use (``group`` takes query sizes or per-row query ids);
``Booster(params, train_set)`` trains one iteration per ``update()``;
``Booster(params, model_file=..., model_str=...)`` loads a LightGBM v4
text model; both predict, serve (``as_server``) and save. Entry points run
on the card by default (``device_type="cuda"``, raising where there is
none); ``params={"device_type": "cpu"}`` runs every kernel's plain version
on the CPU. ``pred_leaf`` / ``pred_contrib``, pandas / Arrow / sparse /
file inputs, ``refit`` and ``rollback_one_iter`` wait for later slices.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

import numpy as np

from .config import Config
from .data.dataset import BinnedDataset
from .models.gbdt import GBDT
from .utils import log


def _to_matrix(data) -> np.ndarray:
    """A 2-D float32 matrix from anything numpy can convert."""
    return np.asarray(data, dtype=np.float32)


class Dataset:
    """Training data with lazy construction (reference: basic.py:1744
    Dataset._lazy_init). ``data`` is a dense matrix (float32 and float64
    stay as they are — binning reads them exactly — other types convert to
    float64 as the JAX package converts them) or an already-binned
    ``BinnedDataset``."""

    def __init__(self, data, label=None, reference: Optional["Dataset"] = None,
                 weight=None, group=None, init_score=None,
                 feature_name: Union[str, List[str]] = "auto",
                 categorical_feature: Union[str, List] = "auto",
                 params: Optional[Dict[str, Any]] = None,
                 position=None) -> None:
        self.data = data
        self.label = label
        self.reference = reference
        self.weight = weight
        self.group = group
        self.init_score = init_score
        self.position = position
        self.feature_name = feature_name
        self.categorical_feature = categorical_feature
        self.params = dict(params) if params else {}
        self._constructed: Optional[BinnedDataset] = None

    def construct(self, config: Optional[Config] = None) -> BinnedDataset:
        if self._constructed is not None:
            return self._constructed
        if isinstance(self.data, BinnedDataset):
            # an already-binned dataset (convert.dataset_from_numpy) passes
            # through as it is
            self._constructed = self.data
            md = self._constructed.metadata
            if self.group is not None and md.query_boundaries is None:
                md.set_group(np.asarray(self.group))
            md.check(self._constructed.num_data)
            return self._constructed
        cfg = config or Config.from_params(self.params)
        mat = np.asarray(self.data)
        if mat.dtype not in (np.float32, np.float64):
            mat = mat.astype(np.float64)
        names = ([str(n) for n in self.feature_name]
                 if isinstance(self.feature_name, (list, tuple)) else None)
        categorical: List[int] = []
        if isinstance(self.categorical_feature, (list, tuple)):
            for c in self.categorical_feature:
                if isinstance(c, str) and names and c in names:
                    categorical.append(names.index(c))
                elif isinstance(c, (int, np.integer)):
                    categorical.append(int(c))
        ref = (self.reference.construct(config)
               if self.reference is not None else None)
        self._constructed = BinnedDataset.from_matrix(
            mat, cfg, label=self.label, weight=self.weight,
            init_score=self.init_score, group=self.group,
            position=self.position, categorical_features=categorical,
            feature_names=names, reference=ref)
        self.data = None
        return self._constructed

    def num_data(self) -> int:
        return (self._constructed.num_data if self._constructed is not None
                else np.shape(self.data)[0])

    def num_feature(self) -> int:
        return (self._constructed.num_total_features
                if self._constructed is not None else np.shape(self.data)[1])

    def create_valid(self, data, label=None, weight=None, group=None,
                     init_score=None, params=None, position=None
                     ) -> "Dataset":
        return Dataset(data, label=label, reference=self, weight=weight,
                       group=group, init_score=init_score, params=params,
                       position=position, feature_name=self.feature_name,
                       categorical_feature=self.categorical_feature)

    def set_group(self, group) -> "Dataset":
        self.group = group
        if self._constructed is not None:
            self._constructed.metadata.set_group(
                None if group is None else np.asarray(group))
        return self

    def set_position(self, position) -> "Dataset":
        self.position = position
        if self._constructed is not None and position is not None:
            self._constructed.metadata.position = \
                np.asarray(position, np.int32).reshape(-1)
        return self

    def get_label(self):
        if self._constructed is not None:
            return self._constructed.metadata.label
        return self.label

    def get_group(self):
        """Group sizes (from the boundaries once constructed)."""
        if self._constructed is not None and \
                self._constructed.metadata.query_boundaries is not None:
            return np.diff(self._constructed.metadata.query_boundaries)
        return self.group


class Booster:
    """Boosting model wrapper (reference: basic.py:3541 Booster)."""

    def __init__(self, params: Optional[Dict[str, Any]] = None,
                 train_set: Optional[Dataset] = None,
                 model_file: Optional[str] = None,
                 model_str: Optional[str] = None) -> None:
        params = params or {}
        self.params = params
        self.best_iteration = -1
        self.best_score: Dict[str, Dict[str, float]] = {}
        if train_set is not None:
            cfg = Config.from_params(params)
            self._booster = GBDT(cfg, train_set.construct(cfg))
        elif model_file is not None:
            self._booster = GBDT.from_model_file(model_file,
                                                 Config.from_params(params))
        elif model_str is not None:
            self._booster = GBDT.from_model_string(model_str,
                                                   Config.from_params(params))
        else:
            log.fatal("Booster needs train_set, model_file or model_str")
        self.config = self._booster.config

    @classmethod
    def _from_gbdt(cls, gbdt: GBDT, params: Optional[Dict[str, Any]] = None
                   ) -> "Booster":
        b = cls.__new__(cls)
        b.params = dict(params or {})
        b.best_iteration = -1
        b.best_score = {}
        b._booster = gbdt
        b.config = gbdt.config
        return b

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------
    def add_valid(self, data: Dataset, name: str) -> "Booster":
        self._booster.add_valid_set(data.construct(self.config), name)
        return self

    def update(self) -> bool:
        """One boosting iteration; returns True if training should stop
        (reference: basic.py:4050 Booster.update)."""
        return self._booster.train_one_iter()

    @property
    def current_iteration(self) -> int:
        return self._booster.iter_

    def eval_train(self):
        return self._booster.eval_train()

    def eval_valid(self):
        return self._booster.eval_valid()

    # ------------------------------------------------------------------
    def num_trees(self) -> int:
        return len(self._booster.models)

    def predict(self, data, raw_score: bool = False, start_iteration: int = 0,
                num_iteration: int = -1, pred_leaf: bool = False,
                pred_contrib: bool = False, **kwargs) -> np.ndarray:
        if pred_leaf or pred_contrib:
            raise NotImplementedError(
                "pred_leaf / pred_contrib are not ported to "
                "lambdagap_tpu_torch yet (ROADMAP.md, port queue)")
        return self._booster.predict(_to_matrix(data), raw_score=raw_score,
                                     start_iteration=start_iteration,
                                     num_iteration=num_iteration)

    def save_model(self, filename: str, num_iteration: Optional[int] = None,
                   start_iteration: int = 0,
                   importance_type: str = None) -> "Booster":
        if importance_type is None:
            importance_type = ("gain" if getattr(
                self._booster.config, "saved_feature_importance_type", 0)
                else "split")
        it = {"split": 0, "gain": 1}.get(importance_type, 0)
        ni = -1 if num_iteration is None else num_iteration
        self._booster.save_model(filename, start_iteration, ni, it)
        return self

    def model_to_string(self, num_iteration: Optional[int] = None,
                        start_iteration: int = 0,
                        importance_type: str = "split") -> str:
        it = {"split": 0, "gain": 1}.get(importance_type, 0)
        ni = -1 if num_iteration is None else num_iteration
        return self._booster.save_model_to_string(start_iteration, ni, it)

    def num_feature(self) -> int:
        return len(self._booster.feature_names)

    def num_model_per_iteration(self) -> int:
        return self._booster.num_tree_per_iteration

    def as_server(self, **kwargs) -> "ForestServer":
        """Wrap this booster in a batched inference server
        (``lambdagap_tpu_torch.serve.ForestServer``): the forest is lowered
        and uploaded to the device once, and concurrent
        ``predict``/``submit`` calls are coalesced into padded device
        batches."""
        from .serve import ForestServer
        return ForestServer(self, **kwargs)
