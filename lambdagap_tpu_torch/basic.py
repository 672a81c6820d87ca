"""The user-facing ``Booster`` for loaded models.

The port of the loaded-model half of ``lambdagap_tpu/basic.py``:
``Booster(params, model_file=..., model_str=...)``, ``predict``,
``as_server``, ``model_to_string`` / ``save_model``. It runs on the card
by default (``device_type="cuda"``); ``params={"device_type": "cpu"}``
runs every kernel's plain version on the CPU. Training (``train_set``),
``Dataset`` and ``pred_leaf`` / ``pred_contrib`` wait for later slices.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from .config import Config
from .models.gbdt import GBDT
from .utils import log


def _to_matrix(data) -> np.ndarray:
    """A 2-D float32 matrix from anything numpy can convert."""
    return np.asarray(data, dtype=np.float32)


class Booster:
    """Boosting model wrapper (reference: basic.py:3541 Booster)."""

    def __init__(self, params: Optional[Dict[str, Any]] = None,
                 train_set=None,
                 model_file: Optional[str] = None,
                 model_str: Optional[str] = None) -> None:
        params = params or {}
        self.params = params
        if train_set is not None:
            raise NotImplementedError(
                "training is not ported to lambdagap_tpu_torch yet "
                "(ROADMAP.md, port slice 2: the binary training flow)")
        if model_file is not None:
            self._booster = GBDT.from_model_file(model_file,
                                                 Config.from_params(params))
        elif model_str is not None:
            self._booster = GBDT.from_model_string(model_str,
                                                   Config.from_params(params))
        else:
            log.fatal("Booster needs model_file or model_str")
        self.config = self._booster.config

    @classmethod
    def _from_gbdt(cls, gbdt: GBDT, params: Optional[Dict[str, Any]] = None
                   ) -> "Booster":
        b = cls.__new__(cls)
        b.params = dict(params or {})
        b._booster = gbdt
        b.config = gbdt.config
        return b

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
