"""The loaded-model side of the GBDT booster.

The port of ``lambdagap_tpu/models/gbdt.py`` for a model loaded from
LightGBM v4 text: parse (``from_model_string`` / ``from_model_file``),
slice, predict on the configured device engine, and save back. Training
(``train_one_iter`` and everything around it) waits for the training
slice.

Every predict goes to the device engine: the JAX package's <=512-row native
``fastpred`` shortcut is not ported. ``predict_engine=compiled`` runs the
compiled artifact through the CUDA traversal kernel; ``scan`` runs the
per-tree oracle. Both return bit-identical raw scores.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import Config
from ..objectives import ObjectiveFunction, create_objective
from ..ops.predict import forest_to_arrays, predict_forest
from ..utils import log
from ..utils.device import resolve_device
from .tree import Tree


class GBDT:
    """Gradient Boosting Decision Tree booster (loaded model)."""

    average_output = False   # True for RF (reference: rf.hpp average_output_)

    def __init__(self, config: Config) -> None:
        self.config = config
        self.device = resolve_device(config.device_type)
        self.models: List[Tree] = []           # flat: iter-major, class-minor
        self.max_feature_idx = 0
        # predict caches + model generation id: the generation bumps on any
        # in-place mutation of the served forest, and the caches key on it
        # so a stale compiled forest can never be served
        self.generation = 0
        self._forest_cache = None
        self._compiled_cache = None
        self.objective: Optional[ObjectiveFunction] = create_objective(config)
        self.num_class = (self.objective.num_class if self.objective
                          else config.num_class)
        self.num_tree_per_iteration = max(self.num_class, 1)

    # ------------------------------------------------------------------
    def _tree(self, i: int) -> Tree:
        return self.models[i]

    @property
    def host_models(self) -> List[Tree]:
        return self.models

    def _model_slice(self, start_iteration: int, num_iteration: int):
        K = self.num_tree_per_iteration
        end = len(self.models) if num_iteration < 0 else min(
            len(self.models), (start_iteration + num_iteration) * K)
        return list(range(start_iteration * K, end))

    def _check_predict_shape(self, data: np.ndarray) -> np.ndarray:
        """A matrix with fewer columns than the model's max split feature
        would silently mis-gather; fail loudly unless
        predict_disable_shape_check pads the missing columns with NaN
        (reference: c_api predict shape check + the override flag)."""
        key = len(self.models)
        cached = getattr(self, "_need_feats", None)
        if cached is None or cached[0] != key:
            need = 1 + max(
                (max(t.split_feature[:t.num_internal], default=0)
                 for t in self.models), default=0) if self.models else 0
            self._need_feats = (key, need)
        need = self._need_feats[1]
        if data.ndim != 2:
            log.fatal("predict expects a 2-D matrix, got shape %s",
                      (data.shape,))
        if data.shape[1] >= need:
            return data
        if not self.config.predict_disable_shape_check:
            log.fatal("The number of features in data (%d) is less than the "
                      "model needs (%d); set predict_disable_shape_check="
                      "true to pad missing features with NaN",
                      data.shape[1], need)
        pad = np.full((data.shape[0], need - data.shape[1]), np.nan,
                      dtype=data.dtype)
        return np.concatenate([data, pad], axis=1)

    def invalidate_predict_cache(self) -> None:
        """Drop every cached predict-side view of the forest and bump the
        model generation (call after mutating tree payloads in place or
        flipping ``predict_engine`` on a live booster)."""
        self._forest_cache = None
        self._compiled_cache = None
        self.generation += 1

    def _es_freq(self) -> int:
        """Margin-based prediction early stop, classification only
        (reference: src/boosting/prediction_early_stop.cpp). freq counts
        boosting iterations; trees are iter-major, so the per-tree check
        interval is freq*K."""
        K = self.num_tree_per_iteration
        return (self.config.pred_early_stop_freq * K
                if self.config.pred_early_stop and self.objective is not None
                and self.objective.name in ("binary", "multiclass",
                                            "multiclassova") else 0)

    def _device_forest(self, idx):
        """Stacked tensor forest on the booster's device for the scan
        engine, cached per generation and slice. Returns (forest, depth,
        tree_class)."""
        key = (self.generation, len(self.models), idx[0], idx[-1], len(idx))
        cache = self._forest_cache
        if cache is None or cache[0] != key:
            K = self.num_tree_per_iteration
            forest, depth = forest_to_arrays([self._tree(i) for i in idx],
                                             device=self.device)
            self._forest_cache = (key, (forest, depth, [i % K for i in idx]))
        return self._forest_cache[1]

    def _compiled_forest(self, start_iteration: int, num_iteration: int,
                         es_freq: int = 0):
        """Cached compiled-forest view (``infer/``): the forest is lowered
        ONCE — pruned, merged, palette-quantized, blocked — and the
        CompiledForest holds the device-resident tables across calls."""
        cfg = self.config
        key = (self.generation, len(self.models), start_iteration,
               num_iteration, es_freq,
               float(cfg.pred_early_stop_margin), cfg.infer_quant,
               cfg.infer_prune, cfg.infer_merge_trees,
               cfg.infer_node_block_kb)
        cache = self._compiled_cache
        if cache is None or cache[0] != key:
            from ..infer import CompiledForest, compile_forest
            artifact = compile_forest(self, start_iteration, num_iteration)
            self._compiled_cache = (key, CompiledForest(
                artifact, self.device, early_stop_freq=es_freq,
                early_stop_margin=float(cfg.pred_early_stop_margin)))
        return self._compiled_cache[1]

    def _predict_raw_device(self, data: np.ndarray, start_iteration: int,
                            num_iteration: int) -> torch.Tensor:
        """Raw scores [K, N] f32 on the booster's device (before
        averaging)."""
        idx = self._model_slice(start_iteration, num_iteration)
        K = self.num_tree_per_iteration
        x = torch.from_numpy(np.ascontiguousarray(data)).to(self.device)
        if not idx:
            return torch.zeros((K, x.shape[0]), dtype=torch.float32,
                               device=self.device)
        es_freq = self._es_freq()
        if self.config.predict_engine == "compiled":
            return self._compiled_forest(start_iteration, num_iteration,
                                         es_freq).predict(x)
        if any(getattr(self._tree(i), "is_linear", False) for i in idx):
            raise NotImplementedError(
                "linear-leaf forests are not ported to lambdagap_tpu_torch "
                "yet (ROADMAP.md, port queue: linear leaves)")
        forest, depth, tree_class = self._device_forest(idx)
        return predict_forest(
            x, forest, tree_class, K, depth, early_stop_freq=es_freq,
            early_stop_margin=float(self.config.pred_early_stop_margin))

    def predict_raw(self, data: np.ndarray, start_iteration: int = 0,
                    num_iteration: int = -1) -> np.ndarray:
        """Raw scores for new data [N, D] -> [N] or [N, K]."""
        data = self._check_predict_shape(np.asarray(data, dtype=np.float32))
        K = self.num_tree_per_iteration
        res = self._predict_raw_device(data, start_iteration,
                                       num_iteration).cpu().numpy()
        if self.average_output:
            idx = self._model_slice(start_iteration, num_iteration)
            res = res / max(1, len(idx) // max(K, 1))
        return res[0] if K == 1 else res.T

    def predict(self, data: np.ndarray, raw_score: bool = False,
                start_iteration: int = 0, num_iteration: int = -1
                ) -> np.ndarray:
        raw = self.predict_raw(data, start_iteration, num_iteration)
        if raw_score or self.objective is None:
            return raw
        stacked = raw.T if raw.ndim == 2 else raw[None, :]
        conv = self.objective.convert_output(
            torch.from_numpy(np.ascontiguousarray(stacked)).to(self.device)
        ).cpu().numpy()
        return conv[0] if self.num_tree_per_iteration == 1 else conv.T

    # ------------------------------------------------------------------
    # serialization
    # ------------------------------------------------------------------
    @property
    def feature_names(self) -> List[str]:
        return getattr(self, "_feature_names",
                       [f"Column_{i}" for i in range(self.max_feature_idx + 1)])

    def objective_string(self) -> str:
        if self.objective is None:
            return getattr(self, "_objective_string", "custom")
        name = self.objective.name
        if name == "binary":
            return f"binary sigmoid:{self.config.sigmoid:g}"
        if name == "multiclass":
            return f"multiclass num_class:{self.num_class}"
        if name == "multiclassova":
            return (f"multiclassova num_class:{self.num_class} "
                    f"sigmoid:{self.config.sigmoid:g}")
        if name == "regression" and getattr(self.objective, "sqrt", False):
            return "regression sqrt"
        return name

    def feature_infos(self) -> List[str]:
        """Per-feature value ranges, as the loaded text carried them."""
        return getattr(self, "_feature_infos", [])

    def save_model_to_string(self, start_iteration: int = 0,
                             num_iteration: int = -1,
                             importance_type: int = 0) -> str:
        from .model_text import save_model_to_string
        return save_model_to_string(self, start_iteration, num_iteration,
                                    importance_type)

    def save_model(self, filename: str, start_iteration: int = 0,
                   num_iteration: int = -1, importance_type: int = 0) -> None:
        with open(filename, "w") as f:
            f.write(self.save_model_to_string(start_iteration, num_iteration,
                                              importance_type))

    @classmethod
    def from_model_string(cls, text: str, config: Optional[Config] = None):
        """Load a saved model for prediction
        (reference: GBDT::LoadModelFromString, gbdt_model_text.cpp)."""
        from .model_text import load_model_from_string
        header, trees = load_model_from_string(text)
        return cls.from_trees(header, trees, config)

    @classmethod
    def from_model_file(cls, filename: str, config: Optional[Config] = None):
        with open(filename) as f:
            return cls.from_model_string(f.read(), config)

    @classmethod
    def from_trees(cls, header: Dict[str, str], trees: List[Tree],
                   config: Optional[Config] = None):
        """A booster over already-built trees and a model-text header dict
        (``objective``, ``num_class``, ``max_feature_idx``,
        ``feature_names``, ``feature_infos``, ``average_output``) — what
        the text parser yields and what ``convert.booster_from_numpy``
        assembles."""
        cfg = config or Config()
        obj_str = header.get("objective", "regression").split(" ")[0]
        params = {"objective": obj_str} if obj_str != "custom" else {}
        for tok in header.get("objective", "").split(" ")[1:]:
            if ":" in tok:
                k, v = tok.split(":", 1)
                params[k] = v
            elif tok == "sqrt":
                params["reg_sqrt"] = True
        if "num_class" in header:
            params["num_class"] = int(header["num_class"])
        cfg.update(params)
        booster = cls(cfg)
        booster.models = list(trees)
        booster.max_feature_idx = int(header.get("max_feature_idx", 0))
        if header.get("average_output"):
            booster.average_output = True
        booster._feature_names = header.get("feature_names", "").split()
        booster._feature_infos = header.get("feature_infos", "").split()
        booster._objective_string = header.get("objective", "custom")
        return booster
