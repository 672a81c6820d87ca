"""The GBDT booster: training and the loaded-model side.

The port of ``lambdagap_tpu/models/gbdt.py``. A loaded model (LightGBM v4
text: ``from_model_string`` / ``from_model_file``) is sliced, predicted on
the configured device engine and saved back. Training (``GBDT(config,
train_set)``) runs the JAX package's fused fast path: per iteration the
objective's gradients for all K classes at once, the bagging/GOSS sample
of them (``models/sample_strategy``), then one tree per class grown on the
device by
:class:`~lambdagap_tpu_torch.models.fused_learner.FusedTreeLearner`, the
training scores updated on the device with ``f32(leaf_value *
shrinkage)[row_leaf]``, and every validation set scored tree by tree over
its binned matrix. Trees stay on the device until a host view is needed
(save, predict), then materialize in one batched transfer with the
f32-rounded shrinkage of ``_finalize_tree``.

Objectives that refit their leaves (the L1 family: ``regression_l1``,
``quantile``, ``mape``) take the JAX package's host-tree path instead
(``_train_renewed``): the tree is grown on the device and materialized,
each leaf refit on the host by the weighted percentile of its in-bag
residuals, the shrinkage applied to the host tree in float64, and the
scores updated with ``f32(leaf_value)[row_leaf]``. That path stops when no
class's tree splits, as the JAX package's does.

Validation scores take each tree's leaf values as the training scores
take them; the boost-from-average init score is added to them once, before
the first tree. (The JAX package's fast path adds that init score a second
time through the first tree's bias when a validation set is attached;
ROADMAP.md, Queue 3.)

Options the port does not train yet raise NotImplementedError naming the
knob (:func:`_refuse_unported`). Every predict goes to the device engine:
the JAX package's <=512-row native ``fastpred`` shortcut is not ported.
``predict_engine=compiled`` runs the compiled artifact through the CUDA
traversal kernel; ``scan`` runs the per-tree oracle. Both return
bit-identical raw scores.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..metrics import create_metrics
from ..objectives import ObjectiveFunction, create_objective
from ..ops.predict import (TreeArrays, forest_to_arrays, predict_forest,
                           predict_tree_binned)
from ..utils import log
from ..utils.device import resolve_device
from .tree import Tree

K_EPSILON = 1e-15
_ROADMAP = "(ROADMAP.md, Queue 1)"


def _apply_shrinkage(tree: Tree, rate: float) -> None:
    """(reference: tree.h Shrinkage) in float64."""
    tree.leaf_value[:tree.num_leaves] *= rate
    tree.internal_value = [v * rate for v in tree.internal_value]
    tree.shrinkage *= rate


def _add_bias(tree: Tree, bias: float) -> None:
    """Fold the boost-from-average init score into a tree (reference:
    Tree::AddBias via gbdt.cpp:421)."""
    if abs(bias) > K_EPSILON:
        tree.leaf_value[:tree.num_leaves] += bias
        tree.internal_value = [v + bias for v in tree.internal_value]


def _finalize_tree(tree: Tree, shrinkage: float, bias: float) -> Tree:
    """Shrinkage + boost-from-average bias fold (gbdt.cpp:415-421). The
    leaf multiply is rounded in float32: the device training scores
    already took ``f32(leaf_value * shrinkage)``, so the serialized leaf
    values must be those products or a reload would disagree with training
    by an ulp."""
    lv32 = (tree.leaf_value[:tree.num_leaves].astype(np.float32)
            * np.float32(shrinkage)).astype(np.float32)
    _apply_shrinkage(tree, shrinkage)
    tree.leaf_value[:tree.num_leaves] = lv32.astype(np.float64)
    _add_bias(tree, bias)
    return tree


class _LazyTree:
    """A trained tree still on the device; materializes to a host Tree on
    first access."""

    __slots__ = ("learner", "rec", "shrinkage", "bias")

    def __init__(self, learner, rec, shrinkage: float, bias: float) -> None:
        self.learner = learner
        self.rec = rec
        self.shrinkage = shrinkage
        self.bias = bias


def _refuse_unported(cfg: Config) -> None:
    """Raise NotImplementedError, naming the knob, for every training option
    the port does not carry yet: none is ignored silently."""
    def no(knob: str) -> None:
        raise NotImplementedError(
            f"{knob} is not ported to lambdagap_tpu_torch yet {_ROADMAP}")

    if cfg.boosting != "gbdt":
        no(f"boosting={cfg.boosting}")
    if cfg.tree_learner != "serial":
        no(f"tree_learner={cfg.tree_learner}")
    if str(cfg.tpu_fused_learner).lower() in ("0", "false", "off", "no"):
        no("tpu_fused_learner=0 (the host-driven SerialTreeLearner)")
    if cfg.data_residency == "stream":
        no("data_residency=stream")
    if cfg.extra_trees:
        no("extra_trees")
    if cfg.feature_fraction_bynode < 1.0:
        no("feature_fraction_bynode<1")
    if cfg.forcedsplits_filename:
        no("forcedsplits_filename (forced splits)")
    if cfg.monotone_constraints and any(int(m) != 0
                                        for m in cfg.monotone_constraints):
        no("monotone_constraints")
    if cfg.interaction_constraints:
        no("interaction_constraints")
    if cfg.cegb_tradeoff > 0 and (cfg.cegb_penalty_split > 0
                                  or cfg.cegb_penalty_feature_coupled
                                  or cfg.cegb_penalty_feature_lazy):
        no("cegb (cegb_penalty_*)")
    if cfg.linear_tree:
        no("linear_tree")
    if cfg.feature_contri:
        no("feature_contri")
    if cfg.snapshot_freq > 0:
        no("snapshot_freq (crash-safe snapshots)")
    if cfg.objective == "none":
        no("training without an objective (custom gradients, fobj)")


class GBDT:
    """Gradient Boosting Decision Tree booster."""

    average_output = False   # True for RF (reference: rf.hpp average_output_)

    def __init__(self, config: Config, train_set=None) -> None:
        self.config = config
        self.device = resolve_device(config.device_type)
        self.models: List = []           # flat: iter-major, class-minor
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
        self.train_set = train_set
        self.iter_ = 0
        self.shrinkage_rate = config.learning_rate
        self.train_metrics = []
        self.valid_sets: List[Tuple[str, object]] = []
        self.valid_binned: List[torch.Tensor] = []
        self.valid_metrics: List[list] = []
        self.valid_scores: List[torch.Tensor] = []
        # host wall (ms) of each tree grown, and of each leaf renew pass, in
        # the last iteration
        self.tree_ms: List[float] = []
        self.renew_ms: List[float] = []
        if train_set is not None:
            self._setup_training(train_set)

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------
    def _setup_training(self, ds) -> None:
        cfg = self.config
        _refuse_unported(cfg)
        from .fused_learner import FusedTreeLearner
        from .sample_strategy import create_sample_strategy
        self.num_data = ds.num_data
        self.max_feature_idx = ds.num_total_features - 1
        self.objective.init(ds.metadata, ds.num_data, self.device)
        self.learner = FusedTreeLearner(ds, cfg, self.device)
        self.sample_strategy = create_sample_strategy(
            cfg, ds.num_data, label=ds.metadata.label,
            query_boundaries=ds.metadata.query_boundaries)
        self.has_init_score = ds.metadata.init_score is not None
        self.scores = self._init_scores(ds.metadata.init_score, ds.num_data)
        if cfg.is_provide_training_metric:
            self.train_metrics = create_metrics(cfg, ds.metadata,
                                                ds.num_data)

    def _init_scores(self, init_score, n: int) -> torch.Tensor:
        K = self.num_tree_per_iteration
        if init_score is None:
            return torch.zeros((K, n), dtype=torch.float32,
                               device=self.device)
        s = np.asarray(init_score, dtype=np.float32)
        s = s.reshape(K, n) if s.size == K * n else np.tile(s, (K, 1))
        return torch.from_numpy(np.ascontiguousarray(s)).to(self.device)

    def add_valid_set(self, ds, name: str) -> None:
        if self.models:
            raise NotImplementedError(
                "adding a validation set after training began is not "
                f"ported to lambdagap_tpu_torch yet {_ROADMAP}")
        self.valid_sets.append((name, ds))
        self.valid_binned.append(torch.from_numpy(
            np.ascontiguousarray(ds.binned)).to(self.device))
        self.valid_metrics.append(create_metrics(self.config, ds.metadata,
                                                 ds.num_data))
        self.valid_scores.append(self._init_scores(ds.metadata.init_score,
                                                   ds.num_data))

    def boosting(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Gradients at the current scores (reference: GBDT::Boosting,
        gbdt.cpp:222-237)."""
        return self.objective.get_gradients_fast(self.scores)

    def train_one_iter(self) -> bool:
        """One boosting iteration. Returns True when training should stop.
        The fast path never does: like the JAX package's, a converged run
        appends constant trees instead of paying a sync to stop."""
        cfg = self.config
        K = self.num_tree_per_iteration
        init_scores = [0.0] * K
        if not self.models and not self.has_init_score \
                and cfg.boost_from_average:
            for k in range(K):
                init = self.objective.boost_from_score(k)
                if abs(init) > K_EPSILON:
                    init_scores[k] = init
                    self.scores[k] += init
                    for vs in self.valid_scores:
                        vs[k] += init
                    log.info("Start training from score %f", init)
        grad, hess = self.boosting()
        grad, hess, mask = self.sample_strategy.sample(self.iter_, grad,
                                                       hess)
        self.tree_ms, self.renew_ms = [], []
        if self.objective.is_renew_tree_output:
            return self._train_renewed(grad, hess, mask, init_scores)
        for k in range(K):
            rec = self._grow(grad[k], hess[k], mask)
            lv = rec.leaf_value * self.shrinkage_rate
            self.scores[k] += lv[rec.row_leaf]
            self._add_valid_tree_score(rec, lv, k)
            # drop the O(N) row -> leaf map from the kept record
            self.models.append(_LazyTree(self.learner,
                                         rec._replace(row_leaf=None),
                                         self.shrinkage_rate,
                                         init_scores[k]))
        self.iter_ += 1
        return False

    def _train_renewed(self, grad, hess, mask, init_scores) -> bool:
        """The JAX package's host-tree path for objectives that refit their
        leaves (gbdt.py:612-660): each class's tree grown on the device and
        materialized; a split tree's leaves refit, shrunk in float64, its
        ``f32(leaf_value)`` added to the scores, the init score folded in;
        an unsplit first tree holds the init score. Stops when no class's
        tree split, dropping that round's trees unless they are the
        first."""
        cfg = self.config
        K = self.num_tree_per_iteration
        should_continue = False
        for k in range(K):
            rec = self._grow(grad[k], hess[k], mask)
            tree = self.learner.materialize(rec)
            if tree.num_leaves > 1:
                should_continue = True
                t0 = time.perf_counter()
                self._renew_tree_output(tree, k, rec.row_leaf, mask)
                self.renew_ms.append((time.perf_counter() - t0) * 1e3)
                _apply_shrinkage(tree, self.shrinkage_rate)
                lv = torch.from_numpy(
                    tree.leaf_value.astype(np.float32)).to(self.device)
                self.scores[k] += lv[rec.row_leaf]
                self._add_valid_tree_score(rec, lv, k)
                _add_bias(tree, init_scores[k])
            elif len(self.models) < K:
                if not cfg.boost_from_average and not self.has_init_score:
                    init_scores[k] = self.objective.boost_from_score(k)
                    self.scores[k] += init_scores[k]
                    for vs in self.valid_scores:
                        vs[k] += init_scores[k]
                tree.leaf_value[0] = init_scores[k]
            self.models.append(tree)
        if not should_continue:
            log.warning("Stopped training because there are no more leaves "
                        "that meet the split requirements")
            if len(self.models) > K:
                del self.models[-K:]
            return True
        self.iter_ += 1
        return False

    def _grow(self, grad, hess, mask):
        """One tree grown on the device; its host wall into ``tree_ms``."""
        t0 = time.perf_counter()
        rec = self.learner.train_device(grad, hess, mask)
        self.tree_ms.append((time.perf_counter() - t0) * 1e3)
        return rec

    def _renew_tree_output(self, tree: Tree, k: int, row_leaf: torch.Tensor,
                           mask: Optional[torch.Tensor]) -> None:
        """The L1-family leaf refit (reference: RenewTreeOutput,
        gbdt.cpp:412): each leaf's value becomes the objective's weighted
        percentile of ``label - score`` over the leaf's in-bag rows, in
        ascending row order as ``np.nonzero`` gives them — one stable
        argsort of ``row_leaf`` orders every leaf's rows at once. The
        scores, ``row_leaf`` and the mask are read to the host once."""
        score = self.scores[k].cpu().numpy()
        leaf_of = row_leaf.cpu().numpy()
        mask_np = None if mask is None else mask.cpu().numpy()
        order = np.argsort(leaf_of, kind="stable")
        ends = np.cumsum(np.bincount(leaf_of, minlength=tree.num_leaves))
        for leaf in range(tree.num_leaves):
            rows = order[ends[leaf - 1] if leaf else 0:ends[leaf]]
            if mask_np is not None:
                rows = rows[mask_np[rows]]
            if len(rows):
                tree.leaf_value[leaf] = self.objective.renew_tree_output(
                    rows, score)

    def _add_valid_tree_score(self, rec, leaf_values: torch.Tensor,
                              k: int) -> None:
        """Add one tree's leaf values to every validation set's class-k
        scores, traversing the tree's device tables over the binned
        matrix."""
        if not self.valid_sets:
            return
        t = self._device_tree_arrays(rec, leaf_values)
        for vi in range(len(self.valid_sets)):
            self.valid_scores[vi][k] += predict_tree_binned(
                self.valid_binned[vi], t, max(rec.max_depth, 1))

    def _device_tree_arrays(self, rec, leaf_values: torch.Tensor):
        """A DeviceTree as the binned TreeArrays of ``ops/predict`` on the
        device, without a host round trip."""
        lr = self.learner
        f = rec.node_feature
        return TreeArrays(
            split_feature=f, threshold=None, threshold_bin=rec.node_threshold,
            default_left=rec.node_default_left,
            missing_type=lr.missing_types_arr[f],
            default_bin=lr.default_bins_arr[f], num_bin=lr.num_bins_arr[f],
            left_child=rec.node_left, right_child=rec.node_right,
            is_categorical=rec.node_is_cat, cat_bitset=rec.node_cat_bits,
            cat_bitset_real=None, leaf_value=leaf_values, leaf_const=None,
            leaf_feat=None, leaf_coeff=None)

    def _converted_scores(self, raw: torch.Tensor) -> np.ndarray:
        out = self.objective.convert_output(raw) if self.objective else raw
        out = out.cpu().numpy().astype(np.float64)
        return out[0] if self.num_tree_per_iteration == 1 else out

    def eval_train(self) -> List[Tuple[str, str, float, bool]]:
        return self._eval("training", self.train_metrics,
                          self._converted_scores(self.scores))

    def eval_valid(self) -> List[Tuple[str, str, float, bool]]:
        out = []
        for vi, (name, _) in enumerate(self.valid_sets):
            out.extend(self._eval(name, self.valid_metrics[vi],
                                  self._converted_scores(
                                      self.valid_scores[vi])))
        return out

    @staticmethod
    def _eval(data_name, metrics, converted):
        return [(data_name, mname, val, m.greater_is_better)
                for m in metrics for mname, val in m.eval(converted)]

    # ------------------------------------------------------------------
    # host views of the forest
    # ------------------------------------------------------------------
    def _materialize_lazy(self) -> None:
        """Every device-resident tree to a host Tree, one batched transfer."""
        lazy = [i for i, m in enumerate(self.models)
                if isinstance(m, _LazyTree)]
        if not lazy:
            return
        trees = self.learner.materialize_batch(
            [self.models[i].rec for i in lazy])
        for i, t in zip(lazy, trees):
            m = self.models[i]
            self.models[i] = _finalize_tree(t, m.shrinkage, m.bias)

    def _tree(self, i: int) -> Tree:
        if isinstance(self.models[i], _LazyTree):
            self._materialize_lazy()
        return self.models[i]

    @property
    def host_models(self) -> List[Tree]:
        self._materialize_lazy()
        return self.models

    # ------------------------------------------------------------------
    # prediction
    # ------------------------------------------------------------------
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
                 for t in self.host_models), default=0) if self.models else 0
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
            self._materialize_lazy()
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
        if self.train_set is not None:
            return self.train_set.feature_names
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
        """Per-feature value ranges (reference: Dataset feature_infos /
        bin.h:224 bin_info_string), or as the loaded text carried them."""
        if self.train_set is None:
            return getattr(self, "_feature_infos", [])
        out = []
        for m in self.train_set.mappers:
            if m.is_trivial:
                out.append("none")
            elif m.bin_type == "categorical":
                cats = [str(c) for c in m.bin_2_categorical[1:]]
                out.append(":".join(cats) if cats else "none")
            else:
                out.append(f"[{m.min_val:g}:{m.max_val:g}]")
        return out

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
