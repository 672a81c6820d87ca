"""DART and random-forest boosting.

The port of ``lambdagap_tpu/models/dart.py`` (reference:
src/boosting/dart.hpp:23 DART — MART with dropout-normalized tree weights;
src/boosting/rf.hpp:25 RF — bagged trees with averaged outputs and
one-time gradients). Both grow their trees through the booster's host-tree
path, whose histograms come from the learner (K1 on the card). The replays
of whole forests over the binned matrices (DART's drop and renormalize,
RF's resumed averages) are torch ops, as they are XLA in the JAX package:
``ops.predict.predict_forest`` over the stacked dropped trees, one dispatch
for all of them.

DART changes the leaf values of trees already in the model; every such
change drops the booster's predict caches and bumps its generation, so a
served DART model never answers with stale leaves. Under
``guard_nonfinite=skip_tree`` ``engine.train``'s guard may drop a round one
round late (``guard/nonfinite.py``): the restore then also undoes that
round's renormalization of the dropped trees (their leaf values, internal
values and shrinkage, saved before the scaling) and its tree weights.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..config import Config
from ..ops.predict import forest_to_arrays, predict_forest
from ..utils import log
from .gbdt import GBDT, K_EPSILON, _add_bias
from .tree import Tree


class DART(GBDT):
    """Drop trees before each iteration, renormalize after (reference:
    dart.hpp DroppingTrees :95-148, Normalize :149-200)."""

    def __init__(self, config: Config, train_set) -> None:
        super().__init__(config, train_set)
        self.drop_rng = np.random.RandomState(config.drop_seed)
        self.tree_weight: List[float] = []
        self.sum_weight = 0.0
        self._drop_stacked = None
        # (round, tree, leaf values, internal values, shrinkage) before each
        # renormalization of the last two rounds, for a late skip_tree
        # restore
        self._scaled: list = []

    def _stack_dropped(self, tree_idx: List[int]):
        """The dropped trees stacked once a round: the drop and the
        renormalization differ only by a leaf-value factor."""
        K = self.num_tree_per_iteration
        trees = [self._tree(i) for i in tree_idx]
        forest, depth = forest_to_arrays(
            trees, feature_meta=self.learner.meta_host,
            use_inner_feature=True, device=self.device)
        return forest, depth, [i % K for i in tree_idx]

    def _forest_score_delta(self, stacked, factor: float, valid: bool,
                            vi: int = 0) -> None:
        """Add ``factor * sum(stacked trees)`` to the training scores or to
        validation set ``vi``'s, one batched binned-forest dispatch (a row
        window at a time over the training rows)."""
        if stacked is None:
            return
        forest, depth, tree_class = stacked
        K = self.num_tree_per_iteration
        forest = forest._replace(leaf_value=forest.leaf_value * factor)
        if valid:
            self.valid_scores[vi] += predict_forest(
                self.valid_binned[vi], forest, tree_class, K, depth,
                binned=True)
            return
        for lo, xw in self._train_windows():
            self.scores[:, lo:lo + xw.shape[0]] += predict_forest(
                xw, forest, tree_class, K, depth, binned=True)

    def resume_from(self, trees: List[Tree]) -> None:
        super().resume_from(trees)
        # the per-iteration tree weights from the cumulative shrinkage each
        # tree carries (shrinkage tracks the DART weight through every past
        # normalization); under xgboost_dart_mode the shrinkage factor
        # (k/(k+lr)) differs from the weight factor (k/(k+1)), so the
        # weights are only approximate there
        if self.config.xgboost_dart_mode and not self.config.uniform_drop:
            log.warning("Resuming DART with xgboost_dart_mode: weighted "
                        "dropout probabilities are reconstructed "
                        "approximately from tree shrinkage")
        K = self.num_tree_per_iteration
        self.tree_weight = [float(self.models[i * K].shrinkage)
                            for i in range(self.iter_)]
        self.sum_weight = float(sum(self.tree_weight))

    def _dropping_trees(self) -> List[int]:
        cfg = self.config
        drop_index: List[int] = []
        if self.drop_rng.rand() >= cfg.skip_drop:
            drop_rate = cfg.drop_rate
            if not cfg.uniform_drop and self.sum_weight > 0:
                inv_avg = len(self.tree_weight) / self.sum_weight
                if cfg.max_drop > 0:
                    drop_rate = min(drop_rate,
                                    cfg.max_drop * inv_avg / self.sum_weight)
                for i in range(self.iter_):
                    if self.drop_rng.rand() < (drop_rate * self.tree_weight[i]
                                               * inv_avg):
                        drop_index.append(i)
                        if len(drop_index) >= cfg.max_drop > 0:
                            break
            else:
                if cfg.max_drop > 0:
                    drop_rate = min(drop_rate,
                                    cfg.max_drop / max(self.iter_, 1))
                for i in range(self.iter_):
                    if self.drop_rng.rand() < drop_rate:
                        drop_index.append(i)
                        if len(drop_index) >= cfg.max_drop > 0:
                            break
        # the dropped trees leave the training scores (one dispatch)
        K = self.num_tree_per_iteration
        idx = [i * K + k for i in drop_index for k in range(K)]
        self._drop_stacked = self._stack_dropped(idx) if idx else None
        self._forest_score_delta(self._drop_stacked, -1.0, valid=False)
        k_drop = len(drop_index)
        if not cfg.xgboost_dart_mode:
            self.shrinkage_rate = cfg.learning_rate / (1.0 + k_drop)
        else:
            self.shrinkage_rate = (cfg.learning_rate if k_drop == 0 else
                                   cfg.learning_rate
                                   / (cfg.learning_rate + k_drop))
        return drop_index

    def _rng_state(self) -> tuple:
        return super()._rng_state() + (self.drop_rng.get_state(),)

    def _set_rng_state(self, st: tuple) -> None:
        super()._set_rng_state(st[:-1])
        self.drop_rng.set_state(st[-1])

    def _guard_state_capture(self) -> dict:
        st = super()._guard_state_capture()
        st["tree_weight"] = list(self.tree_weight)
        st["sum_weight"] = self.sum_weight
        # a restore goes back at most to the previous round's point
        self._scaled = [e for e in self._scaled if e[0] >= self.iter_ - 1]
        return st

    def _guard_state_restore(self, st: dict, rng=None) -> None:
        super()._guard_state_restore(st, rng)
        self.tree_weight = list(st["tree_weight"])
        self.sum_weight = st["sum_weight"]
        undo = [e for e in self._scaled if e[0] >= st["iter"]]
        for _, i, leaf, internal, shrinkage in reversed(undo):
            t = self.models[i]
            t.leaf_value[:] = leaf
            t.internal_value = internal
            t.shrinkage = shrinkage
        self._scaled = [e for e in self._scaled if e[0] < st["iter"]]
        if undo:
            self.invalidate_predict_cache()

    def _one_iter(self, grad, hess):
        # the skip_tree restore point before the dropout changes the scores
        # and the shrinkage (the base round's capture is then a no-op)
        self.guard.begin_iteration(self)
        drop_index = self._dropping_trees()
        ret = super()._one_iter(grad, hess)
        if ret is None or ret:
            return ret
        if self.last_iteration_skipped:
            # the guard restored the pre-dropout state; the dropped trees
            # were never renormalized
            return False
        self._normalize(drop_index)
        if not self.config.uniform_drop:
            self.tree_weight.append(self.shrinkage_rate)
            self.sum_weight += self.shrinkage_rate
        return False

    def _normalize(self, drop_index: List[int]) -> None:
        """Re-add the dropped trees at weight k/(k+1) (reference:
        dart.hpp:149-200 Normalize)."""
        if not drop_index:
            return
        k = float(len(drop_index))
        cfg = self.config
        K = self.num_tree_per_iteration
        factor = (k / (k + 1.0) if not cfg.xgboost_dart_mode
                  else k / (k + cfg.learning_rate))
        idx = [i * K + kk for i in drop_index for kk in range(K)]
        # the validation scores still hold the whole old trees: adjust by
        # (factor - 1); the training scores had them removed: add factor
        # (the trees stacked in _dropping_trees are unchanged since)
        self._forest_score_delta(self._drop_stacked, factor, valid=False)
        for vi in range(len(self.valid_sets)):
            self._forest_score_delta(self._drop_stacked, factor - 1.0,
                                     valid=True, vi=vi)
        keep = self.guard.policy == "skip_tree"
        for i in idx:
            t = self._tree(i)
            if keep:
                self._scaled.append((self.iter_ - 1, i, t.leaf_value.copy(),
                                     list(t.internal_value), t.shrinkage))
            t.apply_shrinkage(factor)
        for i in drop_index:
            if not cfg.uniform_drop and i < len(self.tree_weight):
                self.sum_weight -= self.tree_weight[i] * (1.0 / (k + 1.0))
                self.tree_weight[i] *= k / (k + 1.0)
        self.invalidate_predict_cache()


class RF(GBDT):
    """Random forest: bagged trees, no shrinkage, averaged output
    (reference: rf.hpp:25)."""

    average_output = True

    def __init__(self, config: Config, train_set) -> None:
        if not (config.bagging_freq > 0 and 0 < config.bagging_fraction < 1) \
                and not (0 < config.feature_fraction < 1):
            log.fatal("RF needs bagging (bagging_freq > 0, bagging_fraction "
                      "in (0,1)) or feature_fraction in (0,1)")
        super().__init__(config, train_set)
        self.shrinkage_rate = 1.0
        if self.objective is None:
            log.fatal("RF mode does not support custom objective functions")
        # one-time gradients at the constant init score, on the device
        # (reference: rf.hpp Boosting)
        K, N = self.num_tree_per_iteration, self.num_data
        self.init_scores = [self.objective.boost_from_score(k)
                            for k in range(K)]
        const = torch.tensor(self.init_scores, dtype=torch.float32,
                             device=self.device)[:, None].expand(K, N)
        self._rf_grad, self._rf_hess = self.objective.get_gradients_fast(
            const.contiguous())

    def resume_from(self, trees: List[Tree]) -> None:
        super().resume_from(trees)
        # RF scores are running averages, not sums (rf.hpp MultiplyScore);
        # RF training also wipes an init_score baseline at iteration 0 (the
        # multiply by 0), so it is taken out before averaging
        if self.iter_ > 0:
            K, N = self.num_tree_per_iteration, self.num_data
            init = self.train_set.metadata.init_score
            if init is not None:
                self.scores -= self._init_scores(init, N)
            for s in [self.scores] + self.valid_scores:
                s /= self._scalar(self.iter_)

    def _scalar(self, v) -> torch.Tensor:
        """``v`` as a float32 tensor on the booster's device: CUDA divides
        by a Python scalar as a multiply by its reciprocal, by a tensor
        exactly, as the CPU and the JAX package do."""
        return torch.tensor(float(v), dtype=torch.float32,
                            device=self.device)

    def _scale_scores(self, k: int, mul=None, div=None) -> None:
        for s in [self.scores] + self.valid_scores:
            if mul is not None:
                s[k] *= mul
            else:
                s[k] /= self._scalar(div)

    def _one_iter(self, grad, hess):
        if self.objective is None:
            log.fatal("RF mode does not support custom objective functions")
        guard = self.guard
        guard.begin_iteration(self)
        self.last_iteration_skipped = False
        grad, hess = guard.admit_gradients(self, self._rf_grad,
                                           self._rf_hess)
        grad, hess, mask = self.sample_strategy.sample(self.iter_, grad,
                                                       hess)
        self.tree_ms, self.renew_ms = [], []
        should_continue = False
        for k in range(self.num_tree_per_iteration):
            grown = self._grow_host_tree(grad[k], hess[k], mask, k)
            if grown is None:
                return None
            tree, rec, row_leaf = grown
            if tree.num_leaves > 1:
                should_continue = True
                init = self.init_scores[k]
                if self.objective.is_renew_tree_output:
                    self._renew_tree_output(
                        tree, k, row_leaf, mask,
                        score=np.full(self.num_data, init))
                if abs(init) > K_EPSILON:
                    _add_bias(tree, init)
                # the running average: (score * it + tree) / (it + 1)
                # (reference: rf.hpp MultiplyScore around the update)
                it = self.iter_
                self._scale_scores(k, mul=it)
                self._add_tree_scores(tree, rec, row_leaf, k)
                self._scale_scores(k, div=it + 1)
            self.models.append(tree)
        return self._end_host_round(should_continue, keep_first=False)


def create_boosting(config: Config, train_set) -> GBDT:
    """(reference: Boosting::CreateBoosting, src/boosting/boosting.cpp:34)"""
    if config.deterministic:
        # every reduction of the port runs in a fixed order and every
        # random draw is seeded, as in the JAX package
        log.info("deterministic=true: runs are bit-reproducible on one "
                 "device for a fixed data order and library version")
    if config.boosting == "dart":
        return DART(config, train_set)
    if config.boosting == "rf":
        return RF(config, train_set)
    return GBDT(config, train_set)
