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

The host-driven :class:`~lambdagap_tpu_torch.models.learner.SerialTreeLearner`
(``tpu_fused_learner=0``, and the learner of CEGB and of
``monotone_constraints_method=advanced``, which the JAX package routes to
it from the fused learner with a warning, ``gbdt.py:349-376``) and the
objectives that refit their leaves (the L1 family: ``regression_l1``,
``quantile``, ``mape``) take the JAX package's host-tree path instead
(``_train_host_trees``): each tree is a host Tree (the fused learner's
materialized), an L1-family tree's leaves refit on the host by the weighted
percentile of its in-bag residuals, the shrinkage applied to the host tree
in float64, and the scores updated with ``f32(leaf_value)[row_leaf]``
(``row_leaf``: the fused learner's, or the serial learner's from its final
permutation, the JAX package's ``_add_tree_score``). That path stops when
no class's tree splits, as the JAX package's does. Linear leaves
(``linear_tree``) take it too: each split tree's leaves are fitted
(``_fit_linear_tree``, ``models/linear_leaf.py``) before the shrinkage,
and its scores are the f32-rounded ``tree.linear_leaf_outputs`` over the
raw rows, on the training set, every validation set and every replay.

``train_one_iter(grad, hess)`` trains on the caller's gradients (custom
objectives, ``objective=none``; no boost-from-average then).
``resume_from`` continues from a loaded model's trees, rebound to the
training set's binning and replayed onto the scores; a validation set
added after training began is replayed the same way (one binned-forest
dispatch). DART and RF (``models/dart.py``) drive the host-tree path
through ``_one_iter``, ``_grow_host_tree`` and ``_add_tree_scores``.

Validation scores take each tree's leaf values as the training scores
take them; the boost-from-average init score is added to them once, before
the first tree. (The JAX package's fast path adds that init score a second
time through the first tree's bias when a validation set is attached;
ROADMAP.md, Queue 3.)

The non-finite guard (``guard/nonfinite.py``, ``guard_nonfinite``) checks
every round with no sync of its own: its device flag rides the round's
first record read in the learner. Options the port does not train yet,
and knobs of layers it does not carry, raise NotImplementedError naming
the knob (:func:`_refuse_unported`). Every predict goes to the device engine:
the JAX package's <=512-row native ``fastpred`` shortcut is not ported.
``predict_engine=compiled`` runs the compiled artifact through the CUDA
traversal kernel; ``tensor`` runs the batched [rows x trees] traversal in
torch ops (``ops/predict_tensor``); ``scan`` runs the per-tree oracle. All
three return bit-identical raw scores. ``pred_leaf`` under ``compiled``
reads the traversal kernel's carry (``leaf[t, r] = ~carry[r,
group_of_tree[t]]``: the artifact renumbers nodes, never leaves), under
the other engines their own leaf dispatch. ``pred_contrib`` runs TreeSHAP
(``models/shap``, kernel S on the card). ``refit`` takes its leaf indices
from ``predict_leaf`` and keeps the JAX package's host Newton step and
``decay_rate`` blend; ``rollback_one_iter`` subtracts the last
iteration's trees from the training and validation scores through the
binned traversal with negated leaf values.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..metrics import create_metrics
from ..objectives import ObjectiveFunction, create_objective
from ..ops.predict import (TreeArrays, _round_depth, build_forest_blocks,
                           forest_to_arrays, predict_forest,
                           predict_forest_leaf, predict_leaf_index_binned,
                           predict_tree_binned, tree_to_arrays)
from ..ops.predict import to_device as to_device_arrays
from ..ops.predict_tensor import (build_tree_tiles, predict_forest_leaf_tensor,
                                  predict_forest_tensor)
from ..utils import log
from ..utils.device import resolve_device
from .learner import cegb_requested
from .linear_leaf import resolve_linear_config
from .tree import Tree, linear_leaf_outputs

K_EPSILON = 1e-15
_ROADMAP = "(ROADMAP.md, Queue 1)"
# rows a forest replay over the training matrix takes at a time: bounds the
# tensor engine's [rows, trees] working set at HIGGS scale
_REPLAY_ROWS = 1 << 20


def use_fused_learner(cfg: Config) -> bool:
    """The JAX package's serial-learner routing (``gbdt.py:343-376``): with
    ``tpu_fused_learner`` on (``auto`` is on, on the card and on the CPU),
    CEGB and ``monotone_constraints_method=advanced`` still go to the
    host-driven serial learner with a warning; quantized gradients on the
    serial learner warn and train in f32."""
    mode = cfg.tpu_fused_learner
    fused = mode == "auto" or str(mode).lower() in ("1", "true", "on", "yes")
    host_only = []
    if cfg.monotone_constraints and \
            cfg.monotone_constraints_method == "advanced":
        host_only.append("monotone_constraints_method=advanced")
    if cegb_requested(cfg):
        host_only.append("cegb")
    if fused and host_only:
        log.warning("Using the host-driven serial learner for: %s — it "
                    "reads the device once a split for the children's best "
                    "splits, and once more for re-scanned leaves",
                    ", ".join(host_only))
        fused = False
    if cfg.use_quantized_grad and not fused:
        log.warning("use_quantized_grad is only implemented by the fused "
                    "device learner; training runs in full precision")
    return fused


def dispatch_forest_predict(cfg: Config, x: torch.Tensor, forest,
                            tree_class, num_class: int, max_depth: int,
                            binned: bool, early_stop_freq: int = 0,
                            early_stop_margin: float = 0.0,
                            blocks=None,
                            has_linear: bool = False) -> torch.Tensor:
    """Route a whole-forest score dispatch over the stacked tables through
    the configured engine: ``tensor`` (and ``compiled``, whose artifact
    models raw serving rows only, for the training-shaped replays) to the
    tensorized engine, ``scan`` to the per-tree oracle. Both return
    bit-identical [num_class, N] float32; ``blocks`` are the pre-sliced
    tiles or blocks of :meth:`GBDT._device_forest`. ``has_linear``
    evaluates the linear leaf payload (raw rows only: a linear forest's
    binned replays go through :meth:`GBDT._replayer`)."""
    if cfg.predict_engine in ("tensor", "compiled"):
        return predict_forest_tensor(
            x, forest, tree_class, num_class, max_depth, binned,
            early_stop_freq, early_stop_margin,
            tree_tile=cfg.predict_tree_tile, tiles=blocks,
            has_linear=has_linear)
    return predict_forest(x, forest, tree_class, num_class, max_depth,
                          early_stop_freq, early_stop_margin, blocks=blocks,
                          binned=binned, has_linear=has_linear)


def dispatch_forest_leaf(cfg: Config, x: torch.Tensor, forest,
                         max_depth: int, binned: bool,
                         blocks=None) -> torch.Tensor:
    """Engine-routed leaf-index dispatch over the stacked tables ([T, N]
    int32), as :func:`dispatch_forest_predict` routes (leaf indices are
    engine-invariant)."""
    if cfg.predict_engine in ("tensor", "compiled"):
        return predict_forest_leaf_tensor(
            x, forest, max_depth, binned, tree_tile=cfg.predict_tree_tile,
            tiles=blocks)
    return predict_forest_leaf(x, forest, max_depth, binned, blocks=blocks)


def _add_bias(tree: Tree, bias: float) -> None:
    """Fold the boost-from-average init score into a tree (reference:
    Tree::AddBias via gbdt.cpp:421)."""
    if abs(bias) > K_EPSILON:
        tree.leaf_value[:tree.num_leaves] += bias
        tree.internal_value = [v + bias for v in tree.internal_value]
        if tree.is_linear:
            tree.leaf_const[:tree.num_leaves] += bias


def _finalize_tree(tree: Tree, shrinkage: float, bias: float) -> Tree:
    """Shrinkage + boost-from-average bias fold (gbdt.cpp:415-421). The
    leaf multiply is rounded in float32: the device training scores
    already took ``f32(leaf_value * shrinkage)``, so the serialized leaf
    values must be those products or a reload would disagree with training
    by an ulp."""
    lv32 = (tree.leaf_value[:tree.num_leaves].astype(np.float32)
            * np.float32(shrinkage)).astype(np.float32)
    tree.apply_shrinkage(shrinkage)
    tree.leaf_value[:tree.num_leaves] = lv32.astype(np.float64)
    _add_bias(tree, bias)
    return tree


def _has_linear(trees) -> bool:
    return any(getattr(t, "is_linear", False) for t in trees)


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
    the port does not carry yet and for a non-default value of every knob
    of a layer it does not carry (telemetry, profiling, fault injection,
    meshes, crash-safe snapshots): none is ignored silently. The serve
    knobs refuse in ``Booster.as_server``."""
    def no(knob: str, where: str = _ROADMAP) -> None:
        raise NotImplementedError(
            f"{knob} is not ported to lambdagap_tpu_torch yet {where}")

    if cfg.tree_learner != "serial":
        no(f"tree_learner={cfg.tree_learner}")
    if cfg.snapshot_freq > 0:
        no("snapshot_freq (crash-safe snapshots)")
    if cfg.resume == "auto":
        no("resume=auto (resuming from a crash-safe snapshot)")
    if cfg.tpu_hist_precision == "bf16":
        # K1 sums f32 gradients exactly; the JAX package's bf16 rounding
        # lives on its one-hot path only (ops/histogram.py:32-69)
        no("tpu_hist_precision=bf16 (histograms of bf16-rounded gradients;"
           " 'split' and 'f32' both give K1's exact f32 sums)")
    # knobs of layers the port does not carry (ROADMAP.md, Queue 1 item 5)
    if cfg.guard_faults:
        no("guard_faults (fault injection)")
    if cfg.telemetry:
        no("telemetry (timetag, enable_telemetry)")
    if cfg.telemetry_out:
        no("telemetry_out (the JSONL run log)")
    if cfg.profile_start_iter >= 0:
        no("profile_start_iter (the profiler window)")
    if cfg.mesh_shape:
        no("mesh_shape")


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
        self._shap_cache = None
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
        self.last_iteration_skipped = False
        self.serial = False      # trees from the host-driven SerialTreeLearner
        if train_set is not None:
            self._setup_training(train_set)

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------
    def _setup_training(self, ds) -> None:
        cfg = self.config
        _refuse_unported(cfg)
        from ..guard.nonfinite import TrainGuard
        from .fused_learner import FusedTreeLearner
        from .learner import SerialTreeLearner
        from .sample_strategy import create_sample_strategy
        self.guard = TrainGuard.from_config(cfg)
        self.num_data = ds.num_data
        self.max_feature_idx = ds.num_total_features - 1
        if self.objective is not None:
            if cfg.linear_tree and self.objective.is_renew_tree_output:
                # (reference: config check "Cannot use regression_l1
                # objective when fitting linear trees")
                log.fatal("Cannot use the %s objective with linear_tree",
                          self.objective.name)
            self.objective.init(ds.metadata, ds.num_data, self.device)
        resolve_linear_config(cfg)
        self.serial = not use_fused_learner(cfg)
        self.learner = (SerialTreeLearner if self.serial
                        else FusedTreeLearner)(ds, cfg, self.device)
        if cfg.boosting != "gbdt" and self.learner.residency == "stream":
            # the JAX package's DART and RF replay trees over the learner's
            # resident matrix, which a streamed learner does not hold
            # (lambdagap_tpu/models/learner.py:102; ROADMAP.md, Queue 3)
            raise NotImplementedError(
                f"boosting={cfg.boosting} with data_residency=stream is not "
                "ported to lambdagap_tpu_torch: it replays trees over the "
                "resident binned matrix (ROADMAP.md, Queue 3)")
        # the per-feature binned matrix on the device when the learner
        # holds EFB bundle columns, uploaded at the first replay
        self._x_binned: Optional[torch.Tensor] = None
        # the raw matrices on the device under linear leaves (the training
        # set's, each validation set's), uploaded at first use
        self._raw_dev: Dict[int, Tuple[np.ndarray, torch.Tensor]] = {}
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
        """A validation set; one added after training began takes the
        existing trees' scores in one batched binned-forest dispatch
        (JAX ``gbdt.py:465-495``), a linear forest's tree by tree from
        the set's raw rows."""
        self.valid_sets.append((name, ds))
        self.valid_binned.append(torch.from_numpy(
            np.ascontiguousarray(ds.binned)).to(self.device))
        self.valid_metrics.append(create_metrics(self.config, ds.metadata,
                                                 ds.num_data))
        self.valid_scores.append(self._init_scores(ds.metadata.init_score,
                                                   ds.num_data))
        if self.models:
            trees = self.host_models
            vi = len(self.valid_sets) - 1
            if _has_linear(trees) and ds.raw is None:
                log.fatal("Valid set %r needs the raw feature matrix "
                          "retained to replay a linear_tree model", name)
            self._replayer(trees)(self.valid_scores[vi],
                                  self.valid_binned[vi], self._raw_of(ds))

    def _raw_of(self, ds) -> Optional[torch.Tensor]:
        """A dataset's linear_tree raw matrix on the device (uploaded once
        while the dataset keeps it), or None."""
        raw = getattr(ds, "raw", None)
        if raw is None:
            return None
        key = id(ds)
        cached = self._raw_dev.get(key)
        if cached is None or cached[0] is not raw:
            self._raw_dev[key] = cached = (
                raw, torch.from_numpy(np.ascontiguousarray(raw)).to(
                    self.device))
        return cached[1]

    def _replayer(self, trees: List[Tree]):
        """A function ``(scores [K, rows], binned [rows, F], raw [rows, D])``
        that adds ``trees``' raw scores over those rows into ``scores`` in
        place, as the JAX package replays a forest when it resumes or
        attaches a validation set late: a constant forest in one dispatch
        through the configured engine (:func:`dispatch_forest_predict`); a
        linear forest tree by tree in forest order, each tree's float64
        outputs over the raw rows (the leaf from the binned traversal)
        rounded to f32 and added, as training added them (JAX
        ``gbdt.py:497-520``)."""
        K = self.num_tree_per_iteration
        forest, depth = forest_to_arrays(
            trees, feature_meta=self.learner.meta_host,
            use_inner_feature=True, device=self.device)
        if _has_linear(trees):
            def linear(scores, x, raw):
                leaf = dispatch_forest_leaf(self.config, x, forest, depth,
                                            binned=True)
                for i, t in enumerate(trees):
                    scores[i % K] += linear_leaf_outputs(t, raw,
                                                         leaf[i]).float()
            return linear
        tree_class = [i % K for i in range(len(trees))]

        def constant(scores, x, raw=None):
            scores += dispatch_forest_predict(
                self.config, x, forest, tree_class, K, depth, binned=True)
        return constant

    def _train_windows(self):
        """The per-feature binned training matrix on the device in row
        windows ``(first row, rows)`` of at most ``_REPLAY_ROWS``, for the
        replays over the training rows: views of the learner's resident
        matrix; the dataset's matrix, uploaded once, when the learner holds
        EFB bundle columns; the host shards a window at a time under
        stream residency. (A row's replay does not depend on the window
        it lies in.)"""
        lr = self.learner
        if lr.sdata is not None:
            sd = lr.sdata
            for lo in range(0, sd.num_data, sd.shard_rows):
                yield lo, torch.from_numpy(sd.row_block(
                    lo, min(lo + sd.shard_rows, sd.num_data))).to(
                        self.device)
            return
        x = lr.x_rows
        if lr.bundle is not None:
            if self._x_binned is None:
                self._x_binned = torch.from_numpy(np.ascontiguousarray(
                    self.train_set.binned)).to(self.device)
            x = self._x_binned
        for lo in range(0, x.shape[0], _REPLAY_ROWS):
            yield lo, x[lo:lo + _REPLAY_ROWS]

    def boosting(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Gradients at the current scores (reference: GBDT::Boosting,
        gbdt.cpp:222-237)."""
        return self.objective.get_gradients_fast(self.scores)

    def train_one_iter(self, grad: Optional[torch.Tensor] = None,
                       hess: Optional[torch.Tensor] = None) -> bool:
        """One boosting iteration, on the objective's gradients or on the
        caller's (``grad`` / ``hess``, [K, N] f32 on the booster's device:
        custom gradients, ``fobj``). Returns True when training should
        stop. The fast path never does: like the JAX package's, a converged
        run appends constant trees instead of paying a sync to stop. The
        non-finite guard hooks in where the JAX package's does
        (lambdagap_tpu/models/gbdt.py:537,572,610); a round the guard drops
        late is grown again, on the same gradients when the caller gave
        them."""
        while True:
            stop = self._one_iter(grad, hess)
            if stop is not None:
                return stop

    def _one_iter(self, grad, hess) -> Optional[bool]:
        """The round of :meth:`train_one_iter`; None when the guard found
        the previous round's scores non-finite and restored the state from
        before it (the round is grown again). Subclasses (DART, RF) wrap or
        replace it."""
        cfg = self.config
        K = self.num_tree_per_iteration
        guard = self.guard
        guard.begin_iteration(self)
        self.last_iteration_skipped = False
        init_scores = [0.0] * K
        if grad is None or hess is None:
            if self.objective is None:
                log.fatal("No objective and no custom gradients provided")
            # boost from average once, before the first gradients; custom
            # gradients skip it (JAX gbdt.py:540-541)
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
        grad, hess = guard.admit_gradients(self, grad, hess)
        grad, hess, mask = self.sample_strategy.sample(self.iter_, grad,
                                                       hess)
        self.tree_ms, self.renew_ms = [], []
        if (self.serial or type(self) is not GBDT or cfg.linear_tree
                or (self.objective is not None
                    and self.objective.is_renew_tree_output)):
            return self._train_host_trees(grad, hess, mask, init_scores)
        for k in range(K):
            rec = self._grow(grad[k], hess[k], mask)
            if k == 0 and guard.after_first_tree(self):
                return None
            lv = rec.leaf_value * self.shrinkage_rate
            self.scores[k] += lv[rec.row_leaf]
            self._add_valid_tree_score(rec, lv, k)
            # drop the O(N) row -> leaf map from the kept record
            self.models.append(_LazyTree(self.learner,
                                         rec._replace(row_leaf=None),
                                         self.shrinkage_rate,
                                         init_scores[k]))
        self.iter_ += 1
        self.last_iteration_skipped = guard.end_iteration(self)
        return False

    def _guard_state_capture(self) -> dict:
        """Restore point for guard_nonfinite=skip_tree: the scores are
        updated in place, so they are copied (on the device, no sync); the
        random streams go with it."""
        return {"scores": self.scores.clone(),
                "valid_scores": [v.clone() for v in self.valid_scores],
                "n_models": len(self.models), "iter": self.iter_,
                "shrinkage": self.shrinkage_rate, "rng": self._rng_state()}

    def _guard_state_restore(self, st: dict, rng=None) -> None:
        """Back to a restore point; the random streams to ``rng`` (left as
        they are when None)."""
        self.scores = st["scores"].clone()
        self.valid_scores[:] = [v.clone() for v in st["valid_scores"]]
        del self.models[st["n_models"]:]
        self.iter_ = st["iter"]
        self.shrinkage_rate = st["shrinkage"]
        if rng is not None:
            self._set_rng_state(rng)

    def _rng_state(self) -> tuple:
        """The learner's, the sampler's and the objective's random
        streams."""
        s, o = self.sample_strategy, self.objective
        return (self.learner.rng_state(), getattr(s, "key", None),
                getattr(s, "cur_mask", None), getattr(o, "key", None))

    def _set_rng_state(self, st: tuple) -> None:
        lr_state, skey, smask, okey = st
        self.learner.set_rng_state(lr_state)
        if skey is not None:
            self.sample_strategy.key = skey
            if hasattr(self.sample_strategy, "cur_mask"):
                self.sample_strategy.cur_mask = smask
        if okey is not None:
            self.objective.key = okey

    def guard_finish(self) -> bool:
        """The non-finite guard's read of the last round's scores, once
        when training ends; True when that round was dropped."""
        return self.guard.finish(self)

    def _train_host_trees(self, grad, hess, mask,
                          init_scores) -> Optional[bool]:
        """The JAX package's host-tree path (gbdt.py:612-660) for the
        serial learner, the L1 family and a subclass's rounds (DART, as
        the JAX package's fast path is GBDT's own): each class's tree a
        host Tree; a
        split tree's leaves refit (L1 family), shrunk in float64, its
        ``f32(leaf_value)`` added to the scores, the init score folded in;
        an unsplit first tree holds the init score. Stops when no class's
        tree split, dropping that round's trees unless they are the
        first."""
        cfg = self.config
        K = self.num_tree_per_iteration
        should_continue = False
        for k in range(K):
            grown = self._grow_host_tree(grad[k], hess[k], mask, k)
            if grown is None:
                return None
            tree, rec, row_leaf = grown
            if tree.num_leaves > 1:
                should_continue = True
                if cfg.linear_tree and type(self) is GBDT:
                    self._fit_linear_tree(tree, row_leaf, grad[k], hess[k])
                if self.objective is not None \
                        and self.objective.is_renew_tree_output:
                    self._renew_tree_output(tree, k, row_leaf, mask)
                tree.apply_shrinkage(self.shrinkage_rate)
                self._add_tree_scores(tree, rec, row_leaf, k)
                _add_bias(tree, init_scores[k])
            elif len(self.models) < K:
                if self.objective is not None and not cfg.boost_from_average \
                        and not self.has_init_score:
                    init_scores[k] = self.objective.boost_from_score(k)
                    self.scores[k] += init_scores[k]
                    for vs in self.valid_scores:
                        vs[k] += init_scores[k]
                tree.leaf_value[0] = init_scores[k]
            self.models.append(tree)
        return self._end_host_round(should_continue)

    def _end_host_round(self, should_continue: bool,
                        keep_first: bool = True) -> bool:
        """The end of a host-tree round: the guard's check, or the stop
        when no class's tree split (dropping the round's trees, unless
        they are the first and ``keep_first``)."""
        K = self.num_tree_per_iteration
        if not should_continue:
            if self.guard.end_iteration(self):
                # non-finite gradients made every leaf unsplittable: a
                # skipped round, not convergence (gbdt.py:647)
                self.last_iteration_skipped = True
                return False
            log.warning("Stopped training because there are no more leaves "
                        "that meet the split requirements")
            if len(self.models) > K or not keep_first:
                del self.models[-K:]
            return True
        self.iter_ += 1
        self.last_iteration_skipped = self.guard.end_iteration(self)
        return False

    def _grow_host_tree(self, grad, hess, mask, k: int):
        """One class's tree of a host-tree round: (host Tree, the fused
        learner's device record or None, row -> leaf on the device); None
        when the round's first tree found the previous round's scores
        non-finite and the guard restored the state before it."""
        grown = self._grow(grad, hess, mask)
        if self.serial:
            tree, rec = grown, None
            row_leaf = self.learner.last_row_leaf
        else:
            rec, row_leaf = grown, grown.row_leaf
        if k == 0 and self.guard.after_first_tree(self):
            return None
        if rec is not None:
            tree = self.learner.materialize(rec)
        return tree, rec, row_leaf

    def _fit_linear_tree(self, tree: Tree, row_leaf: torch.Tensor, grad,
                         hess) -> None:
        """Fit the tree's linear leaves over the raw features of the leaf
        paths (``models/linear_leaf.py``; JAX ``gbdt.py:700-738``): both
        learners land here with their row -> leaf map on the device."""
        from .linear_leaf import (fit_linear_leaves_batched,
                                  numeric_feature_mask)
        ds = self.train_set
        if ds.raw is None:
            log.warning("linear_tree needs the retained raw matrix; "
                        "skipping linear fit")
            return
        fit_linear_leaves_batched(tree, self._raw_of(ds), row_leaf, grad,
                                  hess, self.config.linear_lambda,
                                  numeric_feature_mask(ds),
                                  self.config.num_leaves)

    def _add_tree_scores(self, tree: Tree, rec, row_leaf,
                         k: int) -> None:
        """Add a host tree's ``f32(leaf_value)`` to class k's training
        scores (by ``row_leaf``) and to every validation set's; a linear
        tree's f32-rounded :func:`linear_leaf_outputs` over the raw rows
        instead."""
        if tree.is_linear:
            self.scores[k] += linear_leaf_outputs(
                tree, self._raw_of(self.train_set), row_leaf).float()
            self._add_valid_linear_tree_score(tree, rec, k)
            return
        lv = torch.from_numpy(
            tree.leaf_value.astype(np.float32)).to(self.device)
        self.scores[k] += lv[row_leaf]
        if rec is not None:
            self._add_valid_tree_score(rec, lv, k)
        else:
            self._add_valid_host_tree_score(tree, lv, k)

    def _add_valid_linear_tree_score(self, tree: Tree, rec, k: int) -> None:
        """A linear tree's outputs added to every validation set's class-k
        scores: its leaf over the binned rows, its f32-rounded
        :func:`linear_leaf_outputs` over the raw rows (JAX
        ``gbdt.py:807-827``). A set without its raw matrix takes the
        constant leaf values, with the JAX package's warning."""
        if not self.valid_sets:
            return
        lv = torch.from_numpy(
            tree.leaf_value.astype(np.float32)).to(self.device)
        if rec is not None:
            t, depth = self._device_tree_arrays(rec, lv), max(rec.max_depth,
                                                              1)
        else:
            t = to_device_arrays(tree_to_arrays(
                tree, feature_meta=self.learner.meta_host,
                use_inner_feature=True), self.device)
            depth = _round_depth(tree.max_depth + 1)
        for vi, (name, ds) in enumerate(self.valid_sets):
            leaf = predict_leaf_index_binned(self.valid_binned[vi], t, depth)
            raw = self._raw_of(ds)
            if raw is None:
                log.warning("Valid set %r has no retained raw matrix; "
                            "linear-tree eval falls back to constant leaf "
                            "values (metrics will not match predict())",
                            name)
                self.valid_scores[vi][k] += lv[leaf]
                continue
            self.valid_scores[vi][k] += linear_leaf_outputs(
                tree, raw, leaf).float()

    def _grow(self, grad, hess, mask):
        """One tree: the serial learner's host Tree, or the fused learner's
        device record; its host wall into ``tree_ms``."""
        t0 = time.perf_counter()
        grown = (self.learner.train(grad, hess, mask) if self.serial
                 else self.learner.train_device(grad, hess, mask))
        self.tree_ms.append((time.perf_counter() - t0) * 1e3)
        return grown

    def _renew_tree_output(self, tree: Tree, k: int, row_leaf: torch.Tensor,
                           mask: Optional[torch.Tensor],
                           score: Optional[np.ndarray] = None) -> None:
        """The L1-family leaf refit (reference: RenewTreeOutput,
        gbdt.cpp:412): each leaf's value becomes the objective's weighted
        percentile of ``label - score`` over the leaf's in-bag rows. Under
        the fused learner the rows come in ascending order as ``np.nonzero``
        gives them (one stable argsort of ``row_leaf`` orders every leaf's
        rows at once); under the serial learner in the order of its final
        permutation's slices, as the JAX package reads them
        (``gbdt.py:855-875``). The scores, the rows and the mask are read
        to the host once. ``score`` replaces class k's scores (RF's
        constant init score)."""
        t0 = time.perf_counter()
        if score is None:
            score = self.scores[k].cpu().numpy()
        mask_np = None if mask is None else mask.cpu().numpy()
        if self.serial:
            lr = self.learner
            perm = lr.last_perm.cpu().numpy()
            spans = zip(lr.last_leaf_begin, lr.last_leaf_count)
            leaf_rows = [perm[b:b + c] for b, c in spans]
        else:
            leaf_of = row_leaf.cpu().numpy()
            order = np.argsort(leaf_of, kind="stable")
            ends = np.cumsum(np.bincount(leaf_of, minlength=tree.num_leaves))
            leaf_rows = [order[ends[leaf - 1] if leaf else 0:ends[leaf]]
                         for leaf in range(tree.num_leaves)]
        for leaf, rows in enumerate(leaf_rows):
            if mask_np is not None:
                rows = rows[mask_np[rows]]
            if len(rows):
                tree.leaf_value[leaf] = self.objective.renew_tree_output(
                    rows, score)
        self.renew_ms.append((time.perf_counter() - t0) * 1e3)

    def _add_valid_host_tree_score(self, tree: Tree, leaf_values,
                                   k: int) -> None:
        """Add a host tree's leaf values to every validation set's class-k
        scores through the binned traversal (the JAX package's
        ``_add_valid_tree_score``, gbdt.py:807-831)."""
        if not self.valid_sets:
            return
        arrs = tree_to_arrays(tree, feature_meta=self.learner.meta_host,
                              use_inner_feature=True)
        t = to_device_arrays(arrs, self.device)._replace(
            leaf_value=leaf_values)
        depth = _round_depth(tree.max_depth + 1)
        for vi in range(len(self.valid_sets)):
            self.valid_scores[vi][k] += predict_tree_binned(
                self.valid_binned[vi], t, depth)

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
        self._shap_cache = None
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
        """Stacked tensor forest on the booster's device for the tensor and
        scan engines, with its pre-sliced tiles (``predict_tree_tile``) or
        blocks, cached per generation, slice and engine. Returns (forest,
        depth, tree_class, blocks, has_linear)."""
        cfg = self.config
        key = (self.generation, len(self.models), idx[0], idx[-1], len(idx),
               cfg.predict_engine, cfg.predict_tree_tile)
        cache = self._forest_cache
        if cache is None or cache[0] != key:
            K = self.num_tree_per_iteration
            trees = [self._tree(i) for i in idx]
            forest, depth = forest_to_arrays(trees, device=self.device)
            tree_class = [i % K for i in idx]
            if cfg.predict_engine in ("tensor", "compiled"):
                blocks = build_tree_tiles(forest, tree_class,
                                          cfg.predict_tree_tile)
            else:
                blocks = build_forest_blocks(forest, tree_class)
            self._forest_cache = (key, (forest, depth, tree_class, blocks,
                                        _has_linear(trees)))
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
        forest, depth, tree_class, blocks, linear = self._device_forest(idx)
        return dispatch_forest_predict(
            self.config, x, forest, tree_class, K, depth, binned=False,
            early_stop_freq=es_freq,
            early_stop_margin=float(self.config.pred_early_stop_margin),
            blocks=blocks, has_linear=linear)

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

    def _leaf_device(self, data: np.ndarray, start_iteration: int,
                     num_iteration: int) -> torch.Tensor:
        """Leaf index per (tree, row) [T, N] int32 on the booster's
        device. Under ``compiled`` the traversal kernel's carry answers it
        (one launch, no second traversal): tree t's leaf is
        ``~carry[r, group_of_tree[t]]``."""
        x = torch.from_numpy(np.ascontiguousarray(data)).to(self.device)
        return self._leaf_rows(x, start_iteration, num_iteration)

    def _leaf_rows(self, x: torch.Tensor, start_iteration: int,
                   num_iteration: int) -> torch.Tensor:
        """:meth:`_leaf_device` of f32 rows already on the device."""
        idx = self._model_slice(start_iteration, num_iteration)
        if not idx:
            return torch.zeros((0, x.shape[0]), dtype=torch.int32,
                               device=self.device)
        if self.config.predict_engine == "compiled":
            return self._compiled_forest(start_iteration, num_iteration,
                                         self._es_freq()).predict_leaf(x)
        forest, depth, _, blocks, _ = self._device_forest(idx)
        return dispatch_forest_leaf(self.config, x, forest, depth,
                                    binned=False, blocks=blocks)

    def predict_leaf(self, data: np.ndarray, start_iteration: int = 0,
                     num_iteration: int = -1) -> np.ndarray:
        """Leaf index per (row, tree): [N, T] int32 (reference:
        predict_leaf_index path)."""
        data = self._check_predict_shape(np.asarray(data, dtype=np.float32))
        return self._leaf_device(data, start_iteration,
                                 num_iteration).cpu().numpy().T

    def _shap_paths(self, idx):
        """The slice's TreeSHAP paths on the booster's device (a linear
        tree's over its leaf constants) and its linear terms' tables
        (``shap.linear_tables``, None for a constant forest), cached per
        generation and slice."""
        key = (self.generation, len(self.models), idx[0], idx[-1], len(idx))
        cache = self._shap_cache
        if cache is None or cache[0] != key:
            from .shap import build_paths, linear_tables, structural, to_device
            K = self.num_tree_per_iteration
            trees = [self._tree(i) for i in idx]
            tree_class = [i % K for i in idx]
            paths = build_paths([structural(t) for t in trees], tree_class, K)
            self._shap_cache = (key, (
                to_device(paths, self.device),
                linear_tables(trees, tree_class, self.device)
                if _has_linear(trees) else None))
        return self._shap_cache[1]

    def _contrib_rows(self, x: torch.Tensor, start_iteration: int,
                      num_iteration: int) -> torch.Tensor:
        """SHAP contributions [N, K, F+1] float64 of the float64 rows ``x``
        on the booster's device, before averaging: kernel S over the
        slice's paths; for a linear forest, then each linear term on its
        own feature, the rows' leaves from the f32 traversal (K3 under
        ``compiled``; ``shap.add_linear_terms``)."""
        from .shap import add_linear_terms, tree_shap
        idx = self._model_slice(start_iteration, num_iteration)
        paths, linear = self._shap_paths(idx)
        phi = tree_shap(x, paths)
        if linear is not None:
            leaf = self._leaf_rows(x.float().contiguous(), start_iteration,
                                   num_iteration)
            add_linear_terms(phi, x, leaf, linear)
        return phi

    def predict_contrib(self, data: np.ndarray, start_iteration: int = 0,
                        num_iteration: int = -1) -> np.ndarray:
        """SHAP feature contributions: [N, F+1] per class, the last column
        the expected value, each class's row summing to its raw score
        (reference: Tree::PredictContrib / TreeSHAP, src/io/tree.cpp); K
        classes lay out as [N, K*(F+1)]. Decisions in float64 on a float64
        copy of ``data``; a linear tree's structural part over its leaf
        constants, each linear term on its own feature (the JAX package's
        ``tree_shap_linear``)."""
        data = np.asarray(data, dtype=np.float64)
        data = np.ascontiguousarray(self._check_predict_shape(data))
        N, F_data = data.shape
        K = self.num_tree_per_iteration
        idx = self._model_slice(start_iteration, num_iteration)
        max_f = max((f for i in idx for f in
                     self._tree(i).split_feature[:self._tree(i).num_internal]),
                    default=-1)
        if max_f >= F_data:
            log.fatal("pred_contrib input has %d features but the model "
                      "splits on feature %d", F_data, max_f)
        if not idx:
            phi = np.zeros((N, K, F_data + 1), np.float64)
        else:
            x = torch.from_numpy(data).to(self.device)
            phi = self._contrib_rows(x, start_iteration,
                                     num_iteration).cpu().numpy()
        if self.average_output:
            phi /= max(1, len(idx) // max(K, 1))
        if K == 1:
            return phi[:, 0]
        return phi.reshape(N, K * (F_data + 1))

    def predict_stream(self, data, start_iteration: int = 0,
                       num_iteration: int = -1, raw_score: bool = False,
                       pred_contrib: bool = False, window_rows: int = 0,
                       out: Optional[np.ndarray] = None, signal_source=None,
                       throttle=None, stats_out: Optional[dict] = None
                       ) -> np.ndarray:
        """Out-of-core batch scoring (``infer/stream.py``): row windows of a
        matrix, an ``np.memmap`` or a ``ShardedBinnedDataset`` go up
        through the H2D ring to the configured engine and the scores come
        back through the D2H ring, equal to :meth:`predict_raw` /
        :meth:`predict` bit for bit; ``out`` takes the rows in place;
        ``signal_source`` / ``throttle`` arm the co-tenant throttle;
        ``stats_out`` receives the run report."""
        from ..infer.stream import predict_stream as _predict_stream
        return _predict_stream(
            self, data, start_iteration=start_iteration,
            num_iteration=num_iteration, raw_score=raw_score,
            pred_contrib=pred_contrib, window_rows=window_rows, out=out,
            signal_source=signal_source, throttle=throttle,
            stats_out=stats_out)

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
    # continued training, refit and rollback
    # ------------------------------------------------------------------
    def resume_from(self, trees: List[Tree]) -> None:
        """Continue training from a loaded model's trees (JAX
        ``gbdt.py:881-938``; reference: GBDT::ResetTrainingData after
        LoadModelFromString): deep copies of them, rebound to this
        dataset's binning, become the model, and their scores are replayed
        onto the training and validation scores in one batched
        binned-forest dispatch per row window."""
        import copy
        from .tree import rebind_to_dataset
        K = self.num_tree_per_iteration
        if len(trees) % K != 0:
            log.fatal("init_model has %d trees, not a multiple of "
                      "num_tree_per_iteration=%d", len(trees), K)
        if self.train_set is None:
            log.fatal("resume_from needs a training dataset")
        # rebinding rewrites bin-space (and for a missing-type mismatch
        # raw-space) fields: the caller's trees stay as they are
        trees = [copy.deepcopy(t) for t in trees]
        for t in trees:
            rebind_to_dataset(t, self.train_set)
        raw = None
        if _has_linear(trees):
            # linear trees predict leaf_const + leaf_coeff . x: a replay
            # with constant leaves would train every later gradient
            # against wrong scores (JAX gbdt.py:905-928)
            if type(self) is not GBDT:
                log.fatal("Continued training from a linear_tree model is "
                          "only supported with boosting=gbdt")
            if self.train_set.raw is None or any(
                    ds.raw is None for _, ds in self.valid_sets):
                log.fatal("Continued training from a linear_tree model needs "
                          "the raw feature matrix retained on every dataset "
                          "(train a linear_tree Dataset or disable "
                          "init_model)")
            raw = self._raw_of(self.train_set)
        self.models = list(trees)
        self.iter_ = len(trees) // K
        self.invalidate_predict_cache()
        if not trees:
            return
        replay = self._replayer(trees)
        for lo, xw in self._train_windows():
            n = xw.shape[0]
            replay(self.scores[:, lo:lo + n], xw,
                   None if raw is None else raw[lo:lo + n])
        for vi, (_, ds) in enumerate(self.valid_sets):
            replay(self.valid_scores[vi], self.valid_binned[vi],
                   self._raw_of(ds))

    def refit(self, data: np.ndarray, label: np.ndarray, weight=None,
              group=None, decay_rate: Optional[float] = None) -> None:
        """Refit the leaf values of the existing trees on new data,
        keeping the tree structures (reference: GBDT::RefitTree in
        gbdt.cpp + SerialTreeLearner::FitByExistingTree). Each new leaf
        output is the regularized Newton step over the rows that land in
        the leaf (feature_histogram.hpp:198 CalculateSplittedLeafOutput),
        summed on the host in float64 and blended with the old value by
        ``refit_decay_rate``, iteration by iteration from zero scores, as
        the JAX package does. The leaf indices come from
        :meth:`predict_leaf`'s engine."""
        from ..data.dataset import Metadata
        cfg = self.config
        decay = (cfg.refit_decay_rate if decay_rate is None
                 else float(decay_rate))
        X = np.ascontiguousarray(np.asarray(data, dtype=np.float32))
        N = X.shape[0]
        K = self.num_tree_per_iteration
        trees = self.host_models
        if not trees:
            log.fatal("refit needs a trained model")
        if _has_linear(trees):
            # refit rewrites leaf_value only; predict would keep reading
            # the stale linear payload, so it goes (JAX gbdt.py:959-966)
            log.warning("refit drops linear-leaf models; the refitted trees "
                        "predict with constant leaf values")
            for t in trees:
                t.is_linear = False
        md = Metadata()
        md.label = np.asarray(label, dtype=np.float32).reshape(-1)
        if weight is not None:
            md.weight = np.asarray(weight, dtype=np.float32).reshape(-1)
        md.set_group(None if group is None else np.asarray(group))
        md.check(N)
        obj = create_objective(cfg)
        if obj is None:
            log.fatal("refit requires a built-in objective")
        obj.init(md, N, self.device)
        leaf_of = self._leaf_device(X, 0, -1).cpu().numpy()     # [T, N]
        self.invalidate_predict_cache()     # leaf values change in place

        l1, l2 = cfg.lambda_l1, cfg.lambda_l2
        mds = cfg.max_delta_step

        def newton_out(sg, sh):
            num = (-np.sign(sg) * np.maximum(np.abs(sg) - l1, 0.0)
                   if l1 > 0 else -sg)
            out = num / (sh + l2 + K_EPSILON)
            if mds > 0:
                out = np.clip(out, -mds, mds)
            return out

        scores = torch.zeros((K, N), dtype=torch.float32, device=self.device)
        for it in range(len(trees) // K):
            grad, hess = obj.get_gradients_fast(scores)
            g = grad.cpu().numpy()
            h = hess.cpu().numpy()
            for k in range(K):
                t = trees[it * K + k]
                L = t.num_leaves
                lf = leaf_of[it * K + k]
                sg = np.bincount(lf, weights=g[k], minlength=L)[:L]
                sh = np.bincount(lf, weights=h[k], minlength=L)[:L]
                new_out = newton_out(sg, sh) * t.shrinkage
                old = t.leaf_value[:L].copy()
                t.leaf_value[:L] = decay * old + (1.0 - decay) * new_out
                scores[k] += torch.from_numpy(
                    t.leaf_value[lf].astype(np.float32)).to(self.device)

    def rollback_one_iter(self) -> None:
        """Drop the last iteration's trees and subtract their scores
        (reference: GBDT::RollbackOneIter, gbdt.cpp:456): each tree is
        re-added to the training and validation scores with negated leaf
        values, through the binned traversal, as the JAX package does. A
        loaded model has no scores: its trees are dropped."""
        K = self.num_tree_per_iteration
        if self.iter_ <= 0 or len(self.models) < K:
            return
        self._materialize_lazy()
        last = range(len(self.models) - K, len(self.models))
        if _has_linear(self.models[i] for i in last):
            # subtracting constant leaf values would corrupt the scores a
            # linear tree updated with its dot products (JAX
            # gbdt.py:1431-1435)
            log.fatal("rollback_one_iter is not supported for linear_tree "
                      "models")
        if self.train_set is not None:
            lr = self.learner
            for k, i in enumerate(last):
                tree = self.models[i]
                arrs = tree_to_arrays(tree, feature_meta=lr.meta_host,
                                      use_inner_feature=True)
                arrs = arrs._replace(leaf_value=-arrs.leaf_value)
                t = to_device_arrays(arrs, self.device)
                depth = _round_depth(tree.max_depth + 1)
                for lo, xw in self._train_windows():
                    self.scores[k, lo:lo + xw.shape[0]] += \
                        predict_tree_binned(xw, t, depth)
                for vi in range(len(self.valid_sets)):
                    self.valid_scores[vi][k] += predict_tree_binned(
                        self.valid_binned[vi], t, depth)
        del self.models[-K:]
        self.iter_ -= 1
        self.invalidate_predict_cache()

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
        booster.iter_ = len(trees) // booster.num_tree_per_iteration
        booster.max_feature_idx = int(header.get("max_feature_idx", 0))
        if header.get("average_output"):
            booster.average_output = True
        booster._feature_names = header.get("feature_names", "").split()
        booster._feature_infos = header.get("feature_infos", "").split()
        booster._objective_string = header.get("objective", "custom")
        return booster
