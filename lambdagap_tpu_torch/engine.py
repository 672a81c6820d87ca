"""Training entry points: ``train()`` and ``cv()`` (reference:
python-package/lightgbm/engine.py — train :109, cv :627, CVBooster :356).
The port of ``lambdagap_tpu/engine.py``: validation sets, ``feval``,
callbacks (``before_iteration`` ones before each round's update, the
others after it), ``early_stopping_round``, ``init_model`` (a Booster or a
model file) for continued training, and cross-validation over
``Dataset.subset`` folds. A validation set's query groups reach its
metrics, so a ranker reports ``ndcg@k`` / ``map@k`` / ``precision@k`` per
``eval_at`` position, greater is better. ``resume=auto`` (crash-safe
snapshots) is refused by name until the snapshots are ported; so are
``cv``'s ``callbacks``, ``feval`` and ``init_model``, which the JAX
package's ``cv`` accepts and never uses.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from . import callback as callback_mod
from .basic import Booster, Dataset
from .callback import CallbackEnv, EarlyStopException
from .config import Config
from .metrics import create_metrics


def _num_rounds(params: Dict[str, Any], num_boost_round: int) -> int:
    """``num_iterations`` in ``params`` wins over ``num_boost_round``."""
    cfg = Config.from_params(params)
    if "num_iterations" not in {Config.canonical_name(k) for k in params}:
        return num_boost_round
    return cfg.num_iterations


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100,
          valid_sets: Optional[List[Dataset]] = None,
          valid_names: Optional[List[str]] = None,
          feval: Optional[Union[Callable, List[Callable]]] = None,
          init_model: Optional[Union[str, Booster]] = None,
          keep_training_booster: bool = False,
          callbacks: Optional[List[Callable]] = None,
          resume: str = "") -> Booster:
    """Train a booster (reference: engine.py:109). Runs on the card unless
    ``params`` says ``device_type="cpu"``. ``init_model`` (a Booster or a
    model file) continues its trees for ``num_boost_round`` more rounds;
    ``feval(preds, data)`` returns ``(name, value, greater_is_better)`` or
    a list of them, on the converted scores of each evaluated set. The
    returned booster can always train on (``keep_training_booster`` is
    accepted for compatibility)."""
    params = dict(params)
    cfg = Config.from_params(params)
    if (resume or cfg.resume) == "auto":
        raise NotImplementedError(
            "resume=auto (resuming from a crash-safe snapshot) is not ported "
            "to lambdagap_tpu_torch yet (ROADMAP.md, Queue 1 item 5)")
    num_boost_round = _num_rounds(params, num_boost_round)

    booster = Booster(params=params, train_set=train_set)
    gb = booster._booster
    if init_model is not None:
        from .models.model_text import load_model_from_string
        if isinstance(init_model, Booster):
            model_str = init_model.model_to_string()
        else:
            with open(init_model) as f:
                model_str = f.read()
        _, trees = load_model_from_string(model_str)
        gb.resume_from(trees)

    valid_sets = valid_sets or []
    valid_names = valid_names or []
    valid_contains_train = False
    for i, vs in enumerate(valid_sets):
        name = valid_names[i] if i < len(valid_names) else f"valid_{i}"
        if vs is train_set:
            valid_contains_train = True
            ds = train_set.construct(booster.config)
            gb.train_metrics = create_metrics(booster.config, ds.metadata,
                                              ds.num_data)
            booster._train_name = name
            continue
        booster.add_valid(vs, name)

    cbs = list(callbacks or [])
    if cfg.early_stopping_round > 0 and valid_sets:
        cbs.append(callback_mod.early_stopping(
            cfg.early_stopping_round, cfg.first_metric_only,
            verbose=cfg.verbosity >= 1,
            min_delta=cfg.early_stopping_min_delta))
    if cfg.verbosity >= 1 and cfg.metric_freq > 0:
        cbs.append(callback_mod.log_evaluation(cfg.metric_freq))
    cbs_before = [cb for cb in cbs if getattr(cb, "before_iteration", False)]
    cbs_after = [cb for cb in cbs
                 if not getattr(cb, "before_iteration", False)]
    for group in (cbs_before, cbs_after):
        group.sort(key=lambda cb: getattr(cb, "order", 0))

    evals: List[Tuple[str, str, float, bool]] = []
    for i in range(num_boost_round):
        env = CallbackEnv(model=booster, params=params, iteration=i,
                          begin_iteration=0, end_iteration=num_boost_round,
                          evaluation_result_list=[])
        for cb in cbs_before:
            cb(env)
        # the guard's read of this round's scores is deferred (Booster._step)
        stop = booster._step()
        evals = []
        if valid_contains_train:
            train_name = getattr(booster, "_train_name", "training")
            evals.extend((train_name, m, v, g)
                         for (_, m, v, g) in gb.eval_train())
        evals.extend(gb.eval_valid())
        if feval is not None:
            evals.extend(_run_feval(feval, booster, valid_contains_train))
        env = CallbackEnv(model=booster, params=params, iteration=i,
                          begin_iteration=0, end_iteration=num_boost_round,
                          evaluation_result_list=evals)
        try:
            for cb in cbs_after:
                cb(env)
        except EarlyStopException as e:
            booster.best_iteration = e.best_iteration + 1
            for d, m, v, _ in e.best_score:
                booster.best_score.setdefault(d, {})[m] = v
            break
        if stop:
            break
    # the non-finite guard's read of the last round's scores
    gb.guard_finish()
    if booster.best_iteration < 0:
        for d, m, v, _ in evals:
            booster.best_score.setdefault(d, {})[m] = v
    return booster


def _run_feval(feval, booster: Booster, include_train: bool
               ) -> List[Tuple[str, str, float, bool]]:
    """``feval`` on the converted scores of the training set (when it is a
    validation set) and of each validation set, with the binned dataset
    (the JAX package's ``_run_feval``)."""
    out = []
    fevals = feval if isinstance(feval, (list, tuple)) else [feval]
    gb = booster._booster
    datasets = []
    if include_train:
        datasets.append((getattr(booster, "_train_name", "training"),
                         gb._converted_scores(gb.scores), gb.train_set))
    for vi, (name, ds) in enumerate(gb.valid_sets):
        datasets.append((name, gb._converted_scores(gb.valid_scores[vi]),
                         ds))
    for name, preds, ds in datasets:
        for f in fevals:
            res = f(preds, ds)
            for mname, val, greater in (res if isinstance(res, list)
                                        else [res]):
                out.append((name, mname, val, greater))
    return out


class CVBooster:
    """The folds' boosters (reference: engine.py:356): a method call on it
    is called on every fold's booster and returns their answers."""

    def __init__(self) -> None:
        self.boosters: List[Booster] = []
        self.best_iteration = -1

    def append(self, booster: Booster) -> None:
        self.boosters.append(booster)

    def __getattr__(self, name):
        def handler(*args, **kwargs):
            return [getattr(b, name)(*args, **kwargs) for b in self.boosters]
        return handler


def _make_n_folds(full_data: Dataset, nfold: int, params: Dict,
                  seed: int, stratified: bool, shuffle: bool):
    """(train rows, test rows) of each fold (the JAX package's
    ``_make_n_folds``): whole queries when the data has groups, else
    stratified by label or plain, shuffled by ``RandomState(seed)``."""
    cfg = Config.from_params(params)
    ds = full_data.construct(cfg)
    num_data = ds.num_data
    rng = np.random.RandomState(seed)
    if ds.metadata.query_boundaries is not None:
        nq = ds.metadata.num_queries
        q_idx = rng.permutation(nq) if shuffle else np.arange(nq)
        qb = ds.metadata.query_boundaries
        for fq in np.array_split(q_idx, nfold):
            test_rows = (np.concatenate([np.arange(qb[q], qb[q + 1])
                                         for q in fq])
                         if len(fq) else np.array([], int))
            yield np.setdiff1d(np.arange(num_data), test_rows), test_rows
        return
    if stratified and ds.metadata.label is not None:
        label = np.asarray(ds.metadata.label)
        folds: List[list] = [[] for _ in range(nfold)]
        for c in np.unique(label):
            idxs = np.nonzero(label == c)[0]
            if shuffle:
                idxs = rng.permutation(idxs)
            for fi, part in enumerate(np.array_split(idxs, nfold)):
                folds[fi].append(part)
        for fi in range(nfold):
            test_rows = np.sort(np.concatenate(folds[fi]))
            yield np.setdiff1d(np.arange(num_data), test_rows), test_rows
        return
    idx = rng.permutation(num_data) if shuffle else np.arange(num_data)
    for part in np.array_split(idx, nfold):
        test_rows = np.sort(part)
        yield np.setdiff1d(np.arange(num_data), test_rows), test_rows


def cv(params: Dict[str, Any], train_set: Dataset, num_boost_round: int = 100,
       folds=None, nfold: int = 5, stratified: bool = True,
       shuffle: bool = True, metrics=None, feval=None, init_model=None,
       seed: int = 0, callbacks=None, eval_train_metric: bool = False,
       return_cvbooster: bool = False) -> Dict[str, Any]:
    """Cross-validation (reference: engine.py:627): ``nfold`` folds (or
    ``folds``: (train rows, test rows) pairs or an sklearn splitter), one
    booster a fold trained round by round; returns ``"valid <metric>-mean"``
    / ``-stdv`` histories (``"train ..."`` too under
    ``eval_train_metric``), cut at the best round when
    ``early_stopping_round`` stops it. ``train_set`` needs
    ``free_raw_data=False``. ``callbacks``, ``feval`` and ``init_model``
    are refused by name: the JAX package's ``cv`` accepts them and never
    uses them (ROADMAP.md, Queue 3)."""
    for knob, value in (("callbacks", callbacks), ("feval", feval),
                        ("init_model", init_model)):
        if value is not None:
            raise NotImplementedError(
                f"cv({knob}=) is not ported to lambdagap_tpu_torch: the JAX "
                f"package's cv accepts {knob} and never uses it (ROADMAP.md, "
                "Queue 3)")
    params = dict(params)
    if metrics is not None:
        params["metric"] = metrics
    cfg = Config.from_params(params)
    num_boost_round = _num_rounds(params, num_boost_round)

    if folds is None:
        folds = list(_make_n_folds(
            train_set, nfold, params, seed,
            stratified and cfg.objective in ("binary", "multiclass",
                                             "multiclassova"), shuffle))
    elif hasattr(folds, "split"):
        # sklearn splitter objects (KFold and the like)
        ds = train_set.construct(cfg)
        label = (np.asarray(ds.metadata.label)
                 if ds.metadata.label is not None else None)
        groups = None
        if ds.metadata.query_boundaries is not None:
            groups = np.searchsorted(ds.metadata.query_boundaries,
                                     np.arange(ds.num_data),
                                     side="right") - 1
        folds = list(folds.split(np.zeros((ds.num_data, 1)), label, groups))

    cvbooster = CVBooster()
    for train_rows, test_rows in folds:
        tr = train_set.subset(train_rows)
        b = Booster(params=params, train_set=tr)
        if eval_train_metric:
            tds = tr.construct(b.config)
            b._booster.train_metrics = create_metrics(b.config, tds.metadata,
                                                      tds.num_data)
        b.add_valid(train_set.subset(test_rows), "valid")
        cvbooster.append(b)

    results: Dict[str, Any] = {}
    best, best_iter = float("inf"), 0
    first_metric: Optional[str] = None
    for i in range(num_boost_round):
        agg: Dict[Tuple[str, str, bool], List[float]] = {}
        for b in cvbooster.boosters:
            b.update()
            evals = list(b._booster.eval_valid())
            if eval_train_metric:
                evals.extend(("train", m, v, g)
                             for (_, m, v, g) in b._booster.eval_train())
            for d, m, v, g in evals:
                agg.setdefault((d, m, g), []).append(v)
        if first_metric is None:
            # early stopping follows the FIRST metric on the validation
            # folds (reference: engine.py cv + _agg_cv_result)
            first_metric = next((m for d, m, _ in agg if d == "valid"), "")
        stop_now = False
        for (d, m, g), vals in agg.items():
            mean, std = float(np.mean(vals)), float(np.std(vals))
            results.setdefault(f"{d} {m}-mean", []).append(mean)
            results.setdefault(f"{d} {m}-stdv", []).append(std)
            if cfg.early_stopping_round > 0 and d == "valid" \
                    and m == first_metric:
                score = -mean if g else mean
                if score < best:
                    best, best_iter = score, i
                elif i - best_iter >= cfg.early_stopping_round:
                    stop_now = True
        if stop_now:
            cvbooster.best_iteration = best_iter + 1
            for key in results:
                results[key] = results[key][:best_iter + 1]
            break
    if return_cvbooster:
        results["cvbooster"] = cvbooster
    return results
