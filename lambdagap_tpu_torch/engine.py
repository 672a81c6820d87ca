"""Training entry point: ``train()`` (reference:
python-package/lightgbm/engine.py:109). The port of
``lambdagap_tpu/engine.py``'s ``train`` with validation sets, callbacks and
``early_stopping_round``. A validation set's query groups reach its
metrics, so a ranker reports ``ndcg@k`` / ``map@k`` / ``precision@k`` per
``eval_at`` position, greater is better. ``cv``, ``feval``,
``init_model`` and crash-safe resume wait for later slices.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

from . import callback as callback_mod
from .basic import Booster, Dataset
from .callback import CallbackEnv, EarlyStopException
from .config import Config
from .metrics import create_metrics


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100,
          valid_sets: Optional[List[Dataset]] = None,
          valid_names: Optional[List[str]] = None,
          feval: Optional[Callable] = None,
          init_model=None,
          callbacks: Optional[List[Callable]] = None) -> Booster:
    """Train a booster (reference: engine.py:109). Runs on the card unless
    ``params`` says ``device_type="cpu"``."""
    if feval is not None:
        raise NotImplementedError("feval is not ported to lambdagap_tpu_torch "
                                  "yet (ROADMAP.md, port queue)")
    if init_model is not None:
        raise NotImplementedError("init_model (continued training) is not "
                                  "ported to lambdagap_tpu_torch yet "
                                  "(ROADMAP.md, port queue)")
    params = dict(params)
    cfg = Config.from_params(params)
    if "num_iterations" not in {Config.canonical_name(k) for k in params}:
        cfg.num_iterations = num_boost_round
    num_boost_round = cfg.num_iterations

    booster = Booster(params=params, train_set=train_set)
    gb = booster._booster
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
    cbs.sort(key=lambda cb: getattr(cb, "order", 0))

    evals: list = []
    for i in range(num_boost_round):
        stop = booster.update()
        evals = []
        if valid_contains_train:
            train_name = getattr(booster, "_train_name", "training")
            evals.extend((train_name, m, v, g)
                         for (_, m, v, g) in gb.eval_train())
        evals.extend(gb.eval_valid())
        env = CallbackEnv(model=booster, params=params, iteration=i,
                          begin_iteration=0, end_iteration=num_boost_round,
                          evaluation_result_list=evals)
        try:
            for cb in cbs:
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
