"""Training callbacks (reference: python-package/lightgbm/callback.py —
log_evaluation, record_evaluation, reset_parameter, early_stopping). The
port of ``lambdagap_tpu/callback.py``. A callback with
``before_iteration = True`` (``reset_parameter``) runs before each
round's update, the others after it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Tuple

from .utils import log


@dataclass
class CallbackEnv:
    model: Any
    params: Dict[str, Any]
    iteration: int
    begin_iteration: int
    end_iteration: int
    evaluation_result_list: List[Tuple[str, str, float, bool]]


class EarlyStopException(Exception):
    def __init__(self, best_iteration: int, best_score) -> None:
        super().__init__()
        self.best_iteration = best_iteration
        self.best_score = best_score


def log_evaluation(period: int = 1, show_stdv: bool = True) -> Callable:
    def _callback(env: CallbackEnv) -> None:
        if period > 0 and env.evaluation_result_list \
                and (env.iteration + 1) % period == 0:
            result = "\t".join(f"{d}'s {m}: {v:g}"
                               for d, m, v, _ in env.evaluation_result_list)
            log.info("[%d]\t%s", env.iteration + 1, result)
    _callback.order = 10
    return _callback


def record_evaluation(eval_result: Dict[str, Dict[str, List[float]]]
                      ) -> Callable:
    def _callback(env: CallbackEnv) -> None:
        for data_name, metric_name, value, _ in env.evaluation_result_list:
            eval_result.setdefault(data_name, {}).setdefault(
                metric_name, []).append(value)
    _callback.order = 20
    return _callback


def reset_parameter(**kwargs) -> Callable:
    """Reset parameters (e.g. ``learning_rate``) before each round: a
    value is a list indexed by the round, a function of the round, or a
    constant."""
    def _callback(env: CallbackEnv) -> None:
        new_params = {}
        for key, value in kwargs.items():
            if callable(value):
                new_params[key] = value(env.iteration - env.begin_iteration)
            elif isinstance(value, (list, tuple)):
                new_params[key] = value[env.iteration - env.begin_iteration]
            else:
                new_params[key] = value
        if new_params:
            env.model.reset_parameter(new_params)
    _callback.before_iteration = True
    _callback.order = 10
    return _callback


def early_stopping(stopping_rounds: int, first_metric_only: bool = False,
                   verbose: bool = True, min_delta: float = 0.0) -> Callable:
    """(reference: callback.py early_stopping — track the best score per
    (dataset, metric); stop when none improved for stopping_rounds.)"""
    state: Dict[str, Any] = {}

    def _init(env: CallbackEnv) -> None:
        state["best_score"] = {}
        state["best_iter"] = {}
        state["best_list"] = {}
        state["first_metric"] = (env.evaluation_result_list[0][1]
                                 if env.evaluation_result_list else "")
        state["enabled"] = any(d != "training"
                               for d, *_ in env.evaluation_result_list)
        if not state["enabled"] and verbose:
            log.warning("Early stopping requires at least one validation set")

    def _callback(env: CallbackEnv) -> None:
        if "best_score" not in state:
            _init(env)
        if not state["enabled"]:
            return
        improved_any = False
        for d, m, v, greater in env.evaluation_result_list:
            if d == "training":
                continue
            if first_metric_only and m != state["first_metric"]:
                continue
            key = f"{d} {m}"
            best = state["best_score"].get(key)
            if (best is None or (greater and v > best + min_delta)
                    or (not greater and v < best - min_delta)):
                state["best_score"][key] = v
                state["best_iter"][key] = env.iteration
                state["best_list"][key] = list(env.evaluation_result_list)
                improved_any = True
        if not improved_any:
            best_iter = max(state["best_iter"].values())
            if env.iteration - best_iter >= stopping_rounds:
                if verbose:
                    log.info("Early stopping, best iteration is: [%d]",
                             best_iter + 1)
                raise EarlyStopException(
                    best_iter, state["best_list"][max(
                        state["best_iter"], key=state["best_iter"].get)])
    _callback.order = 30
    return _callback
