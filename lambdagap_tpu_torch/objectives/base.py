"""Objective interface + factory: the output side only.

The loaded-model half of ``lambdagap_tpu/objectives/base.py``: each
objective carries the ``name`` (and ``sigmoid``) that
``GBDT.from_model_string`` parses out of the model text, and converts raw
scores ``[K, N]`` to the output space with torch ops on the scores' own
device. Gradients wait for the training slice.

Each conversion repeats the JAX package's f32 operations in the same order;
only ``exp`` differs between the libraries, which is why converted outputs
are held to the JAX package at a tolerance while raw scores are held
exactly.
"""
from __future__ import annotations

from typing import Dict, Optional, Type

import torch

from ..config import Config
from ..utils import log


class ObjectiveFunction:
    name = "base"

    def __init__(self, config: Config) -> None:
        self.config = config

    def convert_output(self, scores: torch.Tensor) -> torch.Tensor:
        """Raw score ``[K, N]`` -> output space (e.g. sigmoid/exp/softmax)."""
        return scores

    @property
    def num_class(self) -> int:
        return 1


_REGISTRY: Dict[str, Type[ObjectiveFunction]] = {}


def register_objective(cls: Type[ObjectiveFunction]) -> Type[ObjectiveFunction]:
    _REGISTRY[cls.name] = cls
    return cls


def create_objective(config: Config) -> Optional[ObjectiveFunction]:
    """(reference: ObjectiveFunction::CreateObjectiveFunction,
    src/objective/objective_function.cpp:20)"""
    name = config.objective
    if name == "none":
        return None
    if name not in _REGISTRY:
        if name in ("cross_entropy", "cross_entropy_lambda", "lambdarank",
                    "rank_xendcg"):
            raise NotImplementedError(
                f"objective={name} is not ported to lambdagap_tpu_torch yet "
                "(ROADMAP.md, port queue: ranking and cross-entropy "
                "objectives)")
        log.fatal("Unknown objective: %s", name)
    return _REGISTRY[name](config)
