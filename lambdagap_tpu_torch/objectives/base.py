"""Objective interface + factory.

The port of ``lambdagap_tpu/objectives/base.py``: each objective carries
the ``name`` (and ``sigmoid``) that ``GBDT.from_model_string`` parses out
of the model text and converts raw scores ``[K, N]`` to the output space
with torch ops on the scores' own device. The objectives that train
(binary, L2 regression and the ranking family) also hold their label and
weight tensors on the training device (``init``), compute gradients
(``get_gradients_fast``: scores ``[K, N]`` -> grad, hess ``[K, N]`` f32,
the JAX package's f32 operations in the same order) and the
boost-from-average init score (host numpy, as the JAX package does it).

Each conversion repeats the JAX package's f32 operations in the same order;
only ``exp`` differs between the libraries, which is why converted outputs
are held to the JAX package at a tolerance while raw scores are held
exactly.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Type

import numpy as np
import torch

from ..config import Config
from ..utils import log

K_EPSILON = 1e-15


class ObjectiveFunction:
    name = "base"
    # objectives whose gradients are ported; the others convert outputs of
    # loaded models only
    trains = False

    def __init__(self, config: Config) -> None:
        self.config = config
        self.num_data = 0
        self.label_np: Optional[np.ndarray] = None
        self.weight_np: Optional[np.ndarray] = None
        self.label: Optional[torch.Tensor] = None
        self.weight: Optional[torch.Tensor] = None

    def init(self, metadata, num_data: int, device: torch.device) -> None:
        """Hold the training labels (and weights) on ``device``."""
        self.num_data = num_data
        if metadata.label is None:
            log.fatal("Objective %s requires labels", self.name)
        self.label_np = np.asarray(metadata.label, dtype=np.float32)
        if metadata.weight is not None:
            self.weight_np = np.asarray(metadata.weight, dtype=np.float32)
            self.weight = torch.from_numpy(self.weight_np).to(device)
        self.label = torch.from_numpy(self.label_np).to(device)

    def get_gradients_fast(self, scores: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
        """scores: [K, N] -> (grad, hess) each [K, N] f32."""
        raise NotImplementedError(
            f"objective={self.name} does not train in lambdagap_tpu_torch "
            "yet (ROADMAP.md, port queue)")

    def boost_from_score(self, class_id: int) -> float:
        """Initial score (reference: BoostFromScore per objective)."""
        return 0.0

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
        if name in ("cross_entropy", "cross_entropy_lambda"):
            raise NotImplementedError(
                f"objective={name} is not ported to lambdagap_tpu_torch yet "
                "(ROADMAP.md, port queue: cross-entropy objectives)")
        log.fatal("Unknown objective: %s", name)
    return _REGISTRY[name](config)
