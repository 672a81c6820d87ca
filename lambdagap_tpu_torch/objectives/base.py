"""Objective interface + factory.

The port of ``lambdagap_tpu/objectives/base.py``: each objective carries
the ``name`` (and ``sigmoid``) that ``GBDT.from_model_string`` parses out
of the model text and converts raw scores ``[K, N]`` to the output space
with torch ops on the scores' own device. Every objective
also trains: it holds its label and weight tensors on the training device
(``init``), computes gradients (``get_gradients_fast``: scores ``[K, N]``
-> grad, hess ``[K, N]`` f32, the JAX package's f32 operations in the same
order) and the boost-from-average init score (host numpy, as the JAX
package does it). The L1 family (``regression_l1``, ``quantile``,
``mape``) also refits each leaf on the host
(``renew_tree_output``, by :func:`weighted_percentile`).

A transcendental (``exp``, ``log1p``) that feeds a gradient is taken in
float64 and rounded once to float32: eager CUDA and CPU float32 ``exp``
differ in the last bit, and a split tie or GOSS's top-k turns such a bit
into another tree, so card and CPU train alike only when both round the
same float64 value.

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
        raise NotImplementedError

    def boost_from_score(self, class_id: int) -> float:
        """Initial score (reference: BoostFromScore per objective)."""
        return 0.0

    def convert_output(self, scores: torch.Tensor) -> torch.Tensor:
        """Raw score ``[K, N]`` -> output space (e.g. sigmoid/exp/softmax)."""
        return scores

    @property
    def num_class(self) -> int:
        return 1

    # -- leaf renewal (L1 family) ---------------------------------------
    @property
    def is_renew_tree_output(self) -> bool:
        return False

    def renew_tree_output(self, leaf_rows: np.ndarray,
                          score: np.ndarray) -> float:
        """One leaf's output refit from its rows (host numpy; reference:
        RenewTreeOutput with residual_getter + weighted percentile)."""
        raise NotImplementedError


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
        log.fatal("Unknown objective: %s", name)
    return _REGISTRY[name](config)


def exp64(x: torch.Tensor) -> torch.Tensor:
    """``exp`` of a float32 tensor, taken in float64 and rounded once."""
    return torch.exp(x.double()).float()


def log1p64(x: torch.Tensor) -> torch.Tensor:
    """``log1p`` of a float32 tensor, taken in float64 and rounded once."""
    return torch.log1p(x.double()).float()


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` of float32 tensors with the product unrounded, as XLA's
    CPU fusions contract a multiply feeding an add into one fused
    multiply-add. The product of two float32 values is exact in float64;
    the sum is rounded there and then to float32."""
    return (a.double() * b.double() + c).float()


def weighted_percentile(values: np.ndarray, weights: Optional[np.ndarray],
                        alpha: float) -> float:
    """Weighted percentile matching the reference's PercentileFun /
    WeightedPercentileFun (reference:
    src/objective/regression_objective.hpp:23-87); the JAX package's
    numpy arithmetic unchanged."""
    n = len(values)
    if n == 0:
        return 0.0
    if n <= 1:
        return float(values[0])
    order = np.argsort(values)
    v = values[order]
    if weights is None:
        pos = alpha * (n - 1)
        lo = int(np.floor(pos))
        hi = min(lo + 1, n - 1)
        frac = pos - lo
        return float(v[lo] * (1 - frac) + v[hi] * frac)
    w = weights[order].astype(np.float64)
    cum = np.cumsum(w) - w[0]
    total = float(np.sum(w))
    threshold = alpha * (total - w[0])
    idx = int(np.searchsorted(cum, threshold, side="right")) - 1
    idx = max(0, min(idx, n - 2))
    if cum[idx + 1] - cum[idx] > 0:
        frac = (threshold - cum[idx]) / (cum[idx + 1] - cum[idx])
    else:
        frac = 0.0
    return float(v[idx] * (1 - frac) + v[idx + 1] * frac)
