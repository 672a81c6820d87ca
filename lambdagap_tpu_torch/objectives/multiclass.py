"""Multiclass objectives: softmax and one-vs-all (reference:
src/objective/multiclass_objective.hpp MulticlassSoftmax with the
K/(K-1) hessian factor, MulticlassOVA wrapping one BinaryLogloss per
class). The port of ``lambdagap_tpu/objectives/multiclass.py``."""
from __future__ import annotations

import numpy as np
import torch

from ..config import Config
from ..data.dataset import Metadata
from ..utils import log
from .base import K_EPSILON, ObjectiveFunction, exp64, register_objective
from .binary import BinaryLogloss


@register_objective
class MulticlassSoftmax(ObjectiveFunction):
    name = "multiclass"

    def __init__(self, config: Config) -> None:
        super().__init__(config)
        self._num_class = config.num_class
        if self._num_class < 2:
            log.fatal("[multiclass]: num_class must be >= 2, got %d",
                      self._num_class)
        self.factor = self._num_class / (self._num_class - 1.0)

    @property
    def num_class(self) -> int:
        return self._num_class

    def init(self, metadata, num_data: int, device: torch.device) -> None:
        super().init(metadata, num_data, device)
        y = self.label_np.astype(np.int32)
        if np.any((y < 0) | (y >= self._num_class)):
            log.fatal("[multiclass]: label must be in [0, num_class)")
        self.onehot = (torch.arange(self._num_class, device=device)[:, None]
                       == torch.from_numpy(y).to(device)[None, :]).float()
        # class priors for the init score (reference:
        # multiclass_objective.hpp:56-76)
        probs = np.zeros(self._num_class)
        for k in range(self._num_class):
            if self.weight_np is not None:
                probs[k] = (np.sum((y == k) * self.weight_np)
                            / np.sum(self.weight_np))
            else:
                probs[k] = np.mean(y == k)
        self.class_init_probs = probs

    def get_gradients_fast(self, scores):
        """(reference: multiclass_objective.hpp:85-130)"""
        p = _softmax0(scores)
        grad = p - self.onehot
        hess = self.factor * p * (1.0 - p)
        if self.weight is not None:
            grad = grad * self.weight[None, :]
            hess = hess * self.weight[None, :]
        return grad, hess

    def boost_from_score(self, class_id: int) -> float:
        if not self.config.boost_from_average:
            return 0.0
        return float(np.log(max(K_EPSILON, self.class_init_probs[class_id])))

    def convert_output(self, scores: torch.Tensor) -> torch.Tensor:
        return _softmax0(scores)


def _softmax0(scores: torch.Tensor) -> torch.Tensor:
    """Softmax over the class axis of ``[K, N]`` f32 scores, as the JAX
    package's ``_softmax0``: ``exp(s - max)`` over its class sum. The
    ``exp`` is float64 rounded once; the class sum adds the K rows in class
    order in float32, the order XLA reduces them in, and elementwise adds
    round alike on the card and the CPU (a reduction kernel's order is its
    own)."""
    m = torch.amax(scores, dim=0, keepdim=True)
    e = exp64(scores - m)
    total = e[0]
    for k in range(1, e.shape[0]):
        total = total + e[k]
    return e / total


@register_objective
class MulticlassOVA(ObjectiveFunction):
    """One-vs-all: K independent sigmoid classifiers
    (reference: multiclass_objective.hpp:180-270)."""
    name = "multiclassova"

    def __init__(self, config: Config) -> None:
        super().__init__(config)
        self._num_class = config.num_class
        self.sigmoid = config.sigmoid
        self.binary = [BinaryLogloss(config) for _ in range(self._num_class)]

    @property
    def num_class(self) -> int:
        return self._num_class

    def init(self, metadata, num_data: int, device: torch.device) -> None:
        super().init(metadata, num_data, device)
        y = self.label_np.astype(np.int32)
        for k in range(self._num_class):
            self.binary[k].init(
                Metadata(label=(y == k).astype(np.float32),
                         weight=self.weight_np), num_data, device)

    def get_gradients_fast(self, scores):
        gh = [self.binary[k].get_gradients_fast(scores[k][None, :])
              for k in range(self._num_class)]
        return (torch.cat([g for g, _ in gh]), torch.cat([h for _, h in gh]))

    def boost_from_score(self, class_id: int) -> float:
        return self.binary[class_id].boost_from_score(0)

    def convert_output(self, scores: torch.Tensor) -> torch.Tensor:
        return 1.0 / (1.0 + torch.exp(-self.sigmoid * scores))
