"""Multiclass output conversions: softmax and one-vs-all sigmoids
(reference: src/objective/multiclass_objective.hpp ConvertOutput)."""
from __future__ import annotations

import torch

from ..config import Config
from ..utils import log
from .base import ObjectiveFunction, register_objective


@register_objective
class MulticlassSoftmax(ObjectiveFunction):
    name = "multiclass"

    def __init__(self, config: Config) -> None:
        super().__init__(config)
        self._num_class = config.num_class
        if self._num_class < 2:
            log.fatal("[multiclass]: num_class must be >= 2, got %d",
                      self._num_class)

    @property
    def num_class(self) -> int:
        return self._num_class

    def convert_output(self, scores: torch.Tensor) -> torch.Tensor:
        m = torch.amax(scores, dim=0, keepdim=True)
        e = torch.exp(scores - m)
        return e / torch.sum(e, dim=0, keepdim=True)


@register_objective
class MulticlassOVA(ObjectiveFunction):
    """One-vs-all: K independent sigmoid classifiers
    (reference: multiclass_objective.hpp:180-270)."""
    name = "multiclassova"

    def __init__(self, config: Config) -> None:
        super().__init__(config)
        self._num_class = config.num_class
        self.sigmoid = config.sigmoid

    @property
    def num_class(self) -> int:
        return self._num_class

    def convert_output(self, scores: torch.Tensor) -> torch.Tensor:
        return 1.0 / (1.0 + torch.exp(-self.sigmoid * scores))
