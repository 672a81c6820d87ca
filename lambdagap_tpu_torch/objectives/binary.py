"""Binary log-loss output conversion (reference:
src/objective/binary_objective.hpp ConvertOutput)."""
from __future__ import annotations

import torch

from ..config import Config
from .base import ObjectiveFunction, register_objective


@register_objective
class BinaryLogloss(ObjectiveFunction):
    name = "binary"

    def __init__(self, config: Config) -> None:
        super().__init__(config)
        self.sigmoid = config.sigmoid

    def convert_output(self, scores: torch.Tensor) -> torch.Tensor:
        return 1.0 / (1.0 + torch.exp(-self.sigmoid * scores))
