"""Cross-entropy objectives for probabilistic labels in [0, 1]
(reference: src/objective/xentropy_objective.hpp CrossEntropy, and
CrossEntropyLambda, the variant whose weights act as Bernoulli trial
counts). The port of ``lambdagap_tpu/objectives/xentropy.py``: its float32
operations in the same order, each ``exp`` and ``log1p`` taken in float64
and rounded once, and each multiply-add that XLA contracts rounded once
(``fma32``)."""
from __future__ import annotations

import numpy as np
import torch

from ..utils import log
from .base import (K_EPSILON, ObjectiveFunction, exp64, fma32, log1p64,
                   register_objective)


class _LabelsInUnitInterval(ObjectiveFunction):
    def init(self, metadata, num_data: int, device: torch.device) -> None:
        super().init(metadata, num_data, device)
        if np.any((self.label_np < 0) | (self.label_np > 1)):
            log.fatal("[%s]: labels must be in [0, 1]", self.name)


def _logit(pavg: float) -> float:
    pavg = min(max(pavg, K_EPSILON), 1.0 - K_EPSILON)
    return float(np.log(pavg / (1.0 - pavg)))


@register_objective
class CrossEntropy(_LabelsInUnitInterval):
    """(reference: xentropy_objective.hpp:30-160 CrossEntropy)"""
    name = "cross_entropy"

    def get_gradients_fast(self, scores):
        p = 1.0 / (1.0 + exp64(-scores))
        grad = p - self.label[None, :]
        hess = p * (1.0 - p)
        if self.weight is not None:
            grad = grad * self.weight[None, :]
            hess = hess * self.weight[None, :]
        return grad, hess

    def boost_from_score(self, class_id: int) -> float:
        if self.weight_np is not None:
            return _logit(float(np.sum(self.label_np * self.weight_np)
                                / max(np.sum(self.weight_np), K_EPSILON)))
        return _logit(float(np.mean(self.label_np)))

    def convert_output(self, scores: torch.Tensor) -> torch.Tensor:
        return 1.0 / (1.0 + torch.exp(-scores))


@register_objective
class CrossEntropyLambda(_LabelsInUnitInterval):
    """(reference: xentropy_objective.hpp:165-310 CrossEntropyLambda):
    weights act as Bernoulli trial counts, z = 1 - exp(-w*log1p(exp(s))).

    Weighted, the gradient and hessian are the JAX package's float32
    expressions. That hessian is not the loss's second derivative and turns
    negative on soft labels (ROADMAP.md Queue 3); the port keeps it, as
    the JAX package has it."""
    name = "cross_entropy_lambda"

    def get_gradients_fast(self, scores):
        if self.weight is None:
            z = 1.0 / (1.0 + exp64(-scores))
            return z - self.label[None, :], z * (1.0 - z)
        y = self.label[None, :]
        w = self.weight[None, :]
        epf = exp64(scores)
        enf = exp64(-scores)          # XLA's rewrite of 1 / exp(s)
        hhat = log1p64(epf)
        z = 1.0 - exp64(-w * hhat)
        grad = (1.0 - y / torch.clamp(z, min=K_EPSILON)) * w / (1.0 + enf)
        c = 1.0 / (1.0 - torch.clamp(z, min=K_EPSILON))
        # 1 - c*enf*(z - w*hhat*(1-z)), with XLA's two multiply-adds
        b = fma32(-(c * enf), fma32(-(w * hhat), 1.0 - z, z), 1.0)
        b = b / torch.clamp(z * z, min=K_EPSILON)
        a = w * epf / ((1.0 + epf) * (1.0 + epf))
        return grad, a * fma32(y, b, 1.0)

    def boost_from_score(self, class_id: int) -> float:
        return _logit(float(np.mean(self.label_np)))

    def convert_output(self, scores: torch.Tensor) -> torch.Tensor:
        return torch.log1p(torch.exp(scores))
