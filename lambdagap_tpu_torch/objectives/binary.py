"""Binary log-loss (reference: src/objective/binary_objective.hpp
BinaryLogloss — sigmoid-scaled logistic loss with unbalanced-label weighting
and scale_pos_weight)."""
from __future__ import annotations

import numpy as np
import torch

from ..config import Config
from ..utils import log
from .base import K_EPSILON, ObjectiveFunction, exp64, register_objective


@register_objective
class BinaryLogloss(ObjectiveFunction):
    name = "binary"

    def __init__(self, config: Config) -> None:
        super().__init__(config)
        self.sigmoid = config.sigmoid
        self.need_train = True

    def init(self, metadata, num_data: int, device: torch.device) -> None:
        super().init(metadata, num_data, device)
        y = self.label_np
        if not np.all((y == 0) | (y == 1)):
            log.fatal("[binary]: labels must be 0 or 1")
        cnt_pos = int(np.sum(y == 1))
        cnt_neg = num_data - cnt_pos
        if cnt_pos == 0 or cnt_neg == 0:
            log.warning("[binary]: contains only one class")
            self.need_train = False
        # label weights (reference: binary_objective.hpp:85-101)
        w_pos, w_neg = 1.0, 1.0
        if self.config.is_unbalance and cnt_pos > 0 and cnt_neg > 0:
            if cnt_pos > cnt_neg:
                w_neg = cnt_pos / cnt_neg
            else:
                w_pos = cnt_neg / cnt_pos
        w_pos *= self.config.scale_pos_weight
        lw = np.where(y == 1, w_pos, w_neg).astype(np.float32)
        if self.weight_np is not None:
            lw = lw * self.weight_np
        self.label_signed = torch.from_numpy(
            np.where(y == 1, 1.0, -1.0).astype(np.float32)).to(device)
        self.label_weight = torch.from_numpy(lw).to(device)

    def get_gradients_fast(self, scores):
        """(reference: binary_objective.hpp:105-134). float32, as in the
        JAX package, except that ``exp`` is taken in float64 and rounded
        once: the card's float32 ``exp`` and the CPU's differ in the last
        bit, and GOSS's top-k selection turns such a bit into a different
        sample; in float64 both round to the same float32."""
        s = self.sigmoid
        ls = self.label_signed[None, :]
        e = exp64(ls * s * scores)
        response = -ls * s / (1.0 + e)
        abs_r = response.abs()
        grad = response * self.label_weight[None, :]
        hess = abs_r * (s - abs_r) * self.label_weight[None, :]
        return grad, hess

    def boost_from_score(self, class_id: int) -> float:
        """(reference: binary_objective.hpp:139-164)"""
        if not self.config.boost_from_average or not self.need_train:
            return 0.0
        if self.weight_np is not None:
            suml = float(np.sum((self.label_np == 1) * self.weight_np))
            sumw = float(np.sum(self.weight_np))
        else:
            suml = float(np.sum(self.label_np == 1))
            sumw = float(self.num_data)
        pavg = min(max(suml / max(sumw, K_EPSILON), K_EPSILON),
                   1.0 - K_EPSILON)
        init = np.log(pavg / (1.0 - pavg)) / self.sigmoid
        log.info("[binary:BoostFromScore]: pavg=%.6f -> initscore=%.6f",
                 pavg, init)
        return float(init)

    def convert_output(self, scores: torch.Tensor) -> torch.Tensor:
        return 1.0 / (1.0 + torch.exp(-self.sigmoid * scores))
