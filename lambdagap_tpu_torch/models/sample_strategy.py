"""Row sampling strategies: bagging and GOSS.

The port of ``lambdagap_tpu/models/sample_strategy.py`` (reference:
src/boosting/sample_strategy.{h,cpp}, bagging.hpp, goss.hpp). Sampling
produces a boolean in-bag mask ``[N]`` on the gradients' device; out-of-bag
rows keep flowing through the partition with zeroed grad/hess, and the
histogram kernels leave them out of every channel through the mask.

Every draw comes from the port's copy of ``jax.random`` threefry
(``utils/prng``) on the JAX package's keys, so the masks and the amplified
gradients are the JAX package's bit for bit on the same inputs. Snapshot state
(``get_state``/``set_state``) waits for snapshots, which are refused before
training starts; by-query bagging waits for ranking (the port holds no
query groups, and without them the JAX package bags rows as here).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..utils import log, prng

Sample = Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]


class SampleStrategy:
    """Base: no sampling."""

    def __init__(self, config: Config, num_data: int) -> None:
        self.config = config
        self.num_data = num_data

    def sample(self, iter_: int, grad: torch.Tensor,
               hess: torch.Tensor) -> Sample:
        """Returns (grad, hess, mask); mask None means every row is in the
        bag."""
        return grad, hess, None


class BaggingStrategy(SampleStrategy):
    """Bernoulli subsample every ``bagging_freq`` iterations, with optional
    positive/negative class fractions (reference: bagging.hpp)."""

    def __init__(self, config: Config, num_data: int,
                 label: Optional[np.ndarray] = None) -> None:
        super().__init__(config, num_data)
        self.key = prng.PRNGKey(config.bagging_seed)
        self.cur_mask: Optional[torch.Tensor] = None
        self.balanced = (config.pos_bagging_fraction < 1.0
                         or config.neg_bagging_fraction < 1.0)
        self.label = label
        self._is_pos = None

    @property
    def enabled(self) -> bool:
        c = self.config
        return c.bagging_freq > 0 and (c.bagging_fraction < 1.0
                                       or self.balanced)

    def _make_mask(self, sub: torch.Tensor, device) -> torch.Tensor:
        c = self.config
        u = prng.uniform(sub, self.num_data, device)
        if self.balanced:
            if self._is_pos is None:
                self._is_pos = torch.from_numpy(
                    np.asarray(self.label) > 0).to(device)
            frac = torch.where(
                self._is_pos,
                torch.tensor(c.pos_bagging_fraction, dtype=torch.float32,
                             device=device),
                torch.tensor(c.neg_bagging_fraction, dtype=torch.float32,
                             device=device))
            return u < frac
        return u < torch.tensor(c.bagging_fraction, dtype=torch.float32,
                                device=device)

    def sample(self, iter_, grad, hess):
        c = self.config
        if not self.enabled:
            return grad, hess, None
        if iter_ % c.bagging_freq == 0:
            keys = prng.split(self.key)
            self.key = keys[0]
            self.cur_mask = self._make_mask(keys[1], grad.device)
        m = self.cur_mask
        mf = m.to(grad.dtype)
        return grad * mf, hess * mf, m


class GossStrategy(SampleStrategy):
    """Gradient-based one-side sampling (reference: goss.hpp): skip the
    first ``1/learning_rate`` iterations, keep the ``top_rate`` fraction by
    |g*h|, sample ``other_rate`` of the rest and amplify it by
    ``(1-top_rate)/other_rate``."""

    def __init__(self, config: Config, num_data: int) -> None:
        super().__init__(config, num_data)
        self.key = prng.PRNGKey(config.bagging_seed)

    def sample(self, iter_, grad, hess):
        c = self.config
        # (reference: goss.hpp:33 — 1/learning_rate warm-up iterations)
        if iter_ < max(1, int(1.0 / c.learning_rate)):
            return grad, hess, None
        keys = prng.split(self.key)
        self.key = keys[0]
        return goss_mask(grad, hess, keys[1], c.top_rate, c.other_rate)


def goss_mask(grad: torch.Tensor, hess: torch.Tensor, key: torch.Tensor,
              top_rate: float, other_rate: float) -> Sample:
    """The JAX package's ``_goss_mask``: every row whose |g*h| (summed over
    classes) reaches the ``top_rate`` quantile, ties included, plus a
    uniform draw of the rest. Python-float rates enter the float32
    comparisons and products rounded to float32, as JAX's weak types do."""
    N = grad.shape[-1]
    dev = grad.device
    score = torch.abs(grad * hess)
    if score.dim() > 1:
        score = torch.sum(score, dim=0)     # multiclass: combine classes
    top_k = max(1, int(top_rate * N))
    kth = torch.sort(score, descending=True).values[top_k - 1]
    is_top = score >= kth
    u = prng.uniform(key, N, dev)

    def f32(v: float) -> torch.Tensor:
        return torch.tensor(v, dtype=torch.float32, device=dev)

    keep_prob = other_rate / max(1.0 - top_rate, 1e-12)
    sampled_rest = (~is_top) & (u < f32(keep_prob))
    multiplier = (1.0 - top_rate) / max(other_rate, 1e-12)
    mask = is_top | sampled_rest
    amp = torch.where(sampled_rest, f32(multiplier), f32(1.0)).to(grad.dtype)
    mf = mask.to(grad.dtype) * amp
    return grad * mf, hess * mf, mask


def create_sample_strategy(config: Config, num_data: int,
                           label=None) -> SampleStrategy:
    """(reference: SampleStrategy::CreateSampleStrategy,
    src/boosting/sample_strategy.cpp)"""
    if config.data_sample_strategy == "goss":
        return GossStrategy(config, num_data)
    bs = BaggingStrategy(config, num_data, label)
    if bs.enabled:
        log.info("Using bagging, fraction=%g freq=%d",
                 config.bagging_fraction, config.bagging_freq)
    return bs
