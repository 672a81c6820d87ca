"""Tree-learner plumbing shared by the port's learners.

The part of ``lambdagap_tpu/models/learner.py`` that the fused learner
inherits: the per-feature bin metadata on the training device, the
``SplitParams`` from the config, per-tree column sampling with the JAX
package's numpy ``RandomState`` draw (so the same seed samples the same
features), the layout resolution and the export of categorical bitsets.
The host-driven leaf-wise learner itself (``SerialTreeLearner.train``)
waits for a later slice.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import Config
from ..data.dataset import BinnedDataset
from ..ops.split import SplitParams


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


class SerialTreeLearner:
    """Single-device leaf-wise learner over a BinnedDataset (the bin
    metadata and sampling plumbing; training is the fused subclass's)."""

    def __init__(self, dataset: BinnedDataset, config: Config,
                 device: torch.device) -> None:
        self.dataset = dataset
        self.config = config
        self.device = device
        self.num_data = dataset.num_data
        self.num_features = dataset.num_features
        meta = dataset.feature_arrays()
        self.meta_host = meta

        def up(a):
            return torch.from_numpy(np.asarray(a)).to(device)

        self.num_bins_arr = up(meta["num_bins"].astype(np.int64))
        self.default_bins_arr = up(meta["default_bins"].astype(np.int64))
        self.missing_types_arr = up(meta["missing_types"].astype(np.int64))
        self.is_categorical_arr = up(meta["is_categorical"])
        self.has_categorical = bool(meta["is_categorical"].any())
        # uniform per-feature bin budget (a power of two, at least 8)
        self.B = max(_next_pow2(int(meta["num_bins"].max())), 8)
        self.params = SplitParams.from_config(config)
        self.layout = self._resolve_layout(config)
        self._col_rng = np.random.RandomState(config.feature_fraction_seed)

    @staticmethod
    def _resolve_layout(config: Config) -> str:
        """``tree_layout``: auto and gather resolve to the gather layout (the
        JAX package holds its two layouts bit-identical, so the trees do not
        depend on the choice); the physically sorted layout is not ported."""
        if config.tree_layout == "sorted":
            raise NotImplementedError(
                "tree_layout=sorted is not ported to lambdagap_tpu_torch yet "
                "(ROADMAP.md, port slice 3); use tree_layout=auto or gather")
        return "gather"

    def _feature_mask(self) -> torch.Tensor:
        """Per-tree column sampling (reference: src/treelearner/
        col_sampler.hpp), the JAX package's draw: bool [F] on the device."""
        frac = self.config.feature_fraction
        mask = np.ones(self.num_features, dtype=bool)
        if frac < 1.0:
            k = max(1, int(np.ceil(frac * self.num_features)))
            chosen = self._col_rng.choice(self.num_features, k,
                                          replace=False)
            mask[:] = False
            mask[chosen] = True
        return torch.from_numpy(mask).to(self.device)

    def _cat_bitset_real(self, feature_k: int,
                         bitset_bins: np.ndarray) -> np.ndarray:
        """A bin-space bitset -> raw-category space for model export, sized
        to the largest selected category (reference: Common::ConstructBitset,
        src/io/tree.cpp cat_threshold_)."""
        mapper = self.dataset.mappers[self.dataset.used_features[feature_k]]
        cats = []
        for b in range(mapper.num_bin):
            if (int(bitset_bins[b // 32]) >> (b % 32)) & 1:
                cat = (mapper.bin_2_categorical[b]
                       if b < len(mapper.bin_2_categorical) else -1)
                if cat >= 0:
                    cats.append(int(cat))
        words = max(8, (max(cats) + 32) // 32) if cats else 8
        out = np.zeros(words, dtype=np.uint32)
        for cat in cats:
            out[cat // 32] |= np.uint32(1) << np.uint32(cat % 32)
        return out

    def train(self, grad, hess):
        raise NotImplementedError(
            "the host-driven SerialTreeLearner is not ported to "
            "lambdagap_tpu_torch yet (ROADMAP.md, port slice 3); "
            "tpu_fused_learner=auto trains with FusedTreeLearner")
