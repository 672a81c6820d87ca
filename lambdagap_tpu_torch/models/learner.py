"""Tree-learner plumbing shared by the port's learners.

The part of ``lambdagap_tpu/models/learner.py`` that the fused learner
inherits: the per-feature bin metadata on the training device, the
``SplitParams`` from the config, per-tree column sampling with the JAX
package's numpy ``RandomState`` draw (so the same seed samples the same
features), the tree options' state (monotone constraints, interaction
groups, extra_trees, ``feature_contri``, the forced-split JSON and its
bin mapping; ``lambdagap_tpu/models/learner.py:130-232,678-705``), the
layout resolution and the export of categorical bitsets. The host-driven
leaf-wise learner itself (``SerialTreeLearner.train``) waits for a later
slice.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..data.dataset import BinnedDataset
from ..ops.split import SplitParams
from ..utils import log


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
        self._init_options(dataset, config)

    def _init_options(self, dataset: BinnedDataset, config: Config) -> None:
        """The tree options, mapped from original to used features."""
        F = self.num_features
        used = dataset.used_features
        self._inner_of = {j: k for k, j in enumerate(used)}

        def per_feature(values, default, dtype):
            out = np.full(F, default, dtype=dtype)
            for k, j in enumerate(used):
                if j < len(values):
                    out[k] = values[j]
            return out

        # monotone constraints (reference: monotone_constraints.hpp; the
        # basic and intermediate methods)
        self.mono_method = config.monotone_constraints_method
        mono = per_feature([int(m) for m in config.monotone_constraints], 0,
                           np.int64)
        if (mono != 0)[self.meta_host["is_categorical"]].any():
            log.fatal("monotone_constraints cannot be set on categorical "
                      "features")
        self.mono_np = mono
        self.mono_arr = torch.from_numpy(mono).to(self.device)
        self.mono_on = bool((mono != 0).any())
        self.mono_penalty = float(config.monotone_penalty)
        # interaction constraints (reference: col_sampler.hpp interaction
        # sets): groups of inner feature indices
        self.ic_groups = None
        if config.interaction_constraints:
            self.ic_groups = [frozenset(self._inner_of[j] for j in g
                                        if j in self._inner_of)
                              for g in config.interaction_constraints]
        # extra_trees: one uniform-random threshold bin per feature and
        # scan (reference: feature_histogram.hpp:192-205 USE_RAND)
        self.extra_on = bool(config.extra_trees)
        self.nb_minus1 = np.maximum(
            self.meta_host["num_bins"].astype(np.int64) - 1, 1)
        # feature_contri: a multiplier on each feature's post-shift gain
        # (reference: feature_histogram.hpp:174 output->gain *= penalty)
        self.contri_arr = None
        if config.feature_contri:
            self.contri_arr = torch.from_numpy(per_feature(
                [float(v) for v in config.feature_contri], 1.0,
                np.float32)).to(self.device)
        # forced splits (reference: serial_tree_learner.cpp:624 ForceSplits;
        # the schema of examples/binary_classification/forced_splits.json)
        self.forced_json = None
        if config.forcedsplits_filename:
            import json
            try:
                with open(config.forcedsplits_filename) as fh:
                    fj = json.load(fh)
            except (OSError, ValueError) as e:
                log.fatal("cannot read forcedsplits_filename=%r: %s",
                          config.forcedsplits_filename, e)
            if fj:
                self.forced_json = fj

    def _forced_bin(self, node) -> Optional[Tuple[int, int]]:
        """A forced-split JSON node -> (inner feature, threshold bin), or
        None (forcing aborts) when the feature is unused or the threshold
        maps to no bin (the analog of InnerFeatureIndex + BinThreshold in
        ForceSplits)."""
        try:
            j = int(node["feature"])
            thr = float(node["threshold"])
        except (KeyError, TypeError, ValueError):
            log.warning("Malformed forced-split node %r; aborting forced "
                        "splits", node)
            return None
        k = self._inner_of.get(j)
        if k is None:
            log.warning("Forced split on unused feature %d; aborting forced "
                        "splits", j)
            return None
        mapper = self.dataset.mappers[j]
        if self.meta_host["is_categorical"][k]:
            thr_bin = mapper.categorical_2_bin.get(int(thr))
            if thr_bin is None:
                log.warning("Forced categorical split on unseen category %d "
                            "of feature %d; aborting forced splits",
                            int(thr), j)
                return None
        else:
            thr_bin = mapper._value_to_bin_scalar(thr)
        return k, int(thr_bin)

    @staticmethod
    def _resolve_layout(config: Config) -> str:
        """``tree_layout``: auto and gather resolve to the gather layout (the
        JAX package holds its two layouts bit-identical, so the trees do not
        depend on the choice); the physically sorted layout is not ported."""
        if config.tree_layout == "sorted":
            raise NotImplementedError(
                "tree_layout=sorted is not ported to lambdagap_tpu_torch yet "
                "(ROADMAP.md, Queue 1); use tree_layout=auto or gather")
        return "gather"

    def _feature_mask(self) -> np.ndarray:
        """Per-tree column sampling (reference: src/treelearner/
        col_sampler.hpp), the JAX package's draw: bool [F] on the host."""
        frac = self.config.feature_fraction
        mask = np.ones(self.num_features, dtype=bool)
        if frac < 1.0:
            k = max(1, int(np.ceil(frac * self.num_features)))
            chosen = self._col_rng.choice(self.num_features, k,
                                          replace=False)
            mask[:] = False
            mask[chosen] = True
        return mask

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
            "lambdagap_tpu_torch yet (ROADMAP.md, Queue 1); "
            "tpu_fused_learner=auto trains with FusedTreeLearner")
