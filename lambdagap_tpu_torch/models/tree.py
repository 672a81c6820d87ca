"""Tree model.

A copy of ``lambdagap_tpu/models/tree.py`` (the port imports nothing of the
JAX package): the reference's flat-array binary tree
(reference: include/LightGBM/tree.h:26, src/io/tree.cpp). A tree lives on
the host (appending one split per step, cheap) and is stacked into padded
device tensors for batched prediction (see
:mod:`lambdagap_tpu_torch.ops.predict`). ``rebind_to_dataset`` waits for
the training slice: it needs ``data/binning``.

Node encoding follows the reference: internal nodes are indexed 0..n-1; child
pointers are either an internal index (>= 0) or ``~leaf_index`` (< 0).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

MISSING_NONE_C, MISSING_ZERO_C, MISSING_NAN_C = 0, 1, 2
_FORCE_LEFT_BIN = 1 << 30      # threshold_bin sentinel: every bin goes left
_FORCE_RIGHT_BIN = -1          # threshold_bin sentinel: every bin goes right


@dataclass
class Tree:
    """One decision tree with up to ``max_leaves`` leaves."""

    max_leaves: int
    num_leaves: int = 1
    shrinkage: float = 1.0

    # per internal node (index 0..num_leaves-2)
    split_feature: List[int] = field(default_factory=list)   # original feature idx
    split_feature_inner: List[int] = field(default_factory=list)  # used-feature idx
    threshold_bin: List[int] = field(default_factory=list)
    threshold_real: List[float] = field(default_factory=list)
    default_left: List[bool] = field(default_factory=list)
    missing_type: List[int] = field(default_factory=list)
    left_child: List[int] = field(default_factory=list)
    right_child: List[int] = field(default_factory=list)
    split_gain: List[float] = field(default_factory=list)
    is_categorical: List[bool] = field(default_factory=list)
    cat_bitset: List[np.ndarray] = field(default_factory=list)      # bin-space bitsets
    cat_bitset_real: List[np.ndarray] = field(default_factory=list)  # raw category values
    internal_value: List[float] = field(default_factory=list)
    internal_weight: List[float] = field(default_factory=list)
    internal_count: List[int] = field(default_factory=list)

    # linear-tree payload (reference: tree.h is_linear_ / leaf_coeff_)
    is_linear: bool = False
    leaf_features: Optional[list] = None
    leaf_coeff: Optional[list] = None
    leaf_const: Optional[np.ndarray] = None

    # per leaf
    leaf_value: Optional[np.ndarray] = None
    leaf_weight: Optional[np.ndarray] = None
    leaf_count: Optional[np.ndarray] = None
    leaf_parent: Optional[np.ndarray] = None
    leaf_depth: Optional[np.ndarray] = None

    def __post_init__(self) -> None:
        self.leaf_value = np.zeros(self.max_leaves, dtype=np.float64)
        self.leaf_weight = np.zeros(self.max_leaves, dtype=np.float64)
        self.leaf_count = np.zeros(self.max_leaves, dtype=np.int64)
        self.leaf_parent = np.full(self.max_leaves, -1, dtype=np.int32)
        self.leaf_depth = np.zeros(self.max_leaves, dtype=np.int32)

    @property
    def num_internal(self) -> int:
        return self.num_leaves - 1

    def split(self, leaf: int, feature: int, feature_inner: int,
              threshold_bin: int, threshold_real: float, default_left: bool,
              missing_type: int, gain: float,
              left_value: float, right_value: float,
              left_weight: float, right_weight: float,
              left_count: int, right_count: int,
              is_categorical: bool = False,
              cat_bitset: Optional[np.ndarray] = None,
              cat_bitset_real: Optional[np.ndarray] = None) -> int:
        """Split ``leaf``; left child keeps the leaf index, right child becomes
        leaf ``num_leaves`` (reference: tree.h:63 Split / tree.cpp SplitInner).
        Returns the new right leaf index."""
        node = self.num_leaves - 1
        parent_node = self.leaf_parent[leaf]
        if parent_node >= 0:
            if self.left_child[parent_node] == ~leaf:
                self.left_child[parent_node] = node
            else:
                self.right_child[parent_node] = node

        new_leaf = self.num_leaves
        self.split_feature.append(int(feature))
        self.split_feature_inner.append(int(feature_inner))
        self.threshold_bin.append(int(threshold_bin))
        self.threshold_real.append(float(threshold_real))
        self.default_left.append(bool(default_left))
        self.missing_type.append(int(missing_type))
        self.left_child.append(~leaf)
        self.right_child.append(~new_leaf)
        self.split_gain.append(float(gain))
        self.is_categorical.append(bool(is_categorical))
        self.cat_bitset.append(cat_bitset if cat_bitset is not None
                               else np.zeros(8, dtype=np.uint32))
        self.cat_bitset_real.append(cat_bitset_real if cat_bitset_real is not None
                                    else np.zeros(8, dtype=np.uint32))
        parent_value = self.leaf_value[leaf]
        parent_weight = self.leaf_weight[leaf]
        self.internal_value.append(float(parent_value))
        self.internal_weight.append(float(parent_weight))
        self.internal_count.append(int(left_count + right_count))

        depth = self.leaf_depth[leaf] + 1
        self.leaf_value[leaf] = left_value
        self.leaf_weight[leaf] = left_weight
        self.leaf_count[leaf] = left_count
        self.leaf_parent[leaf] = node
        self.leaf_depth[leaf] = depth
        self.leaf_value[new_leaf] = right_value
        self.leaf_weight[new_leaf] = right_weight
        self.leaf_count[new_leaf] = right_count
        self.leaf_parent[new_leaf] = node
        self.leaf_depth[new_leaf] = depth
        self.num_leaves += 1
        return new_leaf

    def apply_shrinkage(self, rate: float) -> None:
        """(reference: tree.h Shrinkage) in float64."""
        self.leaf_value[:self.num_leaves] *= rate
        self.internal_value = [v * rate for v in self.internal_value]
        self.shrinkage *= rate

    @property
    def max_depth(self) -> int:
        return int(self.leaf_depth[:self.num_leaves].max()) if self.num_leaves > 1 else 0

    # ------------------------------------------------------------------
    def predict_row(self, row: np.ndarray) -> float:
        """Reference-semantics single-row traversal (host, for testing/export;
        reference: tree.h:130-141 Predict/NumericalDecision)."""
        if self.num_leaves == 1:
            leaf = 0
        else:
            node = 0
            while node >= 0:
                node = self._decision(row, node)
            leaf = ~node
        if self.is_linear:
            feats = self.leaf_features[leaf]
            vals = row[feats] if feats else np.empty(0)
            if not np.isnan(vals).any():
                return float(self.leaf_const[leaf]
                             + (vals @ self.leaf_coeff[leaf] if feats else 0.0))
        return float(self.leaf_value[leaf])

    def _decision(self, row: np.ndarray, node: int) -> int:
        fval = row[self.split_feature[node]]
        if self.is_categorical[node]:
            go_left = False
            if not np.isnan(fval):
                cat = int(fval)
                bits = self.cat_bitset_real[node]
                if 0 <= cat < len(bits) * 32:
                    go_left = bool((bits[cat // 32] >> (cat % 32)) & 1)
        else:
            mt = self.missing_type[node]
            if np.isnan(fval) and mt != MISSING_NAN_C:
                fval = 0.0
            if (mt == MISSING_NAN_C and np.isnan(fval)) or \
               (mt == MISSING_ZERO_C and abs(fval) <= 1e-35):
                go_left = self.default_left[node]
            else:
                go_left = fval <= self.threshold_real[node]
        return self.left_child[node] if go_left else self.right_child[node]


def rebind_to_dataset(tree: Tree, ds) -> None:
    """Fill a loaded tree's bin-space fields from a dataset's mappers (the
    JAX package's ``rebind_to_dataset``, ``models/tree.py:185-263``).

    A loaded model carries only raw-space decisions (real thresholds, raw
    category bitsets). Continued training replays its trees over the
    binned matrix, which needs ``split_feature_inner`` / ``threshold_bin``
    / the bin-space ``cat_bitset`` of THIS dataset's binning. A feature
    that is trivial (constant) in the dataset has no binned column: its
    nodes are folded to route every row the way the constant goes."""
    from ..data.binning import (BIN_CATEGORICAL, MISSING_NAN, MISSING_NONE,
                                MISSING_ZERO)
    from ..utils import log
    mt_code = {MISSING_NONE: MISSING_NONE_C, MISSING_ZERO: MISSING_ZERO_C,
               MISSING_NAN: MISSING_NAN_C}
    inner_of = {j: k for k, j in enumerate(ds.used_features)}
    n = tree.num_internal
    tree.split_feature_inner = list(tree.split_feature)
    tree.threshold_bin = [0] * n
    for i in range(n):
        f = tree.split_feature[i]
        if f >= len(ds.mappers):
            log.fatal("Model uses feature %d but dataset has only %d features",
                      f, len(ds.mappers))
        m = ds.mappers[f]
        if f not in inner_of:
            # constant feature in this data: fold the decision
            tree.split_feature_inner[i] = 0
            if tree.is_categorical[i]:
                cat = int(m.min_val) if not np.isnan(m.min_val) else -1
                bits = tree.cat_bitset_real[i]
                go_left = (0 <= cat < len(bits) * 32
                           and bool((bits[cat // 32] >> (cat % 32)) & 1))
                tree.cat_bitset[i] = (np.full(8, 0xFFFFFFFF, np.uint32)
                                      if go_left else np.zeros(8, np.uint32))
            else:
                v = m.min_val
                mt = tree.missing_type[i]
                if (mt == MISSING_NAN_C and np.isnan(v)) or \
                   (mt == MISSING_ZERO_C and abs(v) <= 1e-35):
                    go_left = tree.default_left[i]
                else:
                    go_left = ((0.0 if np.isnan(v) else v)
                               <= tree.threshold_real[i])
                tree.threshold_bin[i] = (_FORCE_LEFT_BIN if go_left
                                         else _FORCE_RIGHT_BIN)
                tree.default_left[i] = bool(go_left)
            continue
        tree.split_feature_inner[i] = inner_of[f]
        ds_mt = mt_code[m.missing_type]
        if tree.is_categorical[i]:
            if m.bin_type != BIN_CATEGORICAL:
                log.fatal("Model splits categorically on feature %d but the "
                          "dataset binned it as numerical", f)
            bits = np.zeros(8, dtype=np.uint32)
            real = np.asarray(tree.cat_bitset_real[i], dtype=np.uint32)
            width = len(real) * 32
            for cat, b in m.categorical_2_bin.items():
                if 0 <= cat < width and (real[cat // 32] >> (cat % 32)) & 1:
                    if b < 256:
                        bits[b // 32] |= np.uint32(1 << (b % 32))
                    else:
                        log.warning("Categorical bin %d of feature %d exceeds "
                                    "the 256-bin bitset; dropped in replay",
                                    b, f)
            tree.cat_bitset[i] = bits
        else:
            tree.threshold_bin[i] = int(
                m.values_to_bins(np.asarray([tree.threshold_real[i]]))[0])
            # the binned traversal takes the NaN bin from the dataset, so a
            # node whose stored missing type disagrees is adjusted to route
            # NaN rows as the raw-space decision would
            mt = tree.missing_type[i]
            if mt == MISSING_NONE_C and ds_mt == MISSING_NAN_C:
                # a raw decision turns NaN into 0.0 under MissingType::None
                tree.missing_type[i] = MISSING_NAN_C
                tree.default_left[i] = bool(0.0 <= tree.threshold_real[i])
            elif mt == MISSING_NAN_C and ds_mt != MISSING_NAN_C:
                log.debug("Feature %d: model expects NaN missing but dataset "
                          "has none; NaN handling folded away", f)
                tree.missing_type[i] = MISSING_NONE_C
