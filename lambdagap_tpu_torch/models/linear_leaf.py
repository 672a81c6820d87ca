"""Piece-wise linear leaves: the per-tree fit.

The port of ``lambdagap_tpu/models/linear_leaf.py`` (arXiv:1802.05640;
reference: linear_tree_learner.cpp CalculateLinear): path features from the
host tree skeleton, one moment pass over the raw matrix on the device and
one float64 solve per tree (``ops/linear.py``), and the constant-leaf
fallback. Both learners land here through ``GBDT._fit_linear_tree`` with
their row -> leaf map, so a tree's coefficients do not depend on which
learner grew it.
"""
from __future__ import annotations

import numpy as np
import torch

from ..data.binning import BIN_CATEGORICAL
from ..ops.linear import (accumulate_leaf_moments, leaf_feature_width,
                          solve_linear_leaves)
from ..utils import log
from .tree import Tree


def numeric_feature_mask(ds) -> np.ndarray:
    """True for features a linear leaf may use (numeric, non-categorical;
    reference: CalculateLinear skips categorical splits on the path)."""
    numeric = np.ones(ds.num_total_features, dtype=bool)
    for j, m in enumerate(ds.mappers):
        if m.bin_type == BIN_CATEGORICAL:
            numeric[j] = False
    return numeric


def leaf_path_features(tree: Tree, numeric_mask: np.ndarray,
                       num_leaves_pad: int, width: int) -> np.ndarray:
    """[L_pad+1, FL] int32 table of each leaf's sorted numeric path
    features, ``-1`` on padding slots; row L_pad is the all-padding dump
    row."""
    tbl = np.full((num_leaves_pad + 1, width), -1, np.int32)
    if tree.num_internal == 0:
        return tbl
    path_feats = [[] for _ in range(tree.num_leaves)]

    def walk(node, feats):
        if node < 0:
            path_feats[~node] = feats
            return
        f = tree.split_feature[node]
        nxt = feats if (tree.is_categorical[node]
                        or not numeric_mask[f]) else feats + [f]
        walk(tree.left_child[node], nxt)
        walk(tree.right_child[node], nxt)

    walk(0, [])
    for leaf in range(tree.num_leaves):
        feats = sorted(set(path_feats[leaf]))
        tbl[leaf, :len(feats)] = feats
    return tbl


def fit_linear_leaves_batched(tree: Tree, X: torch.Tensor,
                              leaf_idx: torch.Tensor, grad: torch.Tensor,
                              hess: torch.Tensor, linear_lambda: float,
                              numeric_mask: np.ndarray,
                              num_leaves_cap: int) -> None:
    """Fit every leaf's linear model: one moment pass, one solve.

    Mutates ``tree`` in place as the JAX package does: sets ``is_linear``
    and the per-leaf ``leaf_features`` / ``leaf_coeff`` / ``leaf_const``
    payload, leaving ineligible leaves (no numeric path features, too few
    non-NaN rows, a singular or non-finite system) on their constant
    output. ``num_leaves_cap`` (config num_leaves) fixes the moment
    stack's shape, as in the JAX package."""
    L = tree.num_leaves
    Lc = max(int(num_leaves_cap), L)
    FL = leaf_feature_width(int(numeric_mask.sum()), Lc)
    tbl = leaf_path_features(tree, numeric_mask, Lc, FL)
    nfeat = (tbl[:Lc] >= 0).sum(axis=1).astype(np.int64)

    tree.is_linear = True
    tree.leaf_features = [[] for _ in range(L)]
    tree.leaf_coeff = [np.zeros(0, np.float64) for _ in range(L)]
    tree.leaf_const = np.asarray(tree.leaf_value[:L], np.float64).copy()
    if not nfeat[:L].any():
        return
    XtHX, Xtg, cnt = (a.cpu().numpy() for a in accumulate_leaf_moments(
        X, leaf_idx, grad, hess, tbl, Lc))
    sol, ok = solve_linear_leaves(XtHX[:Lc], Xtg[:Lc], cnt[:Lc], nfeat,
                                  linear_lambda)
    for leaf in range(L):
        if not ok[leaf]:
            continue
        nf = int(nfeat[leaf])
        tree.leaf_features[leaf] = [int(f) for f in tbl[leaf, :nf]]
        tree.leaf_coeff[leaf] = sol[leaf, :nf].copy()
        tree.leaf_const[leaf] = float(sol[leaf, FL])


def resolve_linear_config(cfg) -> None:
    """Turn off, with the JAX package's warnings, what linear leaves do not
    combine with: quantized gradients (the solve needs full-precision
    gradients) and streamed residency (the fit reads the resident raw
    matrix); ``auto`` residency resolves to ``hbm``."""
    if not cfg.linear_tree:
        return
    if cfg.use_quantized_grad:
        log.warning("use_quantized_grad is not applied with linear_tree "
                    "(the leaf solve needs full-precision gradients); "
                    "training runs in full precision")
        cfg.use_quantized_grad = False
    if cfg.data_residency == "stream":
        log.warning("linear_tree does not support data_residency=stream "
                    "(the leaf solve reads the resident raw matrix); "
                    "falling back to hbm residency")
    cfg.data_residency = "hbm"
