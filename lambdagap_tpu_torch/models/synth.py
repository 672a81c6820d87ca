"""Seeded synthetic forests and rows for checks and measurements.

Random trees grown with :meth:`Tree.split` — each split takes a random
leaf, a random feature and a threshold from that feature's boundary grid
(what ``max_bin`` binning yields), with some nodes NaN-missing and some
zero-missing — and rows with NaN and zero values mixed in. Deterministic in
the seed (numpy ``RandomState``), so the CUDA kernel tests and
``chip_smoke.py`` check the same forests everywhere without a trained
model.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from .tree import Tree

# raw values the categorical decision must route like the JAX package:
# out-of-int32 magnitudes (saturating casts), negatives that truncate to
# -3 / 0, fractional in-range values, NaN and a category past the bitset
HOSTILE_CATEGORIES = np.array(
    [1e10, -1e10, -3.5, 70.9, np.nan, 69.0, 69.5, 0.0, -0.5, 31.0, 32.0,
     64.0, 3e9], np.float32)


def random_trees(seed: int, num_trees: int, num_leaves: int,
                 num_features: int, grid_size: int = 254) -> List[Tree]:
    """``num_trees`` trees of ``num_leaves`` leaves each over
    ``num_features`` numerical features, thresholds from a per-feature
    grid of ``grid_size`` sorted f32 boundaries; 10% of the nodes are
    NaN-missing and 10% zero-missing, leaf values ~ N(0, 0.02)."""
    rng = np.random.RandomState(seed)
    grid = np.sort(rng.uniform(-3.0, 3.0, (num_features, grid_size))
                   .astype(np.float32), axis=1)
    out = []
    for _ in range(num_trees):
        tree = Tree(max_leaves=num_leaves)
        for _s in range(num_leaves - 1):
            leaf = int(rng.randint(tree.num_leaves))
            f = int(rng.randint(num_features))
            u = rng.rand()
            mt = 2 if u < 0.1 else (1 if u < 0.2 else 0)
            tree.split(leaf, f, f, 0, float(grid[f, rng.randint(grid_size)]),
                       bool(rng.rand() < 0.5), mt, float(rng.rand()),
                       float(rng.normal(0, 0.02)),
                       float(rng.normal(0, 0.02)), 1.0, 1.0, 1, 1)
        out.append(tree)
    return out


def categorical_trees(seed: int, num_trees: int = 20, num_leaves: int = 31,
                      num_features: int = 6,
                      num_categories: int = 70) -> List[Tree]:
    """Trees whose feature 0 splits categorically over ``num_categories``
    categories (multi-word bitsets) and whose other features split
    numerically with every missing type."""
    rng = np.random.RandomState(seed)
    words = (num_categories + 31) // 32
    top = num_categories - 32 * (words - 1)
    out = []
    for _ in range(num_trees):
        tree = Tree(max_leaves=num_leaves)
        for _s in range(num_leaves - 1):
            leaf = int(rng.randint(tree.num_leaves))
            lv, rv = rng.normal(0, 0.1, 2)
            if rng.rand() < 0.5:
                bits = rng.randint(0, 2 ** 32, size=words,
                                   dtype=np.uint64).astype(np.uint32)
                bits[-1] &= np.uint32((1 << top) - 1)
                tree.split(leaf, 0, 0, 0, 0.0, False, 0, 1.0, float(lv),
                           float(rv), 1.0, 1.0, 1, 1, is_categorical=True,
                           cat_bitset_real=bits)
            else:
                f = int(rng.randint(1, num_features))
                tree.split(leaf, f, f, 0, float(np.float32(rng.randn())),
                           bool(rng.rand() < 0.5), int(rng.randint(3)), 1.0,
                           float(lv), float(rv), 1.0, 1.0, 1, 1)
        out.append(tree)
    return out


def linearize(trees: List[Tree], seed: int) -> List[Tree]:
    """Give ``trees`` linear leaf payloads in place (and return them): each
    leaf's distinct numeric path features, sorted, with coefficients ~
    N(0, 0.01) and ``leaf_const`` = ``leaf_value`` + N(0, 0.01); every
    7th leaf keeps no features (its constant alone)."""
    from .linear_leaf import leaf_path_features
    rng = np.random.RandomState(seed)
    for tree in trees:
        L = tree.num_leaves
        numeric = np.ones(max(tree.split_feature, default=0) + 1, bool)
        tbl = leaf_path_features(tree, numeric, L, numeric.size)
        feats = [[int(f) for f in row if f >= 0] for row in tbl[:L]]
        tree.is_linear = True
        tree.leaf_features = [[] if leaf % 7 == 6 else f
                              for leaf, f in enumerate(feats)]
        tree.leaf_coeff = [rng.normal(0, 0.01, len(f))
                           for f in tree.leaf_features]
        tree.leaf_const = (np.asarray(tree.leaf_value[:L], np.float64)
                           + rng.normal(0, 0.01, L))
    return trees


def header(num_features: int,
           objective: str = "binary sigmoid:1") -> Dict[str, str]:
    """A model-text header dict for ``convert.booster_from_numpy``."""
    return {"objective": objective,
            "max_feature_idx": str(num_features - 1),
            "feature_names": " ".join(f"Column_{i}"
                                      for i in range(num_features)),
            "feature_infos": " ".join(["[-3:3]"] * num_features)}


def random_rows(rng: np.random.RandomState, n: int,
                num_features: int) -> np.ndarray:
    """f32 rows with NaN and zero values mixed in: 5% NaN cells, 5% zero
    cells, every 11th row all NaN, every 13th (from 5) all zero."""
    x = rng.randn(n, num_features).astype(np.float32)
    x[rng.rand(n, num_features) < 0.05] = np.nan
    x[rng.rand(n, num_features) < 0.05] = 0.0
    x[::11] = np.nan
    x[5::13] = 0.0
    return x


def hostile_rows(rng: np.random.RandomState, n: int,
                 num_features: int) -> np.ndarray:
    """:func:`random_rows` whose column 0 holds valid categories 0..69 and
    :data:`HOSTILE_CATEGORIES` half and half."""
    x = random_rows(rng, n, num_features)
    x[:, 0] = np.where(
        rng.rand(n) < 0.5,
        HOSTILE_CATEGORIES[rng.randint(len(HOSTILE_CATEGORIES), size=n)],
        rng.randint(0, 70, size=n).astype(np.float32))
    return x
