"""Carry a model, or a binned dataset, across from numpy arrays.

A forest is the model's weights. The LightGBM v4 text format is the shared
format (``Booster(model_str=...)``); this module is the second route: the
fields of each tree as numpy arrays — what any tree object exposes, the
JAX package's ``Tree`` included — become the port's :class:`Tree`\\s, and
:func:`booster_from_numpy` assembles a port :class:`Booster` from them and
a model-text header dict. Both routes give the same booster: the same tree
fields, the same text, the same predictions.

Training state comes across the same way: :func:`dataset_fields` reads a
binned dataset's mappers, binned matrix, labels, query boundaries and
positions as numpy, and
:func:`dataset_from_numpy` builds the port's :class:`BinnedDataset` from
them.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np

from .basic import Booster
from .config import Config
from .data.binning import BinMapper
from .data.dataset import BinnedDataset
from .models.gbdt import GBDT
from .models.tree import Tree

# per internal node (length num_leaves - 1)
NODE_FIELDS = ("split_feature", "threshold_real", "default_left",
               "missing_type", "left_child", "right_child", "is_categorical",
               "split_gain", "internal_value", "internal_weight",
               "internal_count")
# per leaf (length num_leaves)
LEAF_FIELDS = ("leaf_value", "leaf_weight", "leaf_count")
# bin-space fields, optional (a tree loaded from text carries none of its
# own: split_feature_inner = split_feature, threshold_bin = 0, empty
# bin-space bitsets)
BIN_FIELDS = ("split_feature_inner", "threshold_bin")

_INT = ("split_feature", "missing_type", "left_child", "right_child",
        "internal_count", "split_feature_inner", "threshold_bin")
_BOOL = ("default_left", "is_categorical")


def tree_fields(tree) -> Dict[str, Any]:
    """The fields :func:`trees_from_numpy` reads, as numpy arrays, from any
    tree object with the reference tree's attribute names."""
    n = tree.num_internal
    L = tree.num_leaves
    out: Dict[str, Any] = {"num_leaves": int(L),
                           "shrinkage": float(tree.shrinkage)}
    for k in NODE_FIELDS + BIN_FIELDS:
        out[k] = np.asarray(getattr(tree, k)[:n])
    for k in LEAF_FIELDS:
        out[k] = np.asarray(getattr(tree, k)[:L])
    out["cat_bitset_real"] = [np.asarray(b, np.uint32)
                              for b in tree.cat_bitset_real[:n]]
    out["cat_bitset"] = [np.asarray(b, np.uint32)
                         for b in tree.cat_bitset[:n]]
    if getattr(tree, "is_linear", False):
        out["leaf_const"] = np.asarray(tree.leaf_const[:L])
        out["leaf_features"] = [list(map(int, f))
                                for f in tree.leaf_features[:L]]
        out["leaf_coeff"] = [np.asarray(c, np.float64)
                             for c in tree.leaf_coeff[:L]]
    return out


def _tree_from_fields(f: Mapping[str, Any]) -> Tree:
    L = int(f["num_leaves"])
    n = L - 1
    tree = Tree(max_leaves=max(L, 1))
    tree.num_leaves = L
    tree.shrinkage = float(f.get("shrinkage", 1.0))
    for k in NODE_FIELDS:
        vals = np.asarray(f[k]).reshape(-1)[:n]
        if k in _INT:
            setattr(tree, k, [int(v) for v in vals])
        elif k in _BOOL:
            setattr(tree, k, [bool(v) for v in vals])
        else:
            setattr(tree, k, [float(v) for v in vals])
    # a categorical node's threshold is its bitset: the text holds no real
    # threshold for it, and the parser sets 0.0
    tree.threshold_real = [0.0 if c else t for t, c in
                           zip(tree.threshold_real, tree.is_categorical)]
    tree.split_feature_inner = (
        [int(v) for v in np.asarray(f["split_feature_inner"])[:n]]
        if "split_feature_inner" in f else list(tree.split_feature))
    tree.threshold_bin = ([int(v) for v in np.asarray(f["threshold_bin"])[:n]]
                          if "threshold_bin" in f else [0] * n)
    real = f["cat_bitset_real"]
    tree.cat_bitset_real = []
    for i in range(n):
        src = np.asarray(real[i], np.uint32).reshape(-1)
        bits = np.zeros(max(8, len(src)), np.uint32)
        bits[:len(src)] = src
        tree.cat_bitset_real.append(bits)
    binned = f.get("cat_bitset")
    tree.cat_bitset = [
        np.asarray(binned[i], np.uint32).copy() if binned is not None
        else np.zeros(8, np.uint32) for i in range(n)]
    for k in LEAF_FIELDS:
        getattr(tree, k)[:L] = np.asarray(f[k])[:L]
    if "leaf_features" in f:
        tree.is_linear = True
        tree.leaf_const = np.asarray(f["leaf_const"], np.float64)[:L].copy()
        tree.leaf_features = [list(map(int, v)) for v in f["leaf_features"]]
        tree.leaf_coeff = [np.asarray(c, np.float64) for c in f["leaf_coeff"]]
    # leaf depths/parents from the children arrays, as the text parser does
    tree.leaf_parent[:] = -1
    depth = np.zeros(max(n, 1), dtype=np.int32)
    for i in range(n):
        for child in (tree.left_child[i], tree.right_child[i]):
            if child >= 0:
                depth[child] = depth[i] + 1
            else:
                tree.leaf_parent[~child] = i
                tree.leaf_depth[~child] = depth[i] + 1
    return tree


def trees_from_numpy(fields: Sequence[Mapping[str, Any]]) -> List[Tree]:
    """Port :class:`Tree`\\s from per-tree dicts of numpy arrays
    (:func:`tree_fields`): ``split_feature``, ``threshold_real``,
    ``default_left``, ``missing_type``, ``left_child``, ``right_child``,
    ``is_categorical``, ``cat_bitset_real``, ``leaf_value``,
    ``num_leaves`` and the other fields the model text holds
    (``split_gain``, ``internal_*``, ``leaf_weight``, ``leaf_count``,
    ``shrinkage``), plus the optional bin-space fields."""
    return [_tree_from_fields(f) for f in fields]


MAPPER_FIELDS = ("bin_type", "missing_type", "bin_upper_bound",
                 "bin_2_categorical", "categorical_2_bin", "num_bin",
                 "default_bin", "most_freq_bin", "min_val", "max_val",
                 "is_trivial")


def dataset_fields(ds) -> Dict[str, Any]:
    """The fields :func:`dataset_from_numpy` reads, as numpy arrays and
    plain values, from any binned dataset with the reference dataset's
    attribute names (the JAX package's ``BinnedDataset`` included)."""
    md = ds.metadata
    return {
        "binned": np.asarray(ds.binned),
        "mappers": [{k: getattr(m, k) for k in MAPPER_FIELDS}
                    for m in ds.mappers],
        "used_features": [int(j) for j in ds.used_features],
        "feature_names": list(ds.feature_names),
        "max_bin": int(ds.max_bin),
        "label": None if md.label is None else np.asarray(md.label),
        "weight": None if md.weight is None else np.asarray(md.weight),
        "init_score": (None if md.init_score is None
                       else np.asarray(md.init_score)),
        "query_boundaries": (None if md.query_boundaries is None
                             else np.asarray(md.query_boundaries)),
        "position": None if md.position is None else np.asarray(md.position),
    }


def dataset_from_numpy(fields: Mapping[str, Any]) -> BinnedDataset:
    """A port :class:`BinnedDataset` from :func:`dataset_fields`: the same
    mappers (boundaries, missing types, default bins, categorical maps),
    the same binned matrix, labels, query boundaries and positions — so a
    learner can be held to another implementation on an identical binned
    matrix."""
    ds = BinnedDataset()
    ds.binned = np.ascontiguousarray(fields["binned"])
    ds.num_data, ds.num_total_features = (ds.binned.shape[0],
                                          len(fields["mappers"]))
    ds.mappers = []
    for mf in fields["mappers"]:
        m = BinMapper()
        for k in MAPPER_FIELDS:
            v = mf[k]
            setattr(m, k, list(v) if isinstance(v, (list, tuple, np.ndarray))
                    else dict(v) if isinstance(v, dict) else v)
        ds.mappers.append(m)
    ds.used_features = [int(j) for j in fields["used_features"]]
    ds.feature_num_bins = [ds.mappers[j].num_bin for j in ds.used_features]
    ds.bin_offsets = [int(v) for v in np.concatenate(
        [[0], np.cumsum(ds.feature_num_bins)[:-1]])]
    ds.feature_names = list(fields["feature_names"])
    ds.max_bin = int(fields["max_bin"])
    md = ds.metadata
    for k, dt in (("label", np.float32), ("weight", np.float32),
                  ("init_score", np.float64), ("query_boundaries", np.int32),
                  ("position", np.int32)):
        if fields.get(k) is not None:
            setattr(md, k, np.asarray(fields[k], dt).reshape(-1))
    md.check(ds.num_data)
    return ds


def booster_from_numpy(header: Mapping[str, str], trees: Sequence[Tree],
                       params: Optional[Dict[str, Any]] = None) -> Booster:
    """A port :class:`Booster` over ``trees`` with a model-text header dict
    (``objective``, ``num_class``, ``max_feature_idx``, ``feature_names``,
    ``feature_infos``, optional ``average_output``) — the same booster
    ``Booster(model_str=...)`` builds from the equivalent text."""
    gbdt = GBDT.from_trees(dict(header), list(trees),
                           Config.from_params(params or {}))
    return Booster._from_gbdt(gbdt, params)
