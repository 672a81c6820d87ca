"""Text model serialization, compatible with the reference's format.

(reference: src/boosting/gbdt_model_text.cpp:311 SaveModelToString with
per-tree ``Tree=N`` blocks from Tree::ToString (src/io/tree.cpp:339),
LoadModelFromString; decision_type bit encoding from
include/LightGBM/tree.h:20-21,274-281.)

A copy of ``lambdagap_tpu/models/model_text.py``, the JSON dump
(:func:`dump_model`) included (the port imports nothing of the JAX
package). The tree region this module
writes must be byte-identical to the JAX package's: the compiled artifact's
``source_key`` hashes it (``infer/compile.py``). A model saved here loads
in the reference's LightGBM and vice versa for the shared feature set
(numerical+categorical splits, missing handling).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..utils import log
from .tree import Tree

K_CATEGORICAL_MASK = 1
K_DEFAULT_LEFT_MASK = 2
MODEL_VERSION = "v4"


def _fmt(v: float) -> str:
    """Round-trip float formatting (reference uses %.17g via
    ArrayToString<true>; repr() is the shortest round-trip equivalent)."""
    return repr(float(v))


def _arr_str(vals, fmt=str) -> str:
    return " ".join(fmt(v) for v in vals)


def _decision_type(tree: Tree, i: int) -> int:
    dt = 0
    if tree.is_categorical[i]:
        dt |= K_CATEGORICAL_MASK
    if tree.default_left[i]:
        dt |= K_DEFAULT_LEFT_MASK
    dt |= (tree.missing_type[i] & 3) << 2
    return dt


def tree_to_string(tree: Tree) -> str:
    n = tree.num_internal
    L = tree.num_leaves
    lines = [f"num_leaves={L}"]

    # categorical bookkeeping: threshold of a categorical node indexes into
    # cat_boundaries/cat_threshold (reference: tree.cpp ToString num_cat path)
    cat_nodes = [i for i in range(n) if tree.is_categorical[i]]
    num_cat = len(cat_nodes)
    lines.append(f"num_cat={num_cat}")

    thresholds: List[float] = []
    cat_boundaries = [0]
    cat_threshold: List[int] = []
    cat_idx = 0
    for i in range(n):
        if tree.is_categorical[i]:
            bits = np.trim_zeros(np.asarray(tree.cat_bitset_real[i], dtype=np.uint32),
                                 "b")
            if len(bits) == 0:
                bits = np.zeros(1, dtype=np.uint32)
            cat_threshold.extend(int(b) for b in bits)
            cat_boundaries.append(len(cat_threshold))
            thresholds.append(float(cat_idx))
            cat_idx += 1
        else:
            thresholds.append(tree.threshold_real[i])

    if n > 0:
        lines.append("split_feature=" + _arr_str(tree.split_feature[:n]))
        lines.append("split_gain=" + _arr_str(tree.split_gain[:n], _fmt))
        lines.append("threshold=" + _arr_str(thresholds, _fmt))
        lines.append("decision_type="
                     + _arr_str([_decision_type(tree, i) for i in range(n)]))
        lines.append("left_child=" + _arr_str(tree.left_child[:n]))
        lines.append("right_child=" + _arr_str(tree.right_child[:n]))
    else:
        for k in ("split_feature", "split_gain", "threshold", "decision_type",
                  "left_child", "right_child"):
            lines.append(f"{k}=")
    lines.append("leaf_value=" + _arr_str(tree.leaf_value[:L], _fmt))
    lines.append("leaf_weight=" + _arr_str(tree.leaf_weight[:L], _fmt))
    lines.append("leaf_count=" + _arr_str(int(c) for c in tree.leaf_count[:L]))
    if n > 0:
        lines.append("internal_value=" + _arr_str(tree.internal_value, _fmt))
        lines.append("internal_weight=" + _arr_str(tree.internal_weight, _fmt))
        lines.append("internal_count=" + _arr_str(tree.internal_count))
    else:
        lines.extend(["internal_value=", "internal_weight=", "internal_count="])
    if num_cat > 0:
        lines.append("cat_boundaries=" + _arr_str(cat_boundaries))
        lines.append("cat_threshold=" + _arr_str(cat_threshold))
    if getattr(tree, "is_linear", False):
        # (reference: tree.cpp ToString linear-tree block)
        lines.append("is_linear=1")
        lines.append("leaf_const=" + _arr_str(tree.leaf_const[:L], _fmt))
        nfs = [len(tree.leaf_features[i]) for i in range(L)]
        lines.append("num_features=" + _arr_str(nfs))
        flat_f = [f for i in range(L) for f in tree.leaf_features[i]]
        flat_c = [c for i in range(L) for c in tree.leaf_coeff[i]]
        lines.append("leaf_features=" + _arr_str(flat_f))
        lines.append("leaf_coeff=" + _arr_str(flat_c, _fmt))
    else:
        lines.append("is_linear=0")
    lines.append("shrinkage=" + _fmt(tree.shrinkage))
    return "\n".join(lines) + "\n"


def save_model_to_string(booster, start_iteration: int = 0,
                         num_iteration: int = -1,
                         importance_type: int = 0) -> str:
    """(reference: gbdt_model_text.cpp:311 SaveModelToString)"""
    cfg = booster.config
    sub_model = "tree"
    num_class = booster.num_class if booster.num_class > 1 else 1
    K = booster.num_tree_per_iteration
    feature_names = list(booster.feature_names)
    max_feature_idx = len(feature_names) - 1

    total_iters = len(booster.models) // max(K, 1)
    start_iteration = max(0, min(start_iteration, total_iters))
    num_used = len(booster.models)
    if num_iteration > 0:
        num_used = min((start_iteration + num_iteration) * K, num_used)
    start_model = start_iteration * K

    out = [sub_model,
           f"version={MODEL_VERSION}",
           f"num_class={num_class}",
           f"num_tree_per_iteration={K}",
           "label_index=0",
           f"max_feature_idx={max_feature_idx}",
           f"objective={booster.objective_string()}"]
    if getattr(booster, "average_output", False):
        out.append("average_output")
    out.append("feature_names=" + " ".join(feature_names))
    out.append("feature_infos=" + " ".join(booster.feature_infos()))

    models = booster.host_models
    tree_strs = []
    for idx, i in enumerate(range(start_model, num_used)):
        tree_strs.append(f"Tree={idx}\n" + tree_to_string(models[i]) + "\n")
    out.append("tree_sizes=" + " ".join(str(len(s)) for s in tree_strs))
    body = "\n".join(out) + "\n\n" + "".join(tree_strs) + "end of trees\n"

    imp = feature_importance(booster, importance_type)
    pairs = [(int(v), feature_names[i]) for i, v in enumerate(imp) if v > 0]
    pairs.sort(key=lambda p: -p[0])
    body += "\nfeature_importances:\n"
    for v, name in pairs:
        body += f"{name}={v}\n"
    body += "\nparameters:\n"
    for key, val in sorted(cfg.to_dict().items()):
        if isinstance(val, list):
            val = ",".join(str(x) for x in val)
        body += f"[{key}: {val}]\n"
    body += "end of parameters\n"
    return body


def feature_importance(booster, importance_type: int = 0,
                       start: int = 0, end: int = -1) -> np.ndarray:
    """0 = split counts, 1 = total gains, over trees [start, end)
    (reference: GBDT::FeatureImportance, gbdt.cpp)."""
    n = len(booster.feature_names)
    imp = np.zeros(n, dtype=np.float64)
    models = booster.host_models
    if end < 0:
        end = len(models)
    for tree in models[start:end]:
        for i in range(tree.num_internal):
            f = tree.split_feature[i]
            if importance_type == 0:
                imp[f] += 1
            else:
                imp[f] += tree.split_gain[i]
    return imp


# ---------------------------------------------------------------------------
# loading
# ---------------------------------------------------------------------------

def _parse_kv_block(text: str) -> Dict[str, str]:
    out = {}
    for line in text.splitlines():
        line = line.strip()
        if "=" in line:
            k, v = line.split("=", 1)
            out[k] = v
    return out


def tree_from_string(block: str) -> Tree:
    kv = _parse_kv_block(block)
    L = int(kv["num_leaves"])
    num_cat = int(kv.get("num_cat", "0"))
    tree = Tree(max_leaves=max(L, 1))
    tree.num_leaves = L
    tree.shrinkage = float(kv.get("shrinkage", "1"))

    def ints(key):
        s = kv.get(key, "")
        return [int(float(x)) for x in s.split()] if s.strip() else []

    def floats(key):
        s = kv.get(key, "")
        return [float(x) for x in s.split()] if s.strip() else []

    n = L - 1
    tree.split_feature = ints("split_feature")
    tree.split_feature_inner = list(tree.split_feature)
    tree.split_gain = floats("split_gain")
    thresholds = floats("threshold")
    dts = ints("decision_type")
    tree.left_child = ints("left_child")
    tree.right_child = ints("right_child")
    leaf_value = floats("leaf_value")
    tree.leaf_value[:L] = leaf_value[:L]
    lw = floats("leaf_weight")
    if lw:
        tree.leaf_weight[:L] = lw[:L]
    lc = ints("leaf_count")
    if lc:
        tree.leaf_count[:L] = lc[:L]
    tree.internal_value = floats("internal_value")
    tree.internal_weight = floats("internal_weight")
    tree.internal_count = ints("internal_count")
    cat_boundaries = ints("cat_boundaries")
    cat_threshold = [np.uint32(x) for x in ints("cat_threshold")]

    tree.threshold_real = []
    tree.threshold_bin = [0] * n
    tree.is_categorical = []
    tree.default_left = []
    tree.missing_type = []
    tree.cat_bitset = []
    tree.cat_bitset_real = []
    for i in range(n):
        dt = dts[i] if i < len(dts) else 0
        is_cat = bool(dt & K_CATEGORICAL_MASK)
        tree.is_categorical.append(is_cat)
        tree.default_left.append(bool(dt & K_DEFAULT_LEFT_MASK))
        tree.missing_type.append((dt >> 2) & 3)
        if is_cat and cat_boundaries:
            ci = int(thresholds[i])
            lo, hi = cat_boundaries[ci], cat_boundaries[ci + 1]
            # keep the full variable-length segment: reference bitsets can
            # span arbitrarily many words (tree.cpp cat_threshold_)
            seg = cat_threshold[lo:hi]
            bits = np.zeros(max(8, len(seg)), dtype=np.uint32)
            bits[:len(seg)] = seg
            tree.cat_bitset_real.append(bits)
            tree.cat_bitset.append(np.zeros(8, dtype=np.uint32))
            tree.threshold_real.append(0.0)
        else:
            tree.cat_bitset_real.append(np.zeros(8, dtype=np.uint32))
            tree.cat_bitset.append(np.zeros(8, dtype=np.uint32))
            tree.threshold_real.append(thresholds[i] if i < len(thresholds) else 0.0)

    if kv.get("is_linear", "0").strip() == "1":
        tree.is_linear = True
        tree.leaf_const = np.asarray(floats("leaf_const"), np.float64)
        nfs = ints("num_features")
        flat_f = ints("leaf_features")
        flat_c = floats("leaf_coeff")
        tree.leaf_features = []
        tree.leaf_coeff = []
        off = 0
        for cnt in nfs:
            tree.leaf_features.append(flat_f[off:off + cnt])
            tree.leaf_coeff.append(np.asarray(flat_c[off:off + cnt],
                                              np.float64))
            off += cnt

    # recompute leaf depths/parents from children arrays
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


def read_model_source(source) -> str:
    """Model text from a filesystem path OR an already-in-memory model
    string (the serve hot-swap path accepts either). A multi-line string is
    always treated as model text; a single-line string must name a readable
    file."""
    import os
    s = str(source)
    if "\n" in s:
        return s
    if os.path.exists(s):
        with open(s) as f:
            return f.read()
    log.fatal("model source %r is neither a readable file nor model text", s)


def load_model_from_string(text: str):
    """Parse a saved model into (header dict, [Tree])."""
    if "end of trees" not in text:
        log.fatal("Model format error: missing 'end of trees'")
    head_and_trees = text.split("end of trees")[0]
    parts = head_and_trees.split("Tree=")
    header = _parse_kv_block(parts[0])
    if any(line.strip() == "average_output" for line in parts[0].splitlines()):
        header["average_output"] = "1"
    trees = []
    for blk in parts[1:]:
        body = blk.split("\n", 1)[1] if "\n" in blk else ""
        trees.append(tree_from_string(body))
    return header, trees


# ---------------------------------------------------------------------------
# JSON dump (reference: gbdt_model_text.cpp DumpModel + tree.cpp Tree::ToJSON)
# ---------------------------------------------------------------------------

_MT_NAMES = {0: "None", 1: "Zero", 2: "NaN"}


def _node_to_dict(tree: Tree, node: int) -> Dict:
    if node < 0:
        leaf = ~node
        return {
            "leaf_index": leaf,
            "leaf_value": float(tree.leaf_value[leaf]),
            "leaf_weight": float(tree.leaf_weight[leaf]),
            "leaf_count": int(tree.leaf_count[leaf]),
        }
    if tree.is_categorical[node]:
        bits = np.asarray(tree.cat_bitset_real[node], dtype=np.uint32)
        cats = [str(32 * w + b) for w in range(len(bits))
                for b in range(32) if (bits[w] >> b) & 1]
        threshold = "||".join(cats)
        decision_type = "=="
    else:
        threshold = tree.threshold_real[node]
        decision_type = "<="
    return {
        "split_index": node,
        "split_feature": tree.split_feature[node],
        "split_gain": float(tree.split_gain[node]),
        "threshold": threshold,
        "decision_type": decision_type,
        "default_left": bool(tree.default_left[node]),
        "missing_type": _MT_NAMES.get(tree.missing_type[node], "None"),
        "internal_value": float(tree.internal_value[node]),
        "internal_weight": float(tree.internal_weight[node]),
        "internal_count": int(tree.internal_count[node]),
        "left_child": _node_to_dict(tree, tree.left_child[node]),
        "right_child": _node_to_dict(tree, tree.right_child[node]),
    }


def dump_model(booster, start_iteration: int = 0,
               num_iteration: int = -1) -> Dict:
    """Model as a JSON-serializable dict
    (reference: GBDT::DumpModel, src/boosting/gbdt_model_text.cpp;
    Python Booster.dump_model)."""
    K = booster.num_tree_per_iteration
    feature_names = list(booster.feature_names)
    total_iters = len(booster.models) // max(K, 1)
    start_iteration = max(0, min(start_iteration, total_iters))
    num_used = len(booster.models)
    if num_iteration > 0:
        num_used = min((start_iteration + num_iteration) * K, num_used)
    trees = []
    models = booster.host_models
    for i in range(start_iteration * K, num_used):
        t = models[i]
        trees.append({
            "tree_index": i - start_iteration * K,
            "num_leaves": t.num_leaves,
            "num_cat": sum(t.is_categorical[:t.num_internal]),
            "shrinkage": float(t.shrinkage),
            "tree_structure": _node_to_dict(
                t, 0 if t.num_internal > 0 else ~0),
        })
    imp = feature_importance(booster, start=start_iteration * K, end=num_used)
    return {
        "name": "tree",
        "version": MODEL_VERSION,
        "num_class": booster.num_class if booster.num_class > 1 else 1,
        "num_tree_per_iteration": K,
        "label_index": 0,
        "max_feature_idx": len(feature_names) - 1,
        "objective": booster.objective_string(),
        "average_output": bool(getattr(booster, "average_output", False)),
        "feature_names": feature_names,
        "feature_infos": booster.feature_infos(),
        "tree_info": trees,
        "feature_importances": {
            feature_names[i]: int(v) for i, v in enumerate(imp) if v > 0},
    }
