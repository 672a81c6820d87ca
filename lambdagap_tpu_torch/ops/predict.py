"""Per-tree forest traversal: the scan oracle (``predict_engine=scan``).

The port of ``lambdagap_tpu/ops/predict.py``'s raw-row path. Trees are
stacked into padded arrays (:func:`forest_to_arrays`, host numpy, optionally
moved to a ``torch.device``) and traversed one tree at a time with plain
torch ops: every row advances one level per step for ``max_depth`` steps,
and the per-class scores accumulate tree by tree in forest order with one
f32 add per tree — the same additions, in the same order, as the JAX
package's ``lax.scan``. This engine is the independent oracle the compiled
engine (``infer/engine.py``) is held to, bit for bit.

Decision rules follow the reference (include/LightGBM/tree.h:130-141
NumericalDecision / CategoricalDecision): NaN converts to 0 unless the
node is NaN-missing, missing values follow ``default_left``, and a
categorical value goes left iff its bit is set in the node's bitset.

The binned traversal (:func:`predict_tree_binned`) scores a validation
set tree by tree during training. A whole forest is dispatched in bounded
blocks of ``tree_block`` trees (:func:`build_forest_blocks`, the JAX
package's layout: only the tail block pads, with all-zero no-op trees that
land on a zero leaf and add exactly +0.0 after every real tree), which the
tensor engine (``ops/predict_tensor.py``) consumes as its tiles.
:func:`predict_forest_leaf` gives the leaf index per (tree, row) for
``pred_leaf`` and ``refit``. Under ``has_linear`` a tree's value is the
linear leaf evaluation ``ops/linear.linear_leaf_values`` on raw rows (JAX
``ops/predict.py:265-275``): a constant tree carries ``leaf_const ==
leaf_value`` and empty slots, so a mixed forest evaluates uniformly.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

K_ZERO_THRESHOLD = 1e-35
MT_NONE, MT_ZERO, MT_NAN = 0, 1, 2
# trees per scan-engine block (the JAX package's
# LAMBDAGAP_PREDICT_TREE_BLOCK default)
DEFAULT_TREE_BLOCK = 64


class TreeArrays(NamedTuple):
    """One tree (or, stacked, a forest with a leading T axis) in padded
    array form. M = padded internal-node count. Fields hold numpy arrays,
    or torch tensors after :func:`to_device` (u32 bitsets widen to int64
    there: torch has no u32 shift on the CPU)."""
    split_feature: object      # i32 [M] — feature index (original or inner)
    threshold: object          # f32 [M] raw threshold (numerical)
    threshold_bin: object      # i32 [M] bin threshold (numerical, binned data)
    default_left: object       # bool [M]
    missing_type: object       # i32 [M]
    default_bin: object        # i32 [M] (binned decisions, Zero-missing)
    num_bin: object            # i32 [M] (binned decisions, NaN-missing)
    left_child: object         # i32 [M]
    right_child: object        # i32 [M]
    is_categorical: object     # bool [M]
    cat_bitset: object         # u32 [M, 8] bin-space bitset
    cat_bitset_real: object    # u32 [M, W] raw-category bitset (W >= 8)
    leaf_value: object         # f32 [L]
    leaf_const: object         # f32 [L] linear payload (== leaf_value for
    leaf_feat: object          # i32 [L, FL]  constant trees; -1 = empty)
    leaf_coeff: object         # f32 [L, FL]


def tree_to_arrays(tree, feature_meta=None, use_inner_feature: bool = False,
                   pad_nodes: int = 0, pad_leaves: int = 0,
                   pad_cat_words: int = 0, pad_leaf_feats: int = 0
                   ) -> TreeArrays:
    """Stack a host Tree into numpy TreeArrays (the JAX package's padding
    and fill values, field for field).

    feature_meta: per-feature ``default_bins`` / ``num_bins`` arrays for
    binned traversal (None for raw rows). pad_*: minimum padded sizes, used
    to align trees before stacking them into a forest."""
    n = max(tree.num_internal, 1)
    M = max(n, pad_nodes)

    def pad(vals, fill=0, dtype=np.int32):
        a = np.full(M, fill, dtype=dtype)
        a[:len(vals)] = vals
        return a

    feats = tree.split_feature_inner if use_inner_feature else tree.split_feature
    if tree.num_internal == 0:
        # degenerate single-leaf tree: both children point at leaf 0
        left = [~0]
        right = [~0]
        feats = [0]
    else:
        left = tree.left_child
        right = tree.right_child

    default_bin = np.zeros(M, dtype=np.int32)
    num_bin = np.zeros(M, dtype=np.int32)
    if feature_meta is not None:
        fi = np.asarray(tree.split_feature_inner[:tree.num_internal],
                        dtype=np.int64)
        if len(fi):
            default_bin[:len(fi)] = feature_meta["default_bins"][fi]
            num_bin[:len(fi)] = feature_meta["num_bins"][fi]

    W = max(8, pad_cat_words,
            max((len(tree.cat_bitset_real[i]) for i in range(tree.num_internal)),
                default=0))
    bits = np.zeros((M, 8), dtype=np.uint32)
    bits_real = np.zeros((M, W), dtype=np.uint32)
    for i in range(tree.num_internal):
        bb = np.asarray(tree.cat_bitset[i], dtype=np.uint32)[:8]
        bits[i, :len(bb)] = bb
        br = np.asarray(tree.cat_bitset_real[i], dtype=np.uint32)
        bits_real[i, :len(br)] = br

    L = max(tree.num_leaves, 1, pad_leaves)
    leaf_value = np.zeros(L, dtype=np.float32)
    leaf_value[:max(tree.num_leaves, 1)] = \
        tree.leaf_value[:max(tree.num_leaves, 1)]
    FL = max(1, pad_leaf_feats,
             max((len(tree.leaf_features[i]) for i in range(tree.num_leaves)),
                 default=0) if getattr(tree, "is_linear", False) else 0)
    leaf_const = leaf_value.copy()
    leaf_feat = np.full((L, FL), -1, dtype=np.int32)
    leaf_coeff = np.zeros((L, FL), dtype=np.float32)
    if getattr(tree, "is_linear", False):
        nl = tree.num_leaves
        leaf_const[:nl] = np.asarray(tree.leaf_const[:nl], np.float32)
        for i in range(nl):
            lfeats = tree.leaf_features[i]
            if lfeats:
                leaf_feat[i, :len(lfeats)] = lfeats
                leaf_coeff[i, :len(lfeats)] = np.asarray(tree.leaf_coeff[i],
                                                         np.float32)
    return TreeArrays(
        split_feature=pad(feats[:max(tree.num_internal, 1)]),
        threshold=pad(tree.threshold_real, fill=0.0, dtype=np.float32),
        threshold_bin=pad(tree.threshold_bin),
        default_left=pad(tree.default_left, dtype=bool),
        missing_type=pad(tree.missing_type),
        default_bin=default_bin,
        num_bin=num_bin,
        left_child=pad(left, fill=~0),
        right_child=pad(right, fill=~0),
        is_categorical=pad(tree.is_categorical, dtype=bool),
        cat_bitset=bits,
        cat_bitset_real=bits_real,
        leaf_value=leaf_value,
        leaf_const=leaf_const,
        leaf_feat=leaf_feat,
        leaf_coeff=leaf_coeff,
    )


def forest_to_arrays(trees, feature_meta=None,
                     use_inner_feature: bool = False,
                     device: Optional[torch.device] = None
                     ) -> Tuple[TreeArrays, int]:
    """Stack host Trees into one TreeArrays with a leading T axis, padded to
    common node/leaf/bitset-width sizes. Returns (stacked arrays, padded
    max_depth). With ``device`` the arrays come back as tensors on it
    (:func:`to_device`); without, as numpy — the compiled artifact copies
    its leaf tables from the numpy form."""
    assert trees, "forest_to_arrays needs at least one tree"

    def _round32(v: int) -> int:
        return max(32, ((v + 31) // 32) * 32)

    M = _round32(max(max(t.num_internal, 1) for t in trees))
    L = _round32(max(max(t.num_leaves, 1) for t in trees))
    W = max([8] + [len(t.cat_bitset_real[i]) for t in trees
                   for i in range(t.num_internal)])
    FLr = max([0] + [len(t.leaf_features[i]) for t in trees
                     if getattr(t, "is_linear", False)
                     for i in range(t.num_leaves)])
    FL = max(1, ((FLr + 3) // 4) * 4) if FLr else 1
    depth = _round_depth(max(t.max_depth for t in trees) + 1)
    per_tree = [tree_to_arrays(t, feature_meta, use_inner_feature,
                               pad_nodes=M, pad_leaves=L, pad_cat_words=W,
                               pad_leaf_feats=FL)
                for t in trees]
    stacked = TreeArrays(*(np.stack(cols) for cols in zip(*per_tree)))
    if device is not None:
        stacked = to_device(stacked, device)
    return stacked, depth


def to_device(arrays: TreeArrays, device: torch.device) -> TreeArrays:
    """numpy TreeArrays -> tensors on ``device`` (u32 bitsets -> int64)."""
    def conv(a):
        a = np.asarray(a)
        if a.dtype == np.uint32:
            a = a.astype(np.int64)
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return TreeArrays(*(conv(a) for a in arrays))


def _round_depth(d: int) -> int:
    """Pad traversal depth to a multiple of 8 (the JAX package's jit
    specialization bound; kept so both oracles run the same step count)."""
    return max(8, ((d + 7) // 8) * 8)


def category_of(v: torch.Tensor) -> torch.Tensor:
    """Raw feature value -> integer category, int64: NaN -> -1, else
    truncation toward zero saturated to int32 — what the JAX package's
    ``jnp.where(nan, -1, v).astype(int32)`` gives (XLA saturates; a plain
    torch f32 -> int32 cast of 1e10 does not)."""
    v = torch.where(torch.isnan(v), -1.0, v)
    return v.double().clamp(-2.0 ** 31, 2.0 ** 31 - 1).to(torch.int64)


def cat_go_left(cat: torch.Tensor, bitset_rows: torch.Tensor,
                nbits: int) -> torch.Tensor:
    """cat: int64 [...]; bitset_rows: int64 words [..., W] with
    W * 32 == nbits. In-range categories go left iff their bit is set."""
    inb = (cat >= 0) & (cat < nbits)
    safe = cat.clamp(0, nbits - 1)
    word = torch.gather(bitset_rows, -1, (safe // 32).unsqueeze(-1))[..., 0]
    bit = (word >> (safe % 32)) & 1
    return inb & (bit == 1)


def _traverse_leaf_id(x: torch.Tensor, t: TreeArrays,
                      max_depth: int) -> torch.Tensor:
    """Vectorized traversal of one tree (tensor fields, no T axis) over
    all raw rows -> leaf index [N] (int64)."""
    N = x.shape[0]
    nbits = t.cat_bitset_real.shape[-1] * 32
    node = torch.zeros(N, dtype=torch.int64, device=x.device)
    for _ in range(max_depth):
        n = node.clamp(min=0)
        f = t.split_feature[n].long()
        v = torch.gather(x, 1, f[:, None])[:, 0]
        nan = torch.isnan(v)
        mt = t.missing_type[n]
        # NaN converted to 0 unless NaN-missing
        # (reference: tree.h NumericalDecision)
        v0 = torch.where(nan & (mt != MT_NAN), 0.0, v)
        missing = ((mt == MT_NAN) & nan) | \
                  ((mt == MT_ZERO) & (v0.abs() <= K_ZERO_THRESHOLD))
        go_num = torch.where(missing, t.default_left[n],
                             v0 <= t.threshold[n])
        go_cat = cat_go_left(category_of(v), t.cat_bitset_real[n], nbits)
        go = torch.where(t.is_categorical[n], go_cat, go_num)
        nxt = torch.where(go, t.left_child[n], t.right_child[n]).long()
        node = torch.where(node < 0, node, nxt)
    return ~node


def _traverse_leaf_id_binned(x_binned: torch.Tensor, t: TreeArrays,
                             max_depth: int) -> torch.Tensor:
    """Traversal of one tree over binned rows (inner-feature columns)
    -> leaf index [N] (int64), routing exactly like the train-time
    partition (``ops/partition.decision_go_left``)."""
    N = x_binned.shape[0]
    if x_binned.dtype == torch.uint16:      # torch gathers no u16 on the CPU
        x_binned = x_binned.int()
    nbits = t.cat_bitset.shape[-1] * 32
    node = torch.zeros(N, dtype=torch.int64, device=x_binned.device)
    for _ in range(max_depth):
        n = node.clamp(min=0)
        f = t.split_feature[n].long()
        b = torch.gather(x_binned, 1, f[:, None])[:, 0].long()
        mt = t.missing_type[n]
        missing = ((mt == MT_ZERO) & (b == t.default_bin[n])) | \
                  ((mt == MT_NAN) & (b == t.num_bin[n] - 1))
        go_num = torch.where(missing, t.default_left[n],
                             b <= t.threshold_bin[n])
        go_cat = cat_go_left(b, t.cat_bitset[n], nbits)
        go = torch.where(t.is_categorical[n], go_cat, go_num)
        nxt = torch.where(go, t.left_child[n], t.right_child[n]).long()
        node = torch.where(node < 0, node, nxt)
    return ~node


def predict_tree_binned(x_binned: torch.Tensor, t: TreeArrays,
                        max_depth: int) -> torch.Tensor:
    """One tree's leaf values [N] f32 over the binned matrix [N, F] (the
    validation-set scoring of training, gbdt.py's per-tree eval update).
    ``t`` holds tensors on the matrix's device, built with
    ``use_inner_feature=True`` and the dataset's ``feature_meta``;
    ``max_depth`` is at least the tree's depth."""
    return t.leaf_value[_traverse_leaf_id_binned(x_binned, t, max_depth)]


def predict_leaf_index_binned(x_binned: torch.Tensor, t: TreeArrays,
                              max_depth: int) -> torch.Tensor:
    """Leaf index per row over the binned matrix (refit / rollback)."""
    return _traverse_leaf_id_binned(x_binned, t, max_depth)


def _tree(forest: TreeArrays, i: int) -> TreeArrays:
    return TreeArrays(*(a[i] for a in forest))


def _leaf_id(x: torch.Tensor, t: TreeArrays, max_depth: int,
             binned: bool) -> torch.Tensor:
    return (_traverse_leaf_id_binned(x, t, max_depth) if binned
            else _traverse_leaf_id(x, t, max_depth))


def _forest_block(forest: TreeArrays, tree_class: Sequence[int], b: int,
                  tree_block: int, T: int) -> Tuple[TreeArrays, List[int]]:
    """Trees [b, b+tree_block) of the stacked forest; only the TAIL block
    pads, with no-op trees (all-zero arrays: the bounded traversal never
    leaves node 0 and lands on ``leaf_value[-1] == 0``, adding exactly
    +0.0 — and pads sit strictly after every real tree, so early-stop
    margins are unaffected). A pad's linear slots are empty (-1), so it
    adds +0.0 under ``has_linear`` too, whatever the rows hold."""
    hi = min(b + tree_block, T)
    pad = tree_block - (hi - b)

    def cut(a: torch.Tensor, fill: int = 0) -> torch.Tensor:
        blk = a[b:hi]
        if pad:
            blk = torch.cat([blk, torch.full((pad,) + tuple(a.shape[1:]),
                                             fill, dtype=a.dtype,
                                             device=a.device)])
        return blk

    tc = [int(k) for k in tree_class[b:hi]] + [0] * pad
    return TreeArrays(*(cut(a, -1 if name == "leaf_feat" else 0)
                        for name, a in zip(TreeArrays._fields, forest))), tc


def build_forest_blocks(forest: TreeArrays, tree_class: Sequence[int],
                        tree_block: Optional[int] = None):
    """Pre-slice a stacked tensor forest into bounded, padded tree blocks
    ONCE (the booster's and the serve cache's forest is immutable between
    calls). Returns a tuple of ``(block TreeArrays, block tree_class,
    n_real)``, or None when the forest fits a single block."""
    T = len(tree_class)
    if tree_block is None:
        tree_block = DEFAULT_TREE_BLOCK
    if tree_block <= 0 or T <= tree_block:
        return None
    out = []
    for b in range(0, T, tree_block):
        blk, tc = _forest_block(forest, tree_class, b, tree_block, T)
        out.append((blk, tc, min(b + tree_block, T) - b))
    return tuple(out)


def _tree_leaf_vals(x: torch.Tensor, t: TreeArrays, max_depth: int,
                    binned: bool, has_linear: bool) -> torch.Tensor:
    """One tree's per-row output [N]: the constant leaf gather or, for a
    linear forest on raw rows, the linear leaf evaluation."""
    leaf = _leaf_id(x, t, max_depth, binned)
    if not has_linear:
        return t.leaf_value[leaf]
    from .linear import linear_leaf_values
    return linear_leaf_values(x, leaf[:, None], t.leaf_value, t.leaf_const,
                              t.leaf_feat, t.leaf_coeff)[:, 0]


def _predict_forest_block(x: torch.Tensor, forest: TreeArrays,
                          tree_class: Sequence[int], carry, max_depth: int,
                          binned: bool, early_stop_freq: int,
                          early_stop_margin: float, has_linear: bool = False):
    """One block of trees, threading the (out, stopped, i) carry: one f32
    add per tree in forest order."""
    out, stopped, i = carry
    for j, k in enumerate(tree_class):
        t = _tree(forest, j)
        vals = _tree_leaf_vals(x, t, max_depth, binned, has_linear)
        if early_stop_freq <= 0:
            out[k] += vals
            continue
        out[k] += torch.where(stopped, 0.0, vals)
        i += 1
        if i % early_stop_freq == 0:
            stopped |= margin_of(out) > early_stop_margin
    return out, stopped, i


def init_carry(num_class: int, n: int, device) -> tuple:
    """The (scores, stopped, trees seen) carry threaded across blocks."""
    return (torch.zeros((num_class, n), dtype=torch.float32, device=device),
            torch.zeros(n, dtype=torch.bool, device=device), 0)


def predict_forest(x: torch.Tensor, forest: TreeArrays,
                   tree_class: Sequence[int], num_class: int,
                   max_depth: int, early_stop_freq: int = 0,
                   early_stop_margin: float = 0.0, blocks=None,
                   binned: bool = False,
                   has_linear: bool = False) -> torch.Tensor:
    """Sum a whole forest's leaf values into per-class scores.

    x: [N, D] raw f32 rows (or, ``binned``, the [N, F] binned matrix) on
    the forest's device. forest: tensor TreeArrays stacked along a leading
    T axis (``forest_to_arrays(..., device=)``). tree_class: class index
    of each tree (iter-major, class-minor). early_stop_freq/margin: every
    ``freq`` trees, rows whose margin exceeds ``margin`` stop accumulating
    (reference: src/boosting/prediction_early_stop.cpp; binary margin =
    2*|score|, multiclass = top1 - top2). ``blocks`` from
    :func:`build_forest_blocks` run the same trees block by block with the
    carry threaded through (the padded tail adds +0.0). ``has_linear``:
    evaluate the linear leaf payload (raw rows only). Returns
    [num_class, N] float32."""
    assert not (binned and has_linear), \
        "linear forests traverse raw rows; binned replays are per tree"
    carry = init_carry(num_class, x.shape[0], x.device)
    if blocks is None:
        blocks = ((forest, [int(k) for k in tree_class], len(tree_class)),)
    for blk, tc, _ in blocks:
        carry = _predict_forest_block(x, blk, tc, carry, max_depth, binned,
                                      early_stop_freq, early_stop_margin,
                                      has_linear)
    return carry[0]


def predict_forest_leaf(x: torch.Tensor, forest: TreeArrays,
                        max_depth: int, binned: bool = False,
                        tree_block: Optional[int] = None,
                        blocks=None) -> torch.Tensor:
    """Leaf index per (tree, row) for a whole forest: [T, N] int32,
    dispatched in the same bounded blocks as :func:`predict_forest` (the
    pads' rows are dropped)."""
    T = forest.leaf_value.shape[0]
    if blocks is None:
        blocks = build_forest_blocks(forest, [0] * T, tree_block)
    if blocks is None:
        blocks = ((forest, [0] * T, T),)
    outs = []
    for blk, _, n_real in blocks:
        outs.extend(_leaf_id(x, _tree(blk, j), max_depth, binned)
                    for j in range(n_real))
    if not outs:
        return torch.zeros((0, x.shape[0]), dtype=torch.int32,
                           device=x.device)
    return torch.stack(outs).to(torch.int32)


def margin_of(out: torch.Tensor) -> torch.Tensor:
    """Early-stop decision margin per row of ``[K, N]`` scores."""
    if out.shape[0] == 1:
        # reference binary margin is 2*|raw score|
        # (src/boosting/prediction_early_stop.cpp)
        return 2.0 * out[0].abs()
    top2 = torch.topk(out.T, 2, dim=1).values
    return top2[:, 0] - top2[:, 1]
