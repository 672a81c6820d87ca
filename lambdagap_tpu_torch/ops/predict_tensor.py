"""Tensorized forest traversal (``predict_engine=tensor``): all rows x a
tile of trees per depth step.

The port of ``lambdagap_tpu/ops/predict_tensor.py``. The scan engine
(:mod:`lambdagap_tpu_torch.ops.predict`) walks trees one at a time; this
engine walks a ``[R, Tt]`` node-index carry — R rows x a tile of Tt trees —
one depth step per iteration, each step a few batched gathers on the
stacked node tables flattened to ``T*M`` (plus one gather of the rows'
feature values). Tiles are bounded by ``predict_tree_tile`` so the working
set never grows with the forest; the score carry threads across tiles like
the scan engine's blocks, and the padded tail of the last tile (the scan
engine's no-op trees) contributes exactly +0.0.

The JAX engine is XLA-lowered, with no Pallas kernel, so plain torch ops
are its counterpart here, as for every other XLA-lowered module. Its
contract carries over: after the parallel traversal gathers every tree's
leaf value, the per-class accumulation adds them tree by tree IN FOREST
ORDER — the scan engine's f32 additions in the scan engine's order — with
the same early-stop replay, so the two engines return bit-identical
scores (``tests/test_torch_predict_tensor.py`` asserts equality). The
traversal still computes rows that stopped early.

Decision rules (NaN/default-left routing, categorical bitsets, binned bin
compares, zero-missing) follow ``ops/predict._traverse_leaf_id`` decision
for decision; a raw categorical value takes :func:`ops.predict.category_of`,
the saturating cast XLA's convert performs. Linear leaves are not ported:
callers refuse linear forests before they reach this module.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from .predict import (DEFAULT_TREE_BLOCK, K_ZERO_THRESHOLD, MT_NAN, MT_ZERO,
                      TreeArrays, build_forest_blocks, category_of,
                      init_carry, margin_of)

# the JAX package's LAMBDAGAP_PREDICT_TREE_TILE default (config
# ``predict_tree_tile``)
DEFAULT_TREE_TILE = DEFAULT_TREE_BLOCK


def _traverse_tile(x: torch.Tensor, t: TreeArrays, max_depth: int,
                   binned: bool) -> torch.Tensor:
    """All rows through all trees of one tile -> final node carry [R, Tt]
    int64 (negative entries are ``~leaf``; a non-negative entry means the
    tree never reached a leaf — only the zero-padded no-op trees do
    that)."""
    R = x.shape[0]
    Tt, M = t.split_feature.shape
    dev = x.device
    # flatten the stacked node tables once; every per-level gather is then
    # one flat [R, Tt] gather at index tree*M + node
    feat = t.split_feature.reshape(-1).long()
    left = t.left_child.reshape(-1).long()
    right = t.right_child.reshape(-1).long()
    missing_type = t.missing_type.reshape(-1)
    default_left = t.default_left.reshape(-1)
    is_cat = t.is_categorical.reshape(-1)
    if binned:
        if x.dtype == torch.uint16:     # torch gathers no u16 on the CPU
            x = x.int()
        thr_bin = t.threshold_bin.reshape(-1)
        default_bin = t.default_bin.reshape(-1)
        num_bin = t.num_bin.reshape(-1)
        cat_words = t.cat_bitset.shape[-1]
        cat_bits = t.cat_bitset.reshape(-1)
    else:
        thr = t.threshold.reshape(-1)
        cat_words = t.cat_bitset_real.shape[-1]
        cat_bits = t.cat_bitset_real.reshape(-1)
    nbits = cat_words * 32
    base = (torch.arange(Tt, dtype=torch.int64, device=dev) * M)[None, :]

    def cat_go_left(cat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """The scan engine's bitset test over the [R, Tt] lattice (same
        clipping and bit math)."""
        inb = (cat >= 0) & (cat < nbits)
        safe = cat.clamp(0, nbits - 1)
        word = cat_bits[idx * cat_words + safe // 32]
        return inb & (((word >> (safe % 32)) & 1) == 1)

    node = torch.zeros((R, Tt), dtype=torch.int64, device=dev)
    for _ in range(max_depth):
        idx = base + node.clamp(min=0)                        # [R, Tt]
        f = feat[idx]
        mt = missing_type[idx]
        if binned:
            b = torch.gather(x, 1, f).long()
            missing = ((mt == MT_ZERO) & (b == default_bin[idx])) | \
                      ((mt == MT_NAN) & (b == num_bin[idx] - 1))
            go_num = torch.where(missing, default_left[idx],
                                 b <= thr_bin[idx])
            go_cat = cat_go_left(b, idx)
        else:
            v = torch.gather(x, 1, f)
            nan = torch.isnan(v)
            # NaN converted to 0 unless NaN-missing
            # (reference: tree.h NumericalDecision)
            v0 = torch.where(nan & (mt != MT_NAN), 0.0, v)
            missing = ((mt == MT_NAN) & nan) | \
                      ((mt == MT_ZERO) & (v0.abs() <= K_ZERO_THRESHOLD))
            go_num = torch.where(missing, default_left[idx], v0 <= thr[idx])
            go_cat = cat_go_left(category_of(v), idx)
        go = torch.where(is_cat[idx], go_cat, go_num)
        nxt = torch.where(go, left[idx], right[idx])
        node = torch.where(node < 0, node, nxt)
    return node


def _tile_leaf_values(node: torch.Tensor, t: TreeArrays) -> torch.Tensor:
    """Leaf-value gather for a traversed tile: [R, Tt] f32. No-op pad
    trees (node >= 0) contribute exactly 0.0, like the scan engine's padded
    tail blocks."""
    Tt, L = t.leaf_value.shape
    done = node < 0
    leaf = torch.where(done, ~node, 0)
    idx = (torch.arange(Tt, dtype=torch.int64,
                        device=node.device) * L)[None, :] + leaf
    vals = t.leaf_value.reshape(-1)[idx]
    return torch.where(done, vals, 0.0)


def _predict_tensor_tile(x: torch.Tensor, t: TreeArrays,
                         tree_class: Sequence[int], carry, max_depth: int,
                         binned: bool, early_stop_freq: int = 0,
                         early_stop_margin: float = 0.0):
    """One tile: the parallel [R, Tt] traversal, then the forest-order
    accumulation threading the scan engine's (out, stopped, i) carry —
    the same f32 additions in the same order, the same early-stop
    points."""
    vals = _tile_leaf_values(_traverse_tile(x, t, max_depth, binned), t)
    valsT = vals.T                                            # [Tt, R]
    out, stopped, i = carry
    for j, k in enumerate(tree_class):
        if early_stop_freq <= 0:
            out[k] += valsT[j]
            continue
        out[k] += torch.where(stopped, 0.0, valsT[j])
        i += 1
        if i % early_stop_freq == 0:
            stopped |= margin_of(out) > early_stop_margin
    return out, stopped, i


def _leaf_tensor_tile(x: torch.Tensor, t: TreeArrays, max_depth: int,
                      binned: bool) -> torch.Tensor:
    """Leaf index per (tree, row) for one tile: [Tt, R] int32."""
    return (~_traverse_tile(x, t, max_depth, binned)).T.to(torch.int32)


def build_tree_tiles(forest: TreeArrays, tree_class: Sequence[int],
                     tree_tile: Optional[int] = None):
    """Pre-slice a stacked forest into ``predict_tree_tile``-sized tiles
    ONCE (the scan engine's padded-tail block layout, so either engine
    can consume the result). Returns None when the forest fits one
    tile."""
    return build_forest_blocks(forest, tree_class,
                               DEFAULT_TREE_TILE if tree_tile is None
                               else tree_tile)


def predict_forest_tensor(x: torch.Tensor, forest: TreeArrays,
                          tree_class: Sequence[int], num_class: int,
                          max_depth: int, binned: bool = False,
                          early_stop_freq: int = 0,
                          early_stop_margin: float = 0.0,
                          tree_tile: Optional[int] = None,
                          tiles=None) -> torch.Tensor:
    """Tensorized drop-in for :func:`ops.predict.predict_forest`: x is
    [N, D] raw f32 rows (``binned=False``) or the [N, F] binned matrix;
    returns [num_class, N] float32, bit-identical to the scan engine.
    ``tiles`` (from :func:`build_tree_tiles`) skips the per-call forest
    re-slice; ``tree_tile`` bounds the [R, Tt] working set (default
    ``predict_tree_tile``'s 64)."""
    tc = [int(k) for k in tree_class]
    carry = init_carry(num_class, x.shape[0], x.device)
    if tiles is None:
        tiles = build_tree_tiles(forest, tc, tree_tile)
    if tiles is None:
        tiles = ((forest, tc, len(tc)),)
    for blk, btc, _ in tiles:
        carry = _predict_tensor_tile(x, blk, btc, carry, max_depth, binned,
                                     early_stop_freq, early_stop_margin)
    return carry[0]


def predict_forest_leaf_tensor(x: torch.Tensor, forest: TreeArrays,
                               max_depth: int, binned: bool = False,
                               tree_tile: Optional[int] = None,
                               tiles=None) -> torch.Tensor:
    """Tensorized drop-in for :func:`ops.predict.predict_forest_leaf`:
    leaf index per (tree, row), [T, N] int32."""
    T = forest.leaf_value.shape[0]
    if tiles is None:
        tiles = build_tree_tiles(forest, [0] * T, tree_tile)
    if tiles is None:
        tiles = ((forest, [0] * T, T),)
    outs = [_leaf_tensor_tile(x, blk, max_depth, binned)[:n_real]
            for blk, _, n_real in tiles]
    return torch.cat(outs, dim=0)
