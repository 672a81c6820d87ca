"""SHAP feature contributions (``pred_contrib``): TreeSHAP on the card.

The port of ``lambdagap_tpu/models/shap.py``, whose native kernel
(``lambdagap_tpu/native/treeshap.cpp`` ``lg_tree_shap``) runs the
reference's per-row unique-path recursion on the host (reference:
src/io/tree.cpp TreeSHAP, include/LightGBM/tree.h PredictContrib). Here
the same values come from the *path form* of that recursion (GPUTreeShap,
Mitchell et al., arXiv:2010.13972): :func:`build_paths` splits every tree
once, on the host, into its root-to-leaf paths. A feature that repeats on
a path is merged into one element — its zero fraction is the product of
the cover ratios of its edges, its one fraction is 1 only if the row takes
every one of them — so a path holds at most ``min(depth, F) + 1``
elements (the first one the recursion's root dummy). Each (row, path) is
then independent: extend the path's weights over its elements, then one
unwound sum per element; the result is Lundberg's recursion with its
additions in another order (so the bar against the JAX package is a
tolerance, not equality).

Decisions are taken in float64 on a float64 copy of the rows, with
``lg_tree_shap``'s rules (not the traversal kernel's f32 ones): a
categorical NaN goes right, a category is the truncated value and goes
right when negative or past the node's bitset, a numeric NaN is 0.0 unless
the node is NaN-missing, zero-missing means |v| <= 1e-35. Each tree's
expected value ``sum(lv * lcnt) / sum(lcnt)`` (0 when the counts sum to 0;
a stump's single leaf value) goes into the last column; tree t adds into
class ``tree_class[t]``.

:func:`build_paths` also lays the paths out for kernel S: each class's
paths packed into warp groups of at most 32 lanes (best-fit decreasing by
length, :func:`_pack_lanes`), a path of e merged elements on e + 1
consecutive lanes, the root dummy first; a CSR of edges per element, so a
lane decides only its own element's edges; and the list of paths too long
for a warp (more than 32 elements), which take the kernel's per-lane path.

:func:`tree_shap` is the wrapper: on a CUDA tensor it makes kernel S's
launches (``csrc/treeshap.cu``: at most three a pass of rows,
:func:`launch_plan`) or raises, a path longer than the long-path kernel's
cap included; on a CPU tensor it runs the plain version
(:func:`_tree_shap_reference`), the same per-path recurrence as float64
torch ops over a ``[rows, paths, path_len]`` lattice, chunked so its
memory stays bounded. Linear leaves are not ported: callers refuse linear
forests before they reach this module.
"""
from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..infer.engine import LaunchCounter
from .tree import Tree

TREE_SHAP_SOURCE = "treeshap.cu"
WARP = 32
# path caps (elements, the root dummy included) the long-path kernel is
# compiled for; a forest whose longest merged path needs more raises
PATH_CAPS = (64, 128, 256)
FLAG_DEFAULT_LEFT, FLAG_MT_SHIFT, FLAG_CATEGORICAL = 1, 1, 8
MT_ZERO, MT_NAN = 1, 2
K_ZERO_THRESHOLD = 1e-35
# bytes of a pass's workspace (its chunk slices, [slices, rows, F]
# float64: a batch runs in passes of as many rows as this holds, one row
# at least), and of the long-path kernel's per-lane accumulators
SCRATCH_BYTES = 512 << 20
# the grouped kernel: warps a block, rows a tile, shared memory a block
# (rows and per-warp partials), and chunks (enough for one row's grid to
# fill the 132 SMs; the ordered reduction adds a class's chunks serially)
WARPS_PER_BLOCK = 8
TILE_ROWS = 16
SMEM_TARGET = 48 << 10
SMEM_MAX = 226 << 10           # of 227 KB: the kernel's static table too
MAX_CHUNKS = 512
LONG_WARPS_PER_BLOCK = 4

TREE_SHAP_LAUNCHES = LaunchCounter()


class ShapPaths(NamedTuple):
    """A forest as root-to-leaf paths, in CSR form (numpy on the host, or
    tensors after :func:`to_device`). Paths are grouped by class, forest
    order within a class, leaf order within a tree."""
    node_feat: object      # i32 [n] split feature of every internal node
    node_thr: object       # f64 [n] threshold
    node_flags: object     # i32 [n] default-left | missing type << 1 | cat
    node_cat_lo: object    # i32 [n] first word of the node's bitset
    node_cat_nw: object    # i32 [n] words of the node's bitset
    cat_bits: object       # u32 [W] words (int64 tensors on a device)
    path_value: object     # f64 [P] leaf value
    path_elem_lo: object   # i32 [P + 1] CSR into the elements
    path_edge_lo: object   # i32 [P + 1] CSR into the edges
    class_path_lo: object  # i32 [K + 1] first path of each class
    elem_feat: object      # i32 [E] feature of each merged element
    elem_zero: object      # f64 [E] its zero fraction
    edge_node: object      # i32 [Ed] internal node of each edge
    edge_slot: object      # i32 [Ed] element slot (1-based) << 1 | left
    bias: object           # f64 [K] the class's summed expected values
    # kernel S's lane layout: warp groups by class, lanes by group
    class_group_lo: object  # i32 [K + 1] first warp group of each class
    lane_path: object      # i32 [G * 32] path of each lane, -1 idle
    lane_slot: object      # i32 [G * 32] its element slot (0 the dummy)
    elem_edge_lo: object   # i32 [E + 1] CSR into elem_edge
    elem_edge: object      # i32 [Ed] node << 1 | left, by element
    long_path: object      # i32 [L] paths of more than 32 elements
    class_long_lo: object  # i32 [K + 1] first long path of each class
    max_elems: int         # longest merged path, root dummy included
    max_edges: int         # deepest leaf
    class_groups: tuple    # class_group_lo on the host
    num_long: int          # paths of more than 32 elements
    max_feature: int       # largest split feature, -1 for none


NUM_TABLES = 22            # the array fields of ShapPaths


def _expected_value(tree: Tree) -> float:
    """``lg_tree_shap``'s cover-weighted mean of the leaf outputs, its
    sums taken leaf by leaf in index order."""
    n = tree.num_internal
    if n == 0:
        return float(tree.leaf_value[0])
    lv = np.asarray(tree.leaf_value[:n + 1], np.float64)
    lc = np.asarray(tree.leaf_count[:n + 1], np.float64)
    num = float(np.cumsum(lv * lc)[-1])
    den = float(np.cumsum(lc)[-1])
    return num / den if den > 0 else 0.0


def build_paths(trees: Sequence[Tree], tree_class: Sequence[int],
                num_class: int) -> ShapPaths:
    """Split every tree into its root-to-leaf paths (host numpy, vectorized
    over the whole forest): each leaf's edges walked up to the root, then
    merged by feature."""
    bias = np.zeros(num_class, np.float64)
    for t, k in zip(trees, tree_class):
        bias[k] += _expected_value(t)
    feats, thrs, flags, cat_lo, cat_nw, words = [], [], [], [], [], []
    lefts, rights, icount = [], [], []
    leaf_val, leaf_cnt, leaf_cls = [], [], []
    node_off = leaf_off = word_off = 0
    for t, k in zip(trees, tree_class):
        n = t.num_internal
        if n == 0:
            continue                     # a stump: its value is in bias
        L = n + 1
        feats.append(np.asarray(t.split_feature[:n], np.int32))
        thrs.append(np.asarray(t.threshold_real[:n], np.float64))
        flags.append(
            np.asarray(t.default_left[:n], np.int32) * FLAG_DEFAULT_LEFT
            | np.asarray(t.missing_type[:n], np.int32) << FLAG_MT_SHIFT
            | np.asarray(t.is_categorical[:n], np.int32) * FLAG_CATEGORICAL)
        nw = np.asarray([len(t.cat_bitset_real[i]) for i in range(n)],
                        np.int32)
        cat_nw.append(nw)
        cat_lo.append(word_off + np.concatenate([[0], np.cumsum(nw)[:-1]])
                      .astype(np.int32))
        words.extend(np.asarray(t.cat_bitset_real[i], np.uint32)
                     for i in range(n))
        word_off += int(nw.sum())
        lc = np.asarray(t.left_child[:n], np.int64)
        rc = np.asarray(t.right_child[:n], np.int64)
        # global ids: internal nodes >= 0, leaves ~global_leaf
        lefts.append(np.where(lc >= 0, lc + node_off, ~(~lc + leaf_off)))
        rights.append(np.where(rc >= 0, rc + node_off, ~(~rc + leaf_off)))
        icount.append(np.asarray(t.internal_count[:n], np.float64))
        leaf_val.append(np.asarray(t.leaf_value[:L], np.float64))
        leaf_cnt.append(np.asarray(t.leaf_count[:L], np.float64))
        leaf_cls.append(np.full(L, k, np.int64))
        node_off += n
        leaf_off += L
    words.append(np.zeros(1, np.uint32))      # never empty
    cat_bits = np.concatenate(words)
    if not feats:
        i0, k0 = np.zeros(0, np.int32), np.zeros(num_class + 1, np.int32)
        return ShapPaths(
            i0, np.zeros(0), i0, i0, i0, cat_bits, np.zeros(0),
            np.zeros(1, np.int32), np.zeros(1, np.int32), k0, i0,
            np.zeros(0), i0, i0, bias, k0, i0, i0, np.zeros(1, np.int32),
            i0, i0, k0, 1, 0, (0,) * (num_class + 1), 0, -1)
    node_feat = np.concatenate(feats)
    left = np.concatenate(lefts)
    right = np.concatenate(rights)
    internal_count = np.concatenate(icount)
    lv = np.concatenate(leaf_val)
    lcnt = np.concatenate(leaf_cnt)
    lcls = np.concatenate(leaf_cls)
    n_nodes, n_leaves = node_off, leaf_off

    # parent of every internal node and every leaf, and which side it is
    p_node = np.full(n_nodes, -1, np.int64)
    p_left = np.zeros(n_nodes, bool)
    p_leaf = np.full(n_leaves, -1, np.int64)
    p_leaf_left = np.zeros(n_leaves, bool)
    ids = np.arange(n_nodes)
    for child, is_left in ((left, True), (right, False)):
        inner = child >= 0
        p_node[child[inner]] = ids[inner]
        p_left[child[inner]] = is_left
        p_leaf[~child[~inner]] = ids[~inner]
        p_leaf_left[~child[~inner]] = is_left

    # walk every leaf up to its root: one step per level, leaf-first
    steps_node, steps_left, steps_ratio = [], [], []
    cur, side, cover = p_leaf, p_leaf_left, lcnt
    while (cur >= 0).any():
        live = cur >= 0
        safe = np.maximum(cur, 0)
        steps_node.append(np.where(live, cur, -1))
        steps_left.append(side)
        steps_ratio.append(np.where(live, cover / internal_count[safe], 1.0))
        side = p_left[safe]
        cover = internal_count[safe]
        cur = np.where(live, p_node[safe], -1)
    # root-first order: [leaves, depth]
    e_node = np.stack(steps_node[::-1], axis=1)
    e_left = np.stack(steps_left[::-1], axis=1)
    e_ratio = np.stack(steps_ratio[::-1], axis=1)
    depth = (e_node >= 0).sum(axis=1)
    S = e_node.shape[1]
    # left-align each leaf's edges (reversed, a short path's edges end at
    # the last column)
    shift = S - depth
    col = (np.arange(S)[None, :] + shift[:, None]) % S
    e_node = np.take_along_axis(e_node, col, axis=1)
    e_left = np.take_along_axis(e_left, col, axis=1)
    e_ratio = np.take_along_axis(e_ratio, col, axis=1)
    valid = np.arange(S)[None, :] < depth[:, None]

    # path order: by class, forest order within a class
    order = np.argsort(lcls, kind="stable")
    e_node, e_left, e_ratio, valid = (a[order] for a in
                                      (e_node, e_left, e_ratio, valid))
    depth = depth[order]
    path_value = lv[order]
    class_path_lo = np.searchsorted(lcls[order], np.arange(num_class + 1)
                                    ).astype(np.int32)

    # merge the edges of one feature on a path into one element
    pp, ss = np.nonzero(valid)                   # root-first within a path
    ff = node_feat[e_node[pp, ss]]
    srt = np.lexsort((ss, ff, pp))               # by path, feature, depth
    gp, gf, gs = pp[srt], ff[srt], ss[srt]
    start = np.ones(len(srt), bool)
    start[1:] = (gp[1:] != gp[:-1]) | (gf[1:] != gf[:-1])
    g_lo = np.nonzero(start)[0]
    zero = np.multiply.reduceat(e_ratio[pp, ss][srt], g_lo)
    g_path, g_feat, g_first = gp[g_lo], gf[g_lo], gs[g_lo]
    g_order = np.lexsort((g_first, g_path))      # elements by first edge
    rank = np.empty(len(g_lo), np.int64)
    rank[g_order] = np.arange(len(g_lo))
    n_elem = np.bincount(g_path, minlength=len(depth))
    elem_lo = np.concatenate([[0], np.cumsum(n_elem)]).astype(np.int64)
    slot = rank - elem_lo[g_path] + 1            # 1-based; 0 is the dummy
    edge_group = np.cumsum(start) - 1
    edge_slot = np.empty(len(srt), np.int64)
    edge_slot[srt] = slot[edge_group]
    edge_lo = np.concatenate([[0], np.cumsum(depth)]).astype(np.int64)
    edge_node = e_node[pp, ss]
    edge_left = e_left[pp, ss].astype(np.int64)
    # each element's own edges, depth order within it
    edge_elem = elem_lo[pp] + edge_slot - 1
    by_elem = np.argsort(edge_elem, kind="stable")
    elem_edge_lo = np.concatenate(
        [[0], np.cumsum(np.bincount(edge_elem, minlength=int(elem_lo[-1])))])
    # warp groups by class; paths past a warp's lanes go on the long list
    lanes = n_elem + 1
    fits = lanes <= WARP
    lane_path, lane_slot, group_lo = [], [], [0]
    for k in range(num_class):
        paths = np.arange(class_path_lo[k], class_path_lo[k + 1])
        paths = paths[fits[paths]]
        group, first, groups = _pack_lanes(lanes[paths])
        lp = np.full(groups * WARP, -1, np.int64)
        ls = np.full(groups * WARP, -1, np.int64)
        owner = np.repeat(np.arange(len(paths)), lanes[paths])
        slot_of = np.arange(len(owner)) - np.repeat(
            np.cumsum(lanes[paths]) - lanes[paths], lanes[paths])
        at = group[owner] * WARP + first[owner] + slot_of
        lp[at] = paths[owner]
        ls[at] = slot_of
        lane_path.append(lp)
        lane_slot.append(ls)
        group_lo.append(group_lo[-1] + groups)
    long_path = np.nonzero(~fits)[0]                # by class already
    class_long_lo = np.searchsorted(long_path, class_path_lo)
    return ShapPaths(
        node_feat=node_feat.astype(np.int32),
        node_thr=np.concatenate(thrs),
        node_flags=np.concatenate(flags).astype(np.int32),
        node_cat_lo=np.concatenate(cat_lo).astype(np.int32),
        node_cat_nw=np.concatenate(cat_nw).astype(np.int32),
        cat_bits=cat_bits,
        path_value=path_value,
        path_elem_lo=elem_lo.astype(np.int32),
        path_edge_lo=edge_lo.astype(np.int32),
        class_path_lo=class_path_lo,
        elem_feat=g_feat[g_order].astype(np.int32),
        elem_zero=zero[g_order],
        edge_node=edge_node.astype(np.int32),
        edge_slot=(edge_slot << 1 | edge_left).astype(np.int32),
        bias=bias,
        class_group_lo=np.asarray(group_lo, np.int32),
        lane_path=np.concatenate(lane_path).astype(np.int32),
        lane_slot=np.concatenate(lane_slot).astype(np.int32),
        elem_edge_lo=elem_edge_lo.astype(np.int32),
        elem_edge=(edge_node[by_elem] << 1 | edge_left[by_elem])
        .astype(np.int32),
        long_path=long_path.astype(np.int32),
        class_long_lo=class_long_lo.astype(np.int32),
        max_elems=int(n_elem.max()) + 1,
        max_edges=int(depth.max()),
        class_groups=tuple(group_lo),
        num_long=len(long_path),
        max_feature=int(node_feat.max()))


def _pack_lanes(lanes: np.ndarray):
    """Best-fit decreasing of items of ``lanes`` lanes each (2..32) into
    warp groups of 32 lanes (GPUTreeShap's packing), item sizes taken a
    size at a time: the open groups with the fewest free lanes that still
    hold an item first, each taking as many items of that size as fit.
    Returns (group of each item, its first lane, number of groups)."""
    n = len(lanes)
    group = np.zeros(n, np.int64)
    first = np.zeros(n, np.int64)
    fill = np.zeros(n, np.int64)                 # lanes used, per group
    free = [np.zeros(0, np.int64) for _ in range(WARP + 1)]
    groups = 0

    def place(items, bins, q, s):
        """items[t] into bins[t // q] at the next free lanes; bins re-filed
        by their free lanes."""
        t = np.arange(len(items))
        b = bins[t // q]
        group[items] = b
        first[items] = fill[b] + (t % q) * s
        fill[bins] += np.bincount(t // q, minlength=len(bins)) * s
        left = WARP - fill[bins]
        for c in np.unique(left):
            free[c] = np.concatenate([free[c], bins[left == c]])

    order = np.argsort(-lanes, kind="stable")
    sizes = lanes[order]
    for s in np.unique(sizes)[::-1]:
        items = order[sizes == s]
        for c in range(int(s), WARP):
            if not len(items):
                break
            if not len(free[c]):
                continue
            q = c // s
            take = min(len(free[c]), -(-len(items) // q))
            bins, free[c] = free[c][:take], free[c][take:]
            cnt = min(len(items), take * q)
            place(items[:cnt], bins, q, s)
            items = items[cnt:]
        if len(items):
            q = WARP // s
            new = groups + np.arange(-(-len(items) // q))
            groups += len(new)
            place(items, new, q, s)
    return group, first, groups


def to_device(p: ShapPaths, device: torch.device) -> ShapPaths:
    """Upload the path tables once (bitset words widened to int64: torch
    shifts no u32, and the kernel reads the same words)."""
    def up(a):
        a = np.asarray(a)
        if a.dtype == np.uint32:
            a = a.astype(np.int64)
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return ShapPaths(*(up(a) for a in p[:NUM_TABLES]), *p[NUM_TABLES:])


def path_cap(max_elems: int) -> int:
    """The smallest cap of the long-path kernel that holds ``max_elems``
    path elements; a longer path raises, naming the cap."""
    for cap in PATH_CAPS:
        if max_elems <= cap:
            return cap
    raise ValueError(f"a merged TreeSHAP path needs {max_elems} elements; "
                     f"kernel S is compiled for at most {PATH_CAPS[-1]}")


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------
def _decide(x: torch.Tensor, node: torch.Tensor,
            p: ShapPaths) -> torch.Tensor:
    """Go-left of every (row, path) at the edges' nodes ``node`` [P]:
    ``lg_tree_shap``'s ``decide_left`` in float64 -> [R, P] bool."""
    v = x[:, p.node_feat[node].long()]
    fl = p.node_flags[node]
    thr = p.node_thr[node]
    dl = (fl & FLAG_DEFAULT_LEFT) != 0
    mt = (fl >> FLAG_MT_SHIFT) & 3
    is_cat = (fl & FLAG_CATEGORICAL) != 0
    nan = torch.isnan(v)
    # a category in [0, 32 * words) is the truncated value (NaN fails both
    # tests; out-of-range values never reach the integer cast)
    nbits = (p.node_cat_nw[node] * 32).double()
    in_range = (v > -1.0) & (v < nbits)
    c = torch.where(in_range, v, 0.0).long()
    word = p.cat_bits[(p.node_cat_lo[node].long() + c // 32)
                      .clamp(max=p.cat_bits.shape[0] - 1)]
    go_cat = in_range & (((word >> (c % 32)) & 1) == 1)
    v0 = torch.where(nan & (mt != MT_NAN), 0.0, v)
    missing = ((mt == MT_NAN) & nan) | \
              ((mt == MT_ZERO) & (v0.abs() <= K_ZERO_THRESHOLD))
    go_num = torch.where(missing, dl, v0 <= thr)
    return torch.where(is_cat, go_cat, go_num)


def _padded(p: ShapPaths, sel: torch.Tensor):
    """Paths ``sel`` padded to [P, m] elements (slot 0 the root dummy:
    feature 0, zero fraction 1; m the longest of them) and [P, edges]
    edges."""
    dev = p.path_value.device
    elo, ehi = p.path_elem_lo[sel].long(), p.path_elem_lo[sel + 1].long()
    n_elem = ehi - elo
    m = int(n_elem.max()) + 1
    j = torch.arange(m, device=dev)
    inside = (j[None, :] >= 1) & (j[None, :] <= n_elem[:, None])
    src = (elo[:, None] + j[None, :] - 1).clamp(
        0, max(p.elem_feat.shape[0] - 1, 0))
    feat = torch.where(inside, p.elem_feat[src].long(), 0)
    zero = torch.where(inside, p.elem_zero[src], 1.0)
    dlo, dhi = p.path_edge_lo[sel].long(), p.path_edge_lo[sel + 1].long()
    n_edge = dhi - dlo
    s = torch.arange(max(int(n_edge.max()), 1), device=dev)
    ok = s[None, :] < n_edge[:, None]
    esrc = (dlo[:, None] + s[None, :]).clamp(
        0, max(p.edge_node.shape[0] - 1, 0))
    node = torch.where(ok, p.edge_node[esrc].long(), 0)
    code = p.edge_slot[esrc].long()
    slot = torch.where(ok, code >> 1, 0)
    go_left = (code & 1) == 1
    return feat, zero, n_elem, node, slot, go_left, ok


def _chunk_contrib(x: torch.Tensor, p: ShapPaths, sel: torch.Tensor):
    """Contributions of paths ``sel`` to rows ``x``: ([R, P * m] float64,
    their feature ids [P * m])."""
    feat, zero, n_elem, node, slot, go_left, ok = _padded(p, sel)
    R, (P, m) = x.shape[0], feat.shape
    dev = x.device
    # one fractions: 0 once the row leaves any edge of the element
    o = torch.ones((R, P, m), dtype=torch.float64, device=dev)
    for s in range(node.shape[1]):
        bad = (_decide(x, node[:, s], p) != go_left[None, :, s]) & \
            ok[None, :, s]
        idx = slot[:, s].view(1, P, 1).expand(R, P, 1)
        o.scatter_(2, idx, torch.where(bad[..., None], 0.0, o.gather(2, idx)))
    # extend over the elements, lg_tree_shap's extend_path arithmetic; the
    # divisors are tensors, because torch divides by a Python number on
    # the card as a multiply by its reciprocal, which is not the rounded
    # quotient
    jj = torch.arange(m, dtype=torch.float64, device=dev)
    ji = torch.arange(m, device=dev)
    pw = torch.zeros((R, P, m), dtype=torch.float64, device=dev)
    pw[..., 0] = 1.0
    for d in range(1, m):
        den = torch.full((1,), d + 1.0, dtype=torch.float64, device=dev)
        live = (d <= n_elem).view(1, P, 1) & (ji <= d)
        a = torch.where(ji < d, zero[None, :, d, None] * pw * (d - jj)
                        / den, 0.0)
        prev = torch.cat([torch.zeros_like(pw[..., :1]), pw[..., :-1]], 2)
        b = o[:, :, d:d + 1] * prev * jj / den
        pw = torch.where(live, a + b, pw)
    # one unwound sum per element, all elements at once
    e = n_elem.view(1, P, 1)
    e1 = (e + 1).double()
    zi = zero[None]
    nz = o != 0
    nop = pw.gather(2, e.expand(R, P, 1)).expand(R, P, m)
    total = torch.zeros_like(pw)
    for j in range(m - 2, -1, -1):
        live = j < e
        pwj = pw[..., j:j + 1]
        ej = (e - j).double()
        tmp = nop * e1 / ((j + 1) * o)
        nop_next = pwj - tmp * zi * ej / e1
        step = torch.where(nz, tmp, pwj / (zi * ej / e1))
        total = torch.where(live, total + step, total)
        nop = torch.where(live & nz, nop_next, nop)
    v = p.path_value[sel].view(1, P, 1)
    contrib = total * (o - zi) * v
    keep = (ji >= 1) & (ji <= e)
    contrib = torch.where(keep, contrib, 0.0)
    return contrib.reshape(R, P * m), feat.reshape(-1)


def _tree_shap_reference(x: torch.Tensor, p: ShapPaths,
                         max_lattice: int = 1 << 22) -> torch.Tensor:
    """The plain version: [N, K, F + 1] float64. Each class's paths are
    taken shortest first, in chunks of similar length, so that no
    [rows, paths, path_len] lattice holds more than ``max_lattice``
    entries (and short paths do not pay for the longest)."""
    N, F = x.shape
    K = p.bias.shape[0]
    phi = torch.zeros((N, K, F + 1), dtype=torch.float64, device=x.device)
    phi[:, :, F] = p.bias
    lens = (p.path_elem_lo[1:] - p.path_elem_lo[:-1]).cpu().numpy() + 1
    # at least 64 of the longest paths a chunk, as many rows as then fit
    rows = max(1, min(N, max_lattice // (int(lens.max(initial=1)) * 64)))
    lo_k = p.class_path_lo.tolist()
    for k in range(K):
        order = lo_k[k] + np.argsort(lens[lo_k[k]:lo_k[k + 1]],
                                     kind="stable")
        acc = torch.zeros((N, F), dtype=torch.float64, device=x.device)
        start = 0
        while start < len(order):
            end = min(len(order), start + max(
                1, max_lattice // (rows * int(lens[order[start]]))))
            while end - start > 1 and \
                    rows * (end - start) * lens[order[end - 1]] > max_lattice:
                end = start + (end - start) // 2
            sel = torch.from_numpy(order[start:end]).to(x.device)
            for r in range(0, N, rows):
                c, feat = _chunk_contrib(x[r:r + rows], p, sel)
                acc[r:r + rows].index_add_(1, feat, c)
            start = end
        phi[:, k, :F] = acc
    return phi


# ---------------------------------------------------------------------------
# the kernel wrapper
# ---------------------------------------------------------------------------
_lib_lock = threading.Lock()
_lib = None


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            from ..utils import cuda_build
            lib = cuda_build.load(TREE_SHAP_SOURCE)
            p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
            lib.lg_tree_shap.argtypes = [
                p, p, p, p, p, p,       # node feat/thr/flags/cat_lo/nw, bits
                p, p, p, p, p,          # class groups, lane path/slot, path
                p, p, p, p,             # elem lo, value; elem feat/zero,
                p, p, p, p, p, p,       # edge lo/codes; long paths/lo; path
                p, i64, i32, i32,       # edge lo, edge node/slot; bias; x,
                                        # rows, features, classes
                i32, i32, i32, i32,     # warps, tile, groups/chunk, chunks
                i32, i32,               # shared bytes, staged
                i32, i64, p,            # long cap, blocks, scratch
                p, p, p]                # workspace, phi, stream
            lib.lg_tree_shap.restype = ctypes.c_int
            _lib = lib
        return _lib


def launch_plan(p: ShapPaths, rows: int, width: int) -> dict:
    """Kernel S's launches for ``rows`` x ``width`` float64 rows: the
    grouped kernel's block (``warps``) and row tile (``tile``, staged in
    ``smem_bytes`` of shared memory with the warps' partials, unless
    ``staged`` is False: one warp and one row a block adding straight into
    its slice), its ``chunks`` (every class's warp groups cut
    ``groups_per_chunk`` at a time), the long-path kernel's cap and
    blocks; the ``passes`` of at most ``pass_rows`` rows (``row_tiles``
    tiles) a batch runs in, a pass's workspace and scratch sizes (doubles)
    and the CUDA launches of the whole call. What orders a row's sums
    (warps, chunks) follows the forest and the width alone, so a row
    gets the same bits in any batch."""
    K = len(p.class_groups) - 1
    G = p.class_groups[-1]
    F = max(width, 1)
    warps = WARPS_PER_BLOCK
    tile = min(TILE_ROWS, SMEM_TARGET // ((warps + 1) * F * 8))
    staged = tile >= 1 or (warps + 1) * F * 8 <= SMEM_MAX
    if not staged:
        warps = 1
    per_chunk = max(1, -(-G // min(MAX_CHUNKS, max(1, -(-G // warps)))))
    counts = np.diff(p.class_groups)
    grouped = int((-(-counts // per_chunk)).sum())
    if grouped > 65535:
        raise ValueError(f"tree_shap: {grouped} path chunks exceed the "
                         "grid's 65,535")
    cap = path_cap(p.max_elems) if p.num_long else 0
    slices = max(1, grouped + (K if cap else 0))
    passes = -(-rows // max(1, min(rows, SCRATCH_BYTES // (slices * F * 8))))
    pass_rows = -(-rows // passes) if passes else 0
    tile = max(1, min(tile, pass_rows))
    long_blocks = 0
    if cap:
        long_warps = min(pass_rows, SCRATCH_BYTES // (WARP * 8 * F))
        long_blocks = max(1, long_warps // LONG_WARPS_PER_BLOCK)
    return {"warps": warps, "tile": tile, "staged": staged,
            "smem_bytes": (warps + 1) * tile * F * 8 if staged else 0,
            "chunks": grouped, "groups_per_chunk": per_chunk,
            "long_cap": cap, "long_blocks": long_blocks,
            "passes": passes, "pass_rows": pass_rows,
            "row_tiles": -(-pass_rows // tile),
            "workspace": (grouped + (K if cap else 0)) * pass_rows * width,
            "scratch": long_blocks * LONG_WARPS_PER_BLOCK * WARP * width,
            "cuda_launches":
                passes * (int(grouped > 0) + int(cap > 0) + 1)}


def _check(x: torch.Tensor, p: ShapPaths) -> None:
    if x.dtype != torch.float64 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError("tree_shap expects contiguous float64 rows [N, F], "
                         f"got {x.dtype} {tuple(x.shape)}")
    for name, a in zip(ShapPaths._fields[:NUM_TABLES], p[:NUM_TABLES]):
        if a.device != x.device:
            raise ValueError(f"tree_shap: table {name} is on {a.device}, "
                             f"rows on {x.device}")
        if not a.is_contiguous():
            raise ValueError(f"tree_shap: table {name} must be contiguous")
    if p.max_feature >= x.shape[1]:
        raise ValueError(f"rows have {x.shape[1]} features but the forest "
                         f"splits on feature {p.max_feature}")


def tree_shap(x: torch.Tensor, p: ShapPaths) -> torch.Tensor:
    """SHAP contributions [N, K, F + 1] float64 of rows ``x`` (float64
    [N, F]) under the forest ``p`` (:func:`to_device` on x's device): per
    class, one column per feature and the expected value last.

    On a CUDA tensor this makes kernel S's launches on the current stream,
    pass by pass (:func:`launch_plan`; raising if one fails, or if a path
    is longer than the long-path kernel's cap) and counts one; on a CPU
    tensor it runs the plain version."""
    if x.device.type == "cpu":
        return _tree_shap_reference(x, p)
    if x.device.type != "cuda":
        raise ValueError(f"tree_shap runs on cuda or cpu, not {x.device}")
    _check(x, p)
    N, F = x.shape
    K = int(p.bias.shape[0])
    plan = launch_plan(p, N, F)
    phi = torch.empty((N, K, F + 1), dtype=torch.float64, device=x.device)
    if N == 0:
        return phi
    ws = torch.empty(plan["workspace"], dtype=torch.float64, device=x.device)
    scratch = torch.empty(plan["scratch"], dtype=torch.float64,
                          device=x.device)
    lib = _kernel_lib()
    tables = [a.data_ptr() for a in (
        p.node_feat, p.node_thr, p.node_flags, p.node_cat_lo, p.node_cat_nw,
        p.cat_bits, p.class_group_lo, p.lane_path, p.lane_slot,
        p.path_elem_lo, p.path_value, p.elem_feat, p.elem_zero,
        p.elem_edge_lo, p.elem_edge, p.long_path, p.class_long_lo,
        p.path_edge_lo, p.edge_node, p.edge_slot, p.bias)]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        for r0 in range(0, N, plan["pass_rows"]):
            n = min(plan["pass_rows"], N - r0)
            rc = lib.lg_tree_shap(
                *tables, x[r0].data_ptr(), n, F, K, plan["warps"],
                plan["tile"], plan["groups_per_chunk"], plan["chunks"],
                plan["smem_bytes"], int(plan["staged"]), plan["long_cap"],
                plan["long_blocks"], scratch.data_ptr(), ws.data_ptr(),
                phi[r0].data_ptr(), stream)
            if rc != 0:
                raise RuntimeError(
                    f"tree_shap kernel launch failed (code {rc})")
    TREE_SHAP_LAUNCHES.add()
    return phi
