"""Compiled-forest traversal engine (``predict_engine=compiled``).

The port of ``lambdagap_tpu/infer/engine.py``: runs the serving-shaped
artifact :mod:`lambdagap_tpu_torch.infer.compile` emits. A dispatch on the
card is ONE launch of a hand-written CUDA kernel (``csrc/traverse.cu``),
wrapper :func:`predict_forest`, which fuses:

- the traversal — the JAX package's Pallas ``_traverse_kernel`` (K3): the
  node carry of every row through every structure group. At upload
  (:func:`device_tables`) each group's nodes are re-laid contiguously as
  16-byte records (threshold decoded from the palette, ``feature << 4 |
  flags``, left, right), and the trees of each group are listed in a CSR
  (``group_tree_lo`` / ``group_tree``, forest order within a group); the
  artifact itself is not touched;
- the forest-order accumulation — the JAX package's ``_leaf_values`` and
  ``lax.scan`` ``_accumulate``, XLA work around the Pallas kernel (A):
  each finished (row, group) writes its trees' leaf values into a
  ``[trees, rows]`` workspace, and once a row tile's walk blocks have all
  arrived, its accumulation blocks (32 rows each, started after every walk
  block) add them in forest order into ``out[tree_class[t]]``, with the
  identical early-stop replay.

K3 alone (:func:`traverse_forest`, one launch) serves ``pred_leaf``; the
accumulation alone (:func:`accumulate_forest`) remains the public function
over a carry, and the pair is the two-launch dispatch of before, kept as a
yardstick; neither is on the serve path.

Bit-exactness contract (the JAX package's): traversal only computes leaf
INDICES — any correct traversal yields the same ones — and the
accumulation adds the trees in the scan oracle's order (``ops/predict.py``
and the JAX package's ``lax.scan``), so the scores are the oracle's bits.
``sum``/``cumsum``/``index_add_`` over the tree axis would add in another
order and are not used.

On a CUDA tensor each wrapper launches its kernel or raises; only a CPU
tensor takes the plain version (:func:`_predict_forest_reference`: the
records walk, the workspace through the CSR, :func:`_accumulate`;
:func:`_traverse_all_reference`, block by block like the JAX package's
``_traverse_all``; :func:`_leaf_values` + :func:`_accumulate`, ~T small
torch ops).

A linear forest (``linear_tree``; the artifact's ``leaf_const``,
``leaf_feat`` and ``leaf_coeff`` tables) launches the same fused kernel in
its linear mode: each (tree, row) value is the leaf's linear model over the
row, ``ops/linear.linear_leaf_values`` (the plain version) bit for bit, in
the solo and the packed launch alike.

:class:`PackedForests` extends the bucket idea ACROSS models (the JAX
package's ``PackedForests`` and ``_predict_packed``): many compiled forests
merged into one set of tables (:func:`pack_buffers`), whose dispatch is
ONE launch of the same fused kernel in its packed mode — each row carries
its member index (``row_model``), each structure group its owner
(``group_model``), and a (row, group) of two different members does not
walk: it writes ``+0.0`` for the group's trees, so the forest-order sums of
a row are bit for bit its member's served alone.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.linear import linear_leaf_values
from ..ops.predict import (K_ZERO_THRESHOLD, MT_NAN, MT_ZERO, category_of,
                           cat_go_left, margin_of)
from .compile import (FLAG_CATEGORICAL, FLAG_DEFAULT_LEFT, FLAG_MT_SHIFT,
                      ForestArtifact)

TRAVERSE_SOURCE = "traverse.cu"
# feature ids share a record word with the 4 flag bits
MAX_WIDTH = 1 << 28


class LaunchCounter:
    """A plain count of kernel launches, thread-safe (serve workers launch
    concurrently). The wrapper adds one where it launches its kernel and
    nowhere else, so a run can show the main path went through it:
    ``PREDICT_LAUNCHES`` (the fused dispatch, :func:`predict_forest`),
    ``TRAVERSE_LAUNCHES`` (K3 alone, :func:`traverse_forest`) and
    ``ACCUMULATE_LAUNCHES`` (the accumulation alone,
    :func:`accumulate_forest`)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.launches = 0

    def add(self) -> None:
        with self._lock:
            self.launches += 1

    def reset(self) -> None:
        with self._lock:
            self.launches = 0


PREDICT_LAUNCHES = LaunchCounter()
TRAVERSE_LAUNCHES = LaunchCounter()
ACCUMULATE_LAUNCHES = LaunchCounter()


class LinearLeaves(NamedTuple):
    """A linear forest's leaf tables on one device (the fused kernel's
    linear mode): ``leaf_const`` f32 [T, L], ``leaf_feat`` int32 [T, L,
    FL] (-1 on padding slots, packed from slot 0) and ``leaf_coeff`` f32
    [T, L, FL]."""
    leaf_const: torch.Tensor
    leaf_feat: torch.Tensor
    leaf_coeff: torch.Tensor


def _upload_linear(b: Dict[str, np.ndarray], leaf_value: torch.Tensor,
                   width: int) -> Optional[LinearLeaves]:
    """The buffers' linear tables beside ``leaf_value`` on its device,
    checked once (:func:`_check_linear`), or None for a constant
    forest."""
    if "leaf_const" not in b:
        return None
    lin = LinearLeaves(*(
        torch.from_numpy(np.ascontiguousarray(b[k], dt)).to(leaf_value.device)
        for k, dt in (("leaf_const", np.float32), ("leaf_feat", np.int32),
                      ("leaf_coeff", np.float32))))
    _check_linear(lin, leaf_value, width, leaf_value.device)
    return lin


class ForestTables(NamedTuple):
    """An artifact's node tables on one device.

    The narrow tables are the artifact's, block-major as compiled (u8/u16/
    u32 palette codes kept); the plain version walks them through the host
    block directory. The kernel reads ``rec``: every node as one 16-byte
    record, each structure group's nodes contiguous in breadth-first order
    with group-local child ids (leaf entries ``~leaf`` unchanged), indexed
    by ``group_node_lo``; and the inverse of ``group_of_tree``: group g's
    trees are ``group_tree[group_tree_lo[g]:group_tree_lo[g + 1]]``, in
    forest order."""
    feat: torch.Tensor           # u16/u32 [n]
    thr: torch.Tensor            # u8/u16/u32 [n] palette code into thr_tab
    flags: torch.Tensor          # u8 [n]
    catc: torch.Tensor           # u8/u16/u32 [n] row of cat_tab
    left: torch.Tensor           # i32 [n] block-local child id or ~leaf
    right: torch.Tensor          # i32 [n]
    thr_tab: torch.Tensor        # f32 [U]
    cat_tab: torch.Tensor        # u32 [C, W]
    root: torch.Tensor           # i32 [G] block-local root id or ~leaf
    rec: torch.Tensor            # i32 [n, 4] thr bits | cat row,
    #                              feature << 4 | flags, left, right
    group_node_lo: torch.Tensor  # i32 [G + 1] first record of each group
    group_root: torch.Tensor     # i32 [G] 0, or ~leaf for a stump
    group_steps: torch.Tensor    # i32 [G] levels of the group's own tree
    group_tree_lo: torch.Tensor  # i32 [G + 1] CSR of each group's trees
    group_tree: torch.Tensor     # i32 [T]
    block_node_lo: Tuple[int, ...]
    block_group_lo: Tuple[int, ...]
    depths: Tuple[int, ...]
    width: int                   # 1 + max split feature

    def artifact_tables(self) -> Tuple[torch.Tensor, ...]:
        """The artifact's own node tables (not the records repacked from
        them): what a traversal must read at least once."""
        return (self.feat, self.thr, self.flags, self.catc, self.left,
                self.right, self.thr_tab, self.cat_tab, self.root)


def node_records(b: Dict[str, np.ndarray]) -> Tuple[np.ndarray, ...]:
    """Re-lay an artifact's block-major, level-major node tables group by
    group: ``(rec [n, 4] int32, group_node_lo [G + 1], group_root [G],
    group_steps [G])``.

    A group's nodes keep their breadth-first order (the block's level-major
    order restricted to the group), so its root is local id 0. The record
    holds the f32 threshold bits decoded from ``thr_table`` (a categorical
    node: its ``cat_table`` row instead), ``feature << 4 | flags`` and the
    group-local children."""
    lo = np.asarray(b["block_node_lo"], np.int64)
    glo = np.asarray(b["block_group_lo"], np.int64)
    root = np.asarray(b["root"], np.int64)
    left = np.asarray(b["node_left"], np.int64)
    right = np.asarray(b["node_right"], np.int64)
    n, G = left.shape[0], root.shape[0]
    base = np.repeat(lo[:-1], np.diff(lo))              # block of each node
    gbase = np.repeat(lo[:-1], np.diff(glo))            # block of each group
    lchild = np.where(left >= 0, left + base, -1)       # global old ids
    rchild = np.where(right >= 0, right + base, -1)
    owner = np.full(n, -1, np.int64)
    level = np.zeros(n, np.int64)
    has_root = np.nonzero(root >= 0)[0]
    frontier = root[has_root] + gbase[has_root]
    owner[frontier] = has_root
    d = 0
    while frontier.size:
        level[frontier] = d
        kids = np.concatenate([lchild[frontier], rchild[frontier]])
        own = np.concatenate([owner[frontier], owner[frontier]])
        keep = kids >= 0
        owner[kids[keep]] = own[keep]
        frontier = kids[keep]
        d += 1
    if (owner < 0).any():
        raise ValueError("artifact holds nodes no group's root reaches")
    order = np.argsort(owner, kind="stable")            # new -> old
    new_of_old = np.empty(n, np.int64)
    new_of_old[order] = np.arange(n)
    counts = np.bincount(owner, minlength=G)
    group_node_lo = np.concatenate([[0], np.cumsum(counts)])
    local = new_of_old - group_node_lo[owner]
    lc = np.where(left >= 0, local[np.maximum(lchild, 0)], left)
    rc = np.where(right >= 0, local[np.maximum(rchild, 0)], right)
    steps = np.zeros(G, np.int64)
    np.maximum.at(steps, owner, level + 1)

    flags = np.asarray(b["node_flags"], np.int64)
    thr_bits = np.asarray(b["thr_table"], np.float32).view(np.int32)
    is_cat = (flags & FLAG_CATEGORICAL) != 0
    word0 = np.where(is_cat, np.asarray(b["node_cat"], np.int64),
                     thr_bits[np.asarray(b["node_thr"], np.int64)])
    word1 = (np.asarray(b["node_feat"], np.int64) << 4) | flags
    rec = np.stack([word0, word1, lc, rc], axis=1)[order]
    rec = rec.astype(np.uint32).view(np.int32)          # two's complement
    group_root = np.where(counts > 0, 0, root)
    return (np.ascontiguousarray(rec), group_node_lo.astype(np.int32),
            group_root.astype(np.int32), steps.astype(np.int32))


def group_trees(group_of_tree: np.ndarray,
                groups: int) -> Tuple[np.ndarray, np.ndarray]:
    """The inverse of ``group_of_tree`` as a CSR, ``(group_tree_lo [G + 1],
    group_tree [T])`` int32: group g's trees in forest order. Every tree
    appears once; a group of no tree is empty. Raises ValueError for a
    tree mapped outside ``[0, groups)``."""
    gof = np.asarray(group_of_tree, np.int64)
    if gof.size and (gof.min() < 0 or gof.max() >= groups):
        raise ValueError(f"group_of_tree holds groups {gof.min()}.."
                         f"{gof.max()}; the forest has {groups}")
    lo = np.concatenate([[0], np.cumsum(np.bincount(gof, minlength=groups))])
    return (lo.astype(np.int32),
            np.argsort(gof, kind="stable").astype(np.int32))


def device_tables(artifact: ForestArtifact,
                  device: torch.device) -> ForestTables:
    """Upload an artifact's node tables once (the analog of the JAX
    package's ``_device_blocks``), with the kernel's node records and the
    CSR of each group's trees beside them."""
    return _upload_tables(artifact.buffers, int(artifact.meta["width"]),
                          device)


def _upload_tables(b: Dict[str, np.ndarray], width: int,
                   device: torch.device) -> ForestTables:
    """:func:`device_tables` of an artifact's buffers (or of
    :func:`pack_buffers`' merge of several) read at ``width`` features."""
    if width >= MAX_WIDTH:
        raise NotImplementedError(
            f"the traversal kernel packs feature ids into 28 bits; this "
            f"forest reads {width} features")
    rec, gnl, groot, gsteps = node_records(b)
    gtl, gt = group_trees(b["group_of_tree"], groot.shape[0])

    def up(a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return ForestTables(
        feat=up(b["node_feat"]), thr=up(b["node_thr"]),
        flags=up(b["node_flags"]), catc=up(b["node_cat"]),
        left=up(b["node_left"]), right=up(b["node_right"]),
        thr_tab=up(np.asarray(b["thr_table"], np.float32)),
        cat_tab=up(np.asarray(b["cat_table"], np.uint32)),
        root=up(b["root"]), rec=up(rec), group_node_lo=up(gnl),
        group_root=up(groot), group_steps=up(gsteps),
        group_tree_lo=up(gtl), group_tree=up(gt),
        block_node_lo=tuple(int(v) for v in np.asarray(b["block_node_lo"])),
        block_group_lo=tuple(int(v) for v in
                             np.asarray(b["block_group_lo"])),
        depths=tuple(int(d) for d in np.asarray(b["block_depth"])),
        width=width)


def _narrowest(n_codes: int):
    """The smallest unsigned dtype indexing ``n_codes`` palette rows."""
    for dt in (np.uint8, np.uint16):
        if n_codes <= np.iinfo(dt).max + 1:
            return dt
    return np.uint32


def _pack_linear(buffers: Sequence[Dict[str, np.ndarray]], L: int
                 ) -> Dict[str, np.ndarray]:
    """The members' linear tables padded to the pack's (L, FL) and stacked
    along the tree axis, as the JAX package's ``_pack_leaf_tables``
    (``infer/engine.py:432-470``): FL is the widest linear member's; a
    constant member carries ``leaf_const == leaf_value`` and every slot
    ``-1``; extra slots are ``-1`` with coefficient 0, extra leaf rows are
    never selected."""
    FL = max(np.asarray(b["leaf_feat"]).shape[-1] for b in buffers
             if "leaf_const" in b)
    out = {"leaf_const": [], "leaf_feat": [], "leaf_coeff": []}
    for b in buffers:
        lv = np.asarray(b["leaf_value"], np.float32)
        T, Li = lv.shape
        if "leaf_const" in b:
            lc = np.asarray(b["leaf_const"], np.float32)
            lf = np.asarray(b["leaf_feat"], np.int32)
            lcf = np.asarray(b["leaf_coeff"], np.float32)
        else:
            lc = lv.copy()
            lf = np.full((T, Li, 1), -1, np.int32)
            lcf = np.zeros((T, Li, 1), np.float32)
        pad = ((0, 0), (0, L - Li), (0, FL - lf.shape[-1]))
        out["leaf_const"].append(np.pad(lc, pad[:2]))
        out["leaf_feat"].append(np.pad(lf, pad, constant_values=-1))
        out["leaf_coeff"].append(np.pad(lcf, pad))
    return {k: np.concatenate(v) for k, v in out.items()}


def pack_buffers(buffers: Sequence[Dict[str, np.ndarray]]
                 ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """Merge several artifacts' buffers into the buffers of one forest, and
    the member of each of its structure groups.

    Node blocks concatenate unchanged (their child ids are block-local);
    the block directory, ``group_of_tree`` and the palette codes shift by
    the members before; the palettes concatenate (bitset rows zero-padded
    to the widest member's words: an extra word's bits are all clear, the
    member's own answer for a category past its words); leaf tables pad
    to the widest member's leaf count, rows a member's trees never select.
    When a member has linear leaves, the pack carries linear tables
    (:func:`_pack_linear`). Returns ``(buffers, group_model [G] int32)``."""
    if not buffers:
        raise ValueError("pack_buffers needs at least one member")
    W = max(int(np.asarray(b["cat_table"]).shape[1]) for b in buffers)
    L = max(int(np.asarray(b["leaf_value"]).shape[1]) for b in buffers)
    out = {k: [] for k in ("node_feat", "node_thr", "node_flags", "node_cat",
                           "node_left", "node_right", "thr_table",
                           "cat_table", "root", "group_of_tree",
                           "tree_class", "block_depth", "leaf_value")}
    node_lo, group_lo, group_model = [0], [0], []
    n_thr = n_cat = n_nodes = n_groups = 0
    for mi, b in enumerate(buffers):
        G = int(np.asarray(b["root"]).shape[0])
        cat = np.asarray(b["cat_table"], np.uint32)
        lv = np.asarray(b["leaf_value"], np.float32)
        out["node_feat"].append(np.asarray(b["node_feat"], np.uint32))
        out["node_thr"].append(np.asarray(b["node_thr"], np.int64) + n_thr)
        out["node_cat"].append(np.asarray(b["node_cat"], np.int64) + n_cat)
        for k in ("node_flags", "node_left", "node_right", "root",
                  "tree_class", "block_depth"):
            out[k].append(np.asarray(b[k]))
        out["thr_table"].append(np.asarray(b["thr_table"], np.float32))
        out["cat_table"].append(np.pad(cat, ((0, 0), (0, W - cat.shape[1]))))
        out["group_of_tree"].append(
            np.asarray(b["group_of_tree"], np.int64) + n_groups)
        out["leaf_value"].append(np.pad(lv, ((0, 0), (0, L - lv.shape[1]))))
        node_lo += [v + n_nodes for v in
                    np.asarray(b["block_node_lo"], np.int64)[1:].tolist()]
        group_lo += [v + n_groups for v in
                     np.asarray(b["block_group_lo"], np.int64)[1:].tolist()]
        group_model.append(np.full(G, mi, np.int32))
        n_thr += len(out["thr_table"][-1])
        n_cat += cat.shape[0]
        n_nodes += len(out["node_left"][-1])
        n_groups += G
    cat_all = np.concatenate(out.pop("cat_table"))
    merged = {k: np.concatenate(v) for k, v in out.items()}
    feat = merged["node_feat"]
    merged["node_feat"] = feat.astype(
        np.uint16 if feat.size == 0 or feat.max() < 65536 else np.uint32)
    merged["node_thr"] = merged["node_thr"].astype(_narrowest(n_thr))
    merged["node_cat"] = merged["node_cat"].astype(_narrowest(n_cat))
    merged["cat_table"] = cat_all
    for k, dt in (("node_flags", np.uint8), ("node_left", np.int32),
                  ("node_right", np.int32), ("root", np.int32),
                  ("group_of_tree", np.int32), ("tree_class", np.int32),
                  ("block_depth", np.int32)):
        merged[k] = merged[k].astype(dt)
    merged["block_node_lo"] = np.asarray(node_lo, np.int32)
    merged["block_group_lo"] = np.asarray(group_lo, np.int32)
    if any("leaf_const" in b for b in buffers):
        merged.update(_pack_linear(buffers, L))
    return merged, np.concatenate(group_model)


# ---------------------------------------------------------------------------
# the plain versions of the traversal
# ---------------------------------------------------------------------------
def _decide(x: torch.Tensor, f, fl, thr, catc, cat_bits) -> torch.Tensor:
    """Go-left of every (row, group) at nodes of feature ``f``, flags
    ``fl``, f32 threshold ``thr`` and bitset row ``catc`` (all [R, G]
    int64/f32): the decision math of the JAX package's
    ``_traverse_kernel``, decision for decision."""
    dl = (fl & FLAG_DEFAULT_LEFT) != 0
    mt = (fl >> FLAG_MT_SHIFT) & 3
    is_cat = (fl & FLAG_CATEGORICAL) != 0
    v = torch.gather(x, 1, f)
    nan = torch.isnan(v)
    # NaN converted to 0 unless NaN-missing
    # (reference: tree.h NumericalDecision)
    v0 = torch.where(nan & (mt != MT_NAN), 0.0, v)
    missing = ((mt == MT_NAN) & nan) | \
              ((mt == MT_ZERO) & (v0.abs() <= K_ZERO_THRESHOLD))
    go_num = torch.where(missing, dl, v0 <= thr)
    go_cat = cat_go_left(category_of(v), cat_bits[catc],
                         cat_bits.shape[1] * 32)
    return torch.where(is_cat, go_cat, go_num)


def _traverse_block_reference(x: torch.Tensor, feat, thr, flags, catc, left,
                              right, thr_tab, cat_tab, root,
                              depth: int) -> torch.Tensor:
    """Carry every row through every structure group of ONE node block ->
    [R, Gb] int32, in plain torch ops. Narrow codes and bitset words are
    widened to int64 first (torch cannot index with u16 nor shift u32 on
    the CPU)."""
    R = x.shape[0]
    feat, thr, catc = feat.long(), thr.long(), catc.long()
    flags = flags.long()
    left, right = left.long(), right.long()
    cat_bits = cat_tab.long()                          # [C, W]
    node = root.long()[None, :].expand(R, -1)          # [R, Gb]
    for _ in range(depth):
        idx = node.clamp(min=0)
        go = _decide(x, feat[idx], flags[idx], thr_tab[thr[idx]], catc[idx],
                     cat_bits)
        nxt = torch.where(go, left[idx], right[idx])
        node = torch.where(node < 0, node, nxt)
    return node.to(torch.int32)


def _traverse_all_reference(x: torch.Tensor,
                            t: ForestTables) -> torch.Tensor:
    """Every node block over every row -> [R, G] node carry (blocks hold
    contiguous group ranges, so concatenation restores group order)."""
    outs = []
    for i, depth in enumerate(t.depths):
        s = slice(t.block_node_lo[i], t.block_node_lo[i + 1])
        g = slice(t.block_group_lo[i], t.block_group_lo[i + 1])
        outs.append(_traverse_block_reference(
            x, t.feat[s], t.thr[s], t.flags[s], t.catc[s], t.left[s],
            t.right[s], t.thr_tab, t.cat_tab, t.root[g], depth))
    return torch.cat(outs, dim=1)


def _traverse_records_reference(x: torch.Tensor,
                                t: ForestTables) -> torch.Tensor:
    """The kernel's walk in plain torch ops: every group at once through
    the group-contiguous 16-byte records -> [R, G] node carry (the same
    carry as :func:`_traverse_all_reference`)."""
    R, G = x.shape[0], t.group_root.shape[0]
    rec = t.rec.long()
    word1 = rec[:, 1] & 0xFFFFFFFF                     # feature << 4 | flags
    fl = word1 & 15
    thr = t.rec[:, 0].contiguous().view(torch.float32)
    catc = torch.where((fl & FLAG_CATEGORICAL) != 0, rec[:, 0], 0)
    lo = t.group_node_lo.long()[:-1][None, :]          # [1, G]
    steps = t.group_steps.long()[None, :]
    cat_bits = t.cat_tab.long()
    node = t.group_root.long()[None, :].expand(R, G)
    for d in range(int(t.group_steps.max()) if G else 0):
        # a stump group has no records: its index is clamped, never used
        idx = (lo + node.clamp(min=0)).clamp(max=rec.shape[0] - 1)
        go = _decide(x, word1[idx] >> 4, fl[idx], thr[idx], catc[idx],
                     cat_bits)
        nxt = torch.where(go, rec[idx, 2], rec[idx, 3])
        node = torch.where((node < 0) | (steps <= d), node, nxt)
    return node.to(torch.int32)


# ---------------------------------------------------------------------------
# leaf gather + forest-order accumulation: the plain versions
# ---------------------------------------------------------------------------
def _leaf_values(node: torch.Tensor, group_of_tree: torch.Tensor,
                 leaf_value: torch.Tensor) -> torch.Tensor:
    """[R, G] group node carry -> [R, T] per-tree leaf values, through the
    flattened ``forest_to_arrays`` leaf table the artifact carries."""
    nodeT = node.long()[:, group_of_tree.long()]       # [R, T]
    done = nodeT < 0
    leaf_idx = torch.where(done, ~nodeT, 0)
    T, L = leaf_value.shape
    idx = (torch.arange(T, device=node.device) * L)[None, :] + leaf_idx
    vals = leaf_value.reshape(-1)[idx]
    return torch.where(done, vals, 0.0)


def _accumulate(vals: torch.Tensor, tree_class: Sequence[int],
                num_class: int, early_stop_freq: int,
                early_stop_margin: float) -> torch.Tensor:
    """Forest-order accumulation -> [num_class, R] f32: one add per tree
    into ``out[tree_class[t]]``, the early-stop replay included, so the
    f32 addition order (and therefore the bits) matches the scan
    oracle."""
    valsT = vals.T.contiguous()                        # [T, R]
    R = valsT.shape[1]
    out = torch.zeros((num_class, R), dtype=torch.float32,
                      device=vals.device)
    stopped = torch.zeros(R, dtype=torch.bool, device=vals.device)
    for i, k in enumerate(tree_class):
        if early_stop_freq <= 0:
            out[k] += valsT[i]
            continue
        out[k] += torch.where(stopped, 0.0, valsT[i])
        if (i + 1) % early_stop_freq == 0:
            stopped |= margin_of(out) > early_stop_margin
    return out


def _predict_forest_reference(x: torch.Tensor, t: ForestTables,
                              group_tree_lo: torch.Tensor,
                              group_tree: torch.Tensor,
                              leaf_value: torch.Tensor,
                              tree_class: torch.Tensor, num_class: int,
                              early_stop_freq: int,
                              early_stop_margin: float,
                              row_model: Optional[torch.Tensor] = None,
                              group_model: Optional[torch.Tensor] = None,
                              linear: Optional[LinearLeaves] = None
                              ) -> torch.Tensor:
    """The fused kernel's phases in plain torch ops -> [num_class, R] f32:
    the records walk (:func:`_traverse_records_reference`), each group's
    trees' leaf values into the ``[T, R]`` workspace through the CSR (+0.0
    for a carry that is not ``~leaf``), then :func:`_accumulate`. Packed
    (``row_model`` [R] / ``group_model`` [G]): a (row, group) of two
    members carries 0, so its trees add +0.0. Linear (``linear``): each
    value is :func:`~lambdagap_tpu_torch.ops.linear.linear_leaf_values`
    over the row."""
    node = _traverse_records_reference(x, t).long()    # [R, G]
    if row_model is not None:
        own = group_model.long()[None, :] == row_model.long()[:, None]
        node = torch.where(own, node, 0)
    T, L = leaf_value.shape
    lo = group_tree_lo.long()
    owner = torch.repeat_interleave(
        torch.arange(lo.shape[0] - 1, device=x.device), lo.diff())
    trees = group_tree.long()
    nodeT = node[:, owner].T                           # [T, R] by CSR slot
    done = nodeT < 0
    leaf = torch.where(done, ~nodeT, 0)
    if linear is None:
        vals = leaf_value[trees[:, None], leaf]
    else:
        FL = linear.leaf_feat.shape[-1]
        vals = linear_leaf_values(
            x, (trees[:, None] * L + leaf).T, leaf_value.reshape(-1),
            linear.leaf_const.reshape(-1),
            linear.leaf_feat.reshape(-1, FL),
            linear.leaf_coeff.reshape(-1, FL)).T
    ws = torch.empty((T, x.shape[0]), dtype=torch.float32, device=x.device)
    ws[trees] = torch.where(done, vals, 0.0)
    return _accumulate(ws.T, tree_class.tolist(), num_class,
                       early_stop_freq, early_stop_margin)


# ---------------------------------------------------------------------------
# the kernel wrappers
# ---------------------------------------------------------------------------
_lib_lock = threading.Lock()
_lib = None
_ready_devices: set = set()


def _kernel_lib(dev: torch.device) -> ctypes.CDLL:
    """The built ``traverse.cu`` library with every argtype declared
    (pointers as c_void_p so ctypes never truncates them), its kernels'
    shared-memory limit raised on ``dev`` (once per device)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            from ..utils import cuda_build
            lib = cuda_build.load(TRAVERSE_SOURCE)
            p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
            lib.lg_traverse_setup.argtypes = []
            lib.lg_traverse_setup.restype = ctypes.c_int
            lib.lg_traverse_forest.argtypes = [
                p, i64, i64, i32,       # x, rows, x_stride, width
                p, p, p, p, i64,        # rec, group_node_lo, root, steps, G
                p, i32,                 # cat_tab, cat_words
                p, p]                   # out [G, R], stream
            lib.lg_traverse_forest.restype = ctypes.c_int
            lib.lg_accumulate_forest.argtypes = [
                p, i64, i64, i64,       # carry, rows, row / group strides
                p, p, i64,              # group_of_tree, leaf_value, leaves
                p, i64, i32,            # tree_class, trees, num_class
                i32, ctypes.c_float,    # early-stop freq, margin
                p, p]                   # out [K, R], stream
            lib.lg_accumulate_forest.restype = ctypes.c_int
            lib.lg_predict_forest.argtypes = [
                p, i64, i64, i32,       # x, rows, x_stride, width
                p, p, p, p, i64,        # rec, group_node_lo, root, steps, G
                p, i32,                 # cat_tab, cat_words
                p, p, p, i64,           # group_tree_lo, group_tree,
                #                         leaf_value, leaves
                p, p, p, i32,           # leaf_const, leaf_feat, leaf_coeff,
                #                         feats (or null, null, null, 0)
                p, i64, i32,            # tree_class, trees, num_class
                i32, ctypes.c_float,    # early-stop freq, margin
                p, p,                   # row_model, group_model (or null)
                p, i64,                 # ws, its row stride
                p, p, p]                # counters, out, stream
            lib.lg_predict_forest.restype = ctypes.c_int
            _lib = lib
        if dev.index not in _ready_devices:
            with torch.cuda.device(dev):
                max_smem = _lib.lg_traverse_setup()
            if max_smem <= 0:
                raise RuntimeError(f"{TRAVERSE_SOURCE}: shared-memory setup "
                                   f"failed (code {-max_smem})")
            _ready_devices.add(dev.index)
        return _lib


def _check_tables(x: torch.Tensor, t: ForestTables,
                  who: str = "traverse_forest") -> None:
    for name in ("rec", "group_node_lo", "group_root", "group_steps",
                 "cat_tab"):
        a = getattr(t, name)
        if a.device != x.device:
            raise ValueError(f"{who}: table {name} is on {a.device}, rows "
                             f"on {x.device}")
        if not a.is_contiguous():
            raise ValueError(f"{who}: table {name} must be contiguous")
        want = torch.uint32 if name == "cat_tab" else torch.int32
        if a.dtype != want:
            raise TypeError(f"table {name} must be {want}, got {a.dtype}")
    if t.rec.dim() != 2 or t.rec.shape[1] != 4:
        raise ValueError(f"node records must be [n, 4], got "
                         f"{tuple(t.rec.shape)}")
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"{who} expects contiguous f32 rows [R, F], got "
                         f"{x.dtype} {tuple(x.shape)}")
    if x.shape[1] < t.width:
        raise ValueError(f"rows have {x.shape[1]} features but the forest "
                         f"reads feature {t.width - 1}")


def traverse_forest(x: torch.Tensor, t: ForestTables) -> torch.Tensor:
    """Node carry of every row through every structure group: [R, G]
    int32, each live entry ``~leaf``.

    On a CUDA tensor this launches the hand-written kernel once (every
    group in one launch) on the current stream and raises if the launch
    fails. The carry is written group-major and returned as its ``[R, G]``
    view. The caller keeps ``x`` and ``t`` alive until it has read the
    result. On a CPU tensor it runs the plain version."""
    if x.device.type == "cpu":
        return _traverse_all_reference(x, t)
    if x.device.type != "cuda":
        raise ValueError(f"traverse_forest runs on cuda or cpu, "
                         f"not {x.device}")
    _check_tables(x, t)
    R, F = x.shape
    G = int(t.group_root.shape[0])
    out = torch.empty((G, R), dtype=torch.int32, device=x.device)
    if R == 0 or G == 0:
        return out.t()
    lib = _kernel_lib(x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.lg_traverse_forest(
            x.data_ptr(), R, F, t.width, t.rec.data_ptr(),
            t.group_node_lo.data_ptr(), t.group_root.data_ptr(),
            t.group_steps.data_ptr(), G, t.cat_tab.data_ptr(),
            int(t.cat_tab.shape[1]), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"traverse kernel launch failed (code {rc})")
    TRAVERSE_LAUNCHES.add()
    return out.t()


def _check_maps(group_of_tree: torch.Tensor, tree_class: torch.Tensor,
                groups: int, num_class: int) -> None:
    """Refuse maps that send a tree to a group past ``groups`` or a class
    past ``num_class``: the kernel would read (and, for several classes,
    write) out of bounds. Reads the maps' extremes on the host, so a
    device map costs one synchronization."""
    if group_of_tree.numel() == 0:
        return
    g_lo, g_hi = torch.aminmax(group_of_tree)
    c_lo, c_hi = torch.aminmax(tree_class)
    g_lo, g_hi, c_lo, c_hi = torch.stack([g_lo, g_hi, c_lo, c_hi]).tolist()
    if g_lo < 0 or g_hi >= groups:
        raise ValueError(f"group_of_tree holds groups {g_lo}..{g_hi}; the "
                         f"carry has {groups}")
    if c_lo < 0 or c_hi >= num_class:
        raise ValueError(f"tree_class holds classes {c_lo}..{c_hi}; the "
                         f"forest has {num_class}")


def accumulate_forest(carry: torch.Tensor, group_of_tree: torch.Tensor,
                      leaf_value: torch.Tensor, tree_class: torch.Tensor,
                      num_class: int, early_stop_freq: int,
                      early_stop_margin: float) -> torch.Tensor:
    """Raw scores [num_class, R] f32 from the [R, G] node carry: tree t's
    leaf value ``leaf_value[t, ~carry[r, group_of_tree[t]]]`` added in
    forest order into ``out[tree_class[t]]``, with the early-stop replay,
    bit for bit what :func:`_leaf_values` + :func:`_accumulate` compute.

    ``group_of_tree`` and ``tree_class`` are int32 [T] on the carry's
    device; values outside ``[0, G)`` and ``[0, num_class)`` raise
    ValueError (one host read of the maps' extremes; ``CompiledForest``
    checks its maps once at upload instead). On a CUDA tensor this launches
    the hand-written kernel once (any carry strides: the traversal's
    group-major view reads coalesced) and raises if the launch fails; on a
    CPU tensor it runs the plain version."""
    for name, a, dt in (("carry", carry, torch.int32),
                        ("group_of_tree", group_of_tree, torch.int32),
                        ("leaf_value", leaf_value, torch.float32),
                        ("tree_class", tree_class, torch.int32)):
        if a.device != carry.device:
            raise ValueError(f"accumulate_forest: {name} is on {a.device}, "
                             f"the carry on {carry.device}")
        if a.dtype != dt:
            raise TypeError(f"accumulate_forest: {name} must be {dt}, got "
                            f"{a.dtype}")
    T = group_of_tree.shape[0]
    if carry.dim() != 2 or leaf_value.dim() != 2 or \
            leaf_value.shape[0] != T or tree_class.shape != (T,) or \
            not (leaf_value.is_contiguous() and group_of_tree.is_contiguous()
                 and tree_class.is_contiguous()):
        raise ValueError("accumulate_forest expects a 2-D carry and "
                         "contiguous [T] maps and [T, L] leaf values, got "
                         f"{tuple(carry.shape)}, {tuple(group_of_tree.shape)}"
                         f", {tuple(leaf_value.shape)}, "
                         f"{tuple(tree_class.shape)}")
    if num_class < 1:
        raise ValueError(f"num_class must be >= 1, got {num_class}")
    if carry.device.type not in ("cpu", "cuda"):
        raise ValueError(f"accumulate_forest runs on cuda or cpu, "
                         f"not {carry.device}")
    _check_maps(group_of_tree, tree_class, carry.shape[1], num_class)
    return _accumulate_forest(carry, group_of_tree, leaf_value, tree_class,
                              num_class, early_stop_freq, early_stop_margin)


def _accumulate_forest(carry: torch.Tensor, group_of_tree: torch.Tensor,
                       leaf_value: torch.Tensor, tree_class: torch.Tensor,
                       num_class: int, early_stop_freq: int,
                       early_stop_margin: float) -> torch.Tensor:
    """:func:`accumulate_forest` on arguments already checked: the plain
    version on a CPU carry, else one launch of the kernel."""
    if carry.device.type == "cpu":
        vals = _leaf_values(carry, group_of_tree, leaf_value)
        return _accumulate(vals, tree_class.tolist(), num_class,
                           early_stop_freq, early_stop_margin)
    if carry.device.type != "cuda":
        raise ValueError(f"accumulate_forest runs on cuda or cpu, "
                         f"not {carry.device}")
    R = carry.shape[0]
    out = torch.empty((num_class, R), dtype=torch.float32,
                      device=carry.device)
    if R == 0:
        return out
    lib = _kernel_lib(carry.device)
    with torch.cuda.device(carry.device):
        stream = torch.cuda.current_stream(carry.device).cuda_stream
        rc = lib.lg_accumulate_forest(
            carry.data_ptr(), R, carry.stride(0), carry.stride(1),
            group_of_tree.data_ptr(), leaf_value.data_ptr(),
            leaf_value.shape[1], tree_class.data_ptr(),
            group_of_tree.shape[0], num_class, max(int(early_stop_freq), 0),
            float(np.float32(early_stop_margin)), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"accumulate kernel launch failed (code {rc})")
    ACCUMULATE_LAUNCHES.add()
    return out


# The fused kernel's counters (its block ticket, and per row tile the walk
# blocks arrived and the accumulation blocks finished), one buffer per
# (device, stream): zeroed once at allocation, left zeroed by every launch
# that ran, grown only when a batch has more row tiles. Launches on one
# stream run in order, so they share a buffer; launches that can overlap
# never do.
_counters_lock = threading.Lock()
_counters: Dict[Tuple[int, int], torch.Tensor] = {}
ROW_TILE = 256          # rows of a block of the fused kernel (kBlockRows)


def _fused_counters(dev: torch.device, stream: int,
                    rows: int) -> torch.Tensor:
    need = 1 + 2 * ((rows + ROW_TILE - 1) // ROW_TILE)
    key = (dev.index, stream)
    with _counters_lock:
        buf = _counters.get(key)
        if buf is None or buf.numel() < need:
            n = max(need, 2 * buf.numel() if buf is not None else 64)
            buf = torch.zeros(n, dtype=torch.int32, device=dev)
            _counters[key] = buf
        return buf


def _check_csr(group_tree_lo: torch.Tensor, group_tree: torch.Tensor,
               groups: int, trees: int) -> None:
    """Refuse a CSR that is not every tree exactly once over ``groups``
    groups: the kernel would write the workspace out of bounds or leave a
    tree's row of it unwritten. One host read of the two maps."""
    lo = group_tree_lo.cpu().long()
    gt = group_tree.cpu().long()
    if lo.shape != (groups + 1,) or gt.shape != (trees,) or \
            int(lo[0]) != 0 or int(lo[-1]) != trees or \
            bool((lo.diff() < 0).any()):
        raise ValueError(f"group_tree_lo must rise from 0 to {trees} over "
                         f"{groups} groups, got {lo.tolist()[:8]}...")
    if not torch.equal(torch.sort(gt).values, torch.arange(trees)):
        raise ValueError("group_tree must list every tree exactly once")


def _check_packed(row_model: torch.Tensor, group_model: torch.Tensor,
                  rows: int, groups: int, device: torch.device) -> None:
    """Refuse packed maps that are not int32 [rows] / [groups] on the
    rows' device, or hold a member outside ``[0, members)`` (members: one
    past the largest ``group_model``). One host read of both maps."""
    for name, a, n in (("row_model", row_model, rows),
                       ("group_model", group_model, groups)):
        if a.device != device:
            raise ValueError(f"predict_forest: {name} is on {a.device}, "
                             f"the rows on {device}")
        if a.dtype != torch.int32 or a.shape != (n,) or \
                not a.is_contiguous():
            raise ValueError(f"predict_forest: {name} must be contiguous "
                             f"int32 [{n}], got {a.dtype} "
                             f"{tuple(a.shape)}")
    gm, rm = group_model.cpu(), row_model.cpu()
    members = int(gm.max()) + 1 if groups else 0
    for name, a in (("group_model", gm), ("row_model", rm)):
        if a.numel() and (int(a.min()) < 0 or int(a.max()) >= members):
            raise ValueError(f"{name} holds members {int(a.min())}.."
                             f"{int(a.max())}; the pack has {members}")


def predict_forest(x: torch.Tensor, t: ForestTables,
                   group_tree_lo: torch.Tensor, group_tree: torch.Tensor,
                   leaf_value: torch.Tensor, tree_class: torch.Tensor,
                   num_class: int, early_stop_freq: int,
                   early_stop_margin: float,
                   row_model: Optional[torch.Tensor] = None,
                   group_model: Optional[torch.Tensor] = None,
                   linear: Optional[LinearLeaves] = None
                   ) -> torch.Tensor:
    """Raw scores [num_class, R] f32 of the rows ``x`` [R, >= width]: every
    row through every structure group of ``t``, tree t's leaf value added
    in forest order into ``out[tree_class[t]]`` with the early-stop replay
    — bit for bit :func:`traverse_forest` + :func:`accumulate_forest`.

    ``group_tree_lo`` [G + 1] / ``group_tree`` [T] list each group's trees
    (:func:`group_trees`; ``t.group_tree_lo`` / ``t.group_tree``);
    ``tree_class`` [T]; all int32 on the rows' device. A CSR that does not
    list every tree once, or a class outside ``[0, num_class)``, raises
    ValueError (one host read of the maps; ``CompiledForest`` checks its
    maps once at upload instead). On a CUDA tensor this launches the fused
    kernel once on the current stream and raises if the launch fails; on a
    CPU tensor it runs the plain version.

    Packed mode (both or neither): ``row_model`` [R] / ``group_model``
    [G], int32, the member of each row and of each structure group
    (:func:`pack_buffers`); a row's score sums only its own member's trees
    (a foreign group's trees add +0.0). Early stop is refused there, as in
    the JAX package's packs: its tree-count replay is per member.

    Linear mode: ``linear`` (:class:`LinearLeaves`, [T, L] / [T, L, FL]
    on the rows' device, every feature id below ``t.width``) turns each
    leaf value into the leaf's linear model over the row, solo or
    packed."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"predict_forest runs on cuda or cpu, not "
                         f"{x.device}")
    for name, a, dt in (("group_tree_lo", group_tree_lo, torch.int32),
                        ("group_tree", group_tree, torch.int32),
                        ("leaf_value", leaf_value, torch.float32),
                        ("tree_class", tree_class, torch.int32)):
        if a.device != x.device:
            raise ValueError(f"predict_forest: {name} is on {a.device}, "
                             f"the rows on {x.device}")
        if a.dtype != dt:
            raise TypeError(f"predict_forest: {name} must be {dt}, got "
                            f"{a.dtype}")
        if not a.is_contiguous():
            raise ValueError(f"predict_forest: {name} must be contiguous")
    T = group_tree.shape[0]
    if leaf_value.dim() != 2 or leaf_value.shape[0] != T or \
            tree_class.shape != (T,):
        raise ValueError("predict_forest expects [T, L] leaf values and a "
                         f"[T] tree_class for {T} trees, got "
                         f"{tuple(leaf_value.shape)}, "
                         f"{tuple(tree_class.shape)}")
    if num_class < 1:
        raise ValueError(f"num_class must be >= 1, got {num_class}")
    G = int(t.group_root.shape[0])
    _check_csr(group_tree_lo, group_tree, G, T)
    if T:
        c_lo, c_hi = torch.aminmax(tree_class.cpu())
        if int(c_lo) < 0 or int(c_hi) >= num_class:
            raise ValueError(f"tree_class holds classes {int(c_lo)}.."
                             f"{int(c_hi)}; the forest has {num_class}")
    if (row_model is None) != (group_model is None):
        raise ValueError("predict_forest: row_model and group_model come "
                         "together (packed mode) or not at all")
    if row_model is not None:
        if early_stop_freq > 0:
            raise ValueError("predict_forest: early stop cannot replay a "
                             "per-member tree count in packed mode")
        _check_packed(row_model, group_model, x.shape[0], G, x.device)
    if linear is not None:
        _check_linear(linear, leaf_value, t.width, x.device)
    return _predict_forest(x, t, group_tree_lo, group_tree, leaf_value,
                           tree_class, num_class, early_stop_freq,
                           early_stop_margin, row_model, group_model, linear)


def _check_linear(linear: LinearLeaves, leaf_value: torch.Tensor,
                  width: int, device: torch.device) -> None:
    """Refuse linear tables that are not contiguous f32 [T, L] / int32 and
    f32 [T, L, FL] beside ``leaf_value`` on the rows' device, or read a
    feature at or past ``width``. One host read of the feature ids."""
    T, L = leaf_value.shape
    lc, lf, lcf = linear
    for name, a, dt in (("leaf_const", lc, torch.float32),
                        ("leaf_feat", lf, torch.int32),
                        ("leaf_coeff", lcf, torch.float32)):
        if a.device != device or a.dtype != dt or not a.is_contiguous():
            raise ValueError(f"predict_forest: {name} must be contiguous "
                             f"{dt} on {device}, got {a.dtype} on "
                             f"{a.device}")
    if lc.shape != (T, L) or lf.dim() != 3 or lf.shape[:2] != (T, L) or \
            lf.shape[2] < 1 or lcf.shape != lf.shape:
        raise ValueError(f"predict_forest: linear tables must be [{T}, {L}]"
                         f" and [{T}, {L}, FL], got {tuple(lc.shape)}, "
                         f"{tuple(lf.shape)}, {tuple(lcf.shape)}")
    if lf.numel() and int(lf.max()) >= width:
        raise ValueError(f"linear leaves read feature {int(lf.max())}; the "
                         f"forest reads {width} features")


def _predict_forest(x: torch.Tensor, t: ForestTables,
                    group_tree_lo: torch.Tensor, group_tree: torch.Tensor,
                    leaf_value: torch.Tensor, tree_class: torch.Tensor,
                    num_class: int, early_stop_freq: int,
                    early_stop_margin: float,
                    row_model: Optional[torch.Tensor] = None,
                    group_model: Optional[torch.Tensor] = None,
                    linear: Optional[LinearLeaves] = None
                    ) -> torch.Tensor:
    """:func:`predict_forest` on maps already checked: the plain version on
    a CPU tensor, else one launch of the fused kernel (packed when
    ``row_model`` is given, in its linear mode when ``linear`` is)."""
    if x.device.type == "cpu":
        return _predict_forest_reference(
            x, t, group_tree_lo, group_tree, leaf_value, tree_class,
            num_class, early_stop_freq, early_stop_margin, row_model,
            group_model, linear)
    if x.device.type != "cuda":
        raise ValueError(f"predict_forest runs on cuda or cpu, not "
                         f"{x.device}")
    _check_tables(x, t, "predict_forest")
    R, F = x.shape
    T = group_tree.shape[0]
    if R == 0 or T == 0:
        return torch.zeros((num_class, R), dtype=torch.float32,
                           device=x.device)
    out = torch.empty((num_class, R), dtype=torch.float32, device=x.device)
    # rows rounded up to 32: an accumulation block's 32 rows of a tree
    # are one aligned 128-byte line
    ws = torch.empty((T, (R + 31) // 32 * 32), dtype=torch.float32,
                     device=x.device)
    lin = ((None, None, None, 0) if linear is None else
           (linear.leaf_const.data_ptr(), linear.leaf_feat.data_ptr(),
            linear.leaf_coeff.data_ptr(), int(linear.leaf_feat.shape[2])))
    lib = _kernel_lib(x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        counters = _fused_counters(x.device, stream, R)
        rc = lib.lg_predict_forest(
            x.data_ptr(), R, F, t.width, t.rec.data_ptr(),
            t.group_node_lo.data_ptr(), t.group_root.data_ptr(),
            t.group_steps.data_ptr(), int(t.group_root.shape[0]),
            t.cat_tab.data_ptr(), int(t.cat_tab.shape[1]),
            group_tree_lo.data_ptr(), group_tree.data_ptr(),
            leaf_value.data_ptr(), leaf_value.shape[1], *lin,
            tree_class.data_ptr(),
            T, num_class, max(int(early_stop_freq), 0),
            float(np.float32(early_stop_margin)),
            None if row_model is None else row_model.data_ptr(),
            None if group_model is None else group_model.data_ptr(),
            ws.data_ptr(), ws.shape[1], counters.data_ptr(), out.data_ptr(),
            stream)
    if rc != 0:
        with _counters_lock:         # the next launch starts from zeros
            _counters.pop((x.device.index, stream), None)
        raise RuntimeError(f"predict kernel launch failed (code {rc})")
    PREDICT_LAUNCHES.add()
    return out


class CompiledForest:
    """A device-resident compiled forest: the artifact's packed buffers
    uploaded once to ``device`` (a linear artifact's leaf tables too:
    ``linear``, or None).

    ``predict`` returns RAW per-class scores ``[num_class, N]`` f32;
    averaging and objective conversion stay with the caller
    (models/gbdt.py or the serve cache), as in the JAX package."""

    def __init__(self, artifact: ForestArtifact, device: torch.device, *,
                 early_stop_freq: int = 0,
                 early_stop_margin: float = 0.0) -> None:
        m = artifact.meta
        self.artifact = artifact
        self.device = torch.device(device)
        self.num_class = int(m["num_class"])
        self.num_trees = int(m["num_trees"])
        self.width = int(m["width"])
        self.early_stop_freq = int(early_stop_freq)
        self._es_margin = float(early_stop_margin)
        b = artifact.buffers
        gof = torch.from_numpy(np.asarray(b["group_of_tree"], np.int32))
        tc = torch.from_numpy(np.asarray(b["tree_class"], np.int32))
        _check_maps(gof, tc, int(np.asarray(b["root"]).shape[0]),
                    self.num_class)
        self.tables = device_tables(artifact, self.device)
        self._group_of_tree = gof.to(self.device)
        self._tree_class = tc.to(self.device)
        self._leaf_value = torch.from_numpy(
            np.ascontiguousarray(b["leaf_value"], np.float32)).to(self.device)
        self.linear = _upload_linear(b, self._leaf_value, self.width)

    def predict_leaf(self, x: torch.Tensor) -> torch.Tensor:
        """Leaf index per (tree, row), [T, N] int32, from one traversal:
        tree t's leaf is ``~carry[r, group_of_tree[t]]`` (compiling
        renumbers nodes, never leaves). On the card: one launch."""
        x = x.to(device=self.device, dtype=torch.float32).contiguous()
        node = traverse_forest(x, self.tables)
        return ~node.T[self._group_of_tree.long()]

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        """x: [N, >= width] f32 rows on this forest's device. On the card:
        one launch of the fused kernel (:func:`predict_forest`)."""
        x = x.to(device=self.device, dtype=torch.float32).contiguous()
        t = self.tables
        # the maps were checked at upload: no host read per dispatch
        return _predict_forest(x, t, t.group_tree_lo, t.group_tree,
                               self._leaf_value, self._tree_class,
                               self.num_class, self.early_stop_freq,
                               self._es_margin, linear=self.linear)

    @property
    def nbytes(self) -> int:
        """Resident device bytes: the artifact's node tables, the kernel's
        records and CSR, the maps and the leaf tables."""
        return _tensor_bytes(self.tables) + _tensor_bytes(
            self.linear or ()) + sum(
            int(a.nbytes) for a in (self._group_of_tree, self._tree_class,
                                    self._leaf_value))


def _tensor_bytes(tables) -> int:
    return sum(int(a.nbytes) for a in tables if isinstance(a, torch.Tensor))


class PackedForests:
    """Many compiled forests merged into ONE set of tables on one device.

    The port of the JAX package's ``PackedForests``: the members' node
    blocks, palettes and leaf tables merge (:func:`pack_buffers`),
    ``group_model`` records each structure group's owner, and
    ``predict(x, row_model)`` serves a MIXED batch in one launch of the
    fused kernel's packed mode; each row sums only its own member's trees,
    so its scores are bit for bit the member's served alone. Averaging
    and objective conversion stay per member with the caller
    (``serve/cache.ModelPack``), after the one packed dispatch.

    Members must not use prediction early stop; mixed num_class is fine —
    rows of a narrower model leave the extra class rows at zero — and so
    are mixed widths: rows are padded to the widest member with NaN, which
    no member's tree reads.
    """

    def __init__(self, members: Dict[str, CompiledForest]) -> None:
        if not members:
            raise ValueError("PackedForests needs at least one member")
        for name, cf in members.items():
            if cf.early_stop_freq > 0:
                raise ValueError(
                    f"model {name!r} uses prediction early stop; packs "
                    "dispatch many models at once and cannot replay a "
                    "per-model tree-count stop")
        cfs = list(members.values())
        devices = {cf.device for cf in cfs}
        if len(devices) != 1:
            raise ValueError(f"pack members live on {sorted(map(str, devices))}"
                             "; a pack runs on one device")
        self.device = cfs[0].device
        self.names = list(members)
        self.model_index = {n: i for i, n in enumerate(self.names)}
        self.num_class = max(cf.num_class for cf in cfs)
        self.width = max(cf.width for cf in cfs)
        b, gm = pack_buffers([cf.artifact.buffers for cf in cfs])
        G = gm.shape[0]
        tc = torch.from_numpy(b["tree_class"])
        # every map is checked here, once: no host read per dispatch
        _check_maps(torch.from_numpy(b["group_of_tree"]), tc, G,
                    self.num_class)
        self.tables = _upload_tables(b, self.width, self.device)
        self._tree_class = tc.to(self.device)
        self._group_model = torch.from_numpy(gm).to(self.device)
        self._leaf_value = torch.from_numpy(b["leaf_value"]).to(self.device)
        self.linear = _upload_linear(b, self._leaf_value, self.width)
        self.num_trees = int(tc.shape[0])

    def predict(self, x: torch.Tensor, row_model) -> torch.Tensor:
        """x: [N, >= pack width] f32 rows; row_model: [N] member index per
        row (``model_index``), a host array: checked on the host, then
        uploaded. Returns raw [num_class, N] f32. On the card: one launch
        of the fused kernel in its packed mode."""
        rm = np.ascontiguousarray(np.asarray(row_model, np.int32))
        if rm.shape != (x.shape[0],):
            raise ValueError(f"row_model must be [{x.shape[0]}], got "
                             f"{rm.shape}")
        if rm.size and (rm.min() < 0 or rm.max() >= len(self.names)):
            raise ValueError(f"row_model holds members {rm.min()}.."
                             f"{rm.max()}; the pack has {len(self.names)}")
        x = x.to(device=self.device, dtype=torch.float32).contiguous()
        t = self.tables
        return _predict_forest(x, t, t.group_tree_lo, t.group_tree,
                               self._leaf_value, self._tree_class,
                               self.num_class, 0, 0.0,
                               torch.from_numpy(rm).to(self.device),
                               self._group_model, self.linear)

    @property
    def nbytes(self) -> int:
        return _tensor_bytes(self.tables) + _tensor_bytes(
            self.linear or ()) + sum(
            int(a.nbytes) for a in (self._tree_class, self._group_model,
                                    self._leaf_value))
