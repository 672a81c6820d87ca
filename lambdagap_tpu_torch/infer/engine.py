"""Compiled-forest traversal engine (``predict_engine=compiled``).

The port of ``lambdagap_tpu/infer/engine.py``: runs the serving-shaped
artifact :mod:`lambdagap_tpu_torch.infer.compile` emits. A dispatch on the
card is two hand-written CUDA kernels (``csrc/traverse.cu``):

- the traversal — the JAX package's Pallas ``_traverse_kernel`` — wrapper
  :func:`traverse_forest`: the ``[rows, groups]`` node carry of every row
  through every structure group. At upload (:func:`device_tables`) each
  group's nodes are re-laid contiguously as 16-byte records (threshold
  decoded from the palette, ``feature << 4 | flags``, left, right); the
  artifact itself is not touched;
- the forest-order accumulation — the JAX package's ``_leaf_values`` and
  ``lax.scan`` ``_accumulate``, XLA work around the Pallas kernel — wrapper
  :func:`accumulate_forest`: per-tree leaf values gathered through the
  compile-time ``group_of_tree`` map, one f32 add per tree into
  ``out[tree_class[t]]`` in forest order, with the identical early-stop
  replay.

Bit-exactness contract (the JAX package's): traversal only computes leaf
INDICES — any correct traversal yields the same ones — and the
accumulation adds the trees in the scan oracle's order (``ops/predict.py``
and the JAX package's ``lax.scan``), so the scores are the oracle's bits.
``sum``/``cumsum``/``index_add_`` over the tree axis would add in another
order and are not used.

On a CUDA tensor each wrapper launches its kernel or raises; only a CPU
tensor takes the plain version (:func:`_traverse_all_reference`, block by
block like the JAX package's ``_traverse_all``; :func:`_leaf_values` +
:func:`_accumulate`, ~T small torch ops). ``PackedForests`` and linear
leaves wait for later slices.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, NamedTuple, Sequence, Tuple

import numpy as np
import torch

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
    nowhere else, so a run can show the main path went through it."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.launches = 0

    def add(self) -> None:
        with self._lock:
            self.launches += 1

    def reset(self) -> None:
        with self._lock:
            self.launches = 0


TRAVERSE_LAUNCHES = LaunchCounter()
ACCUMULATE_LAUNCHES = LaunchCounter()


class ForestTables(NamedTuple):
    """An artifact's node tables on one device.

    The narrow tables are the artifact's, block-major as compiled (u8/u16/
    u32 palette codes kept); the plain version walks them through the host
    block directory. The kernel reads ``rec``: every node as one 16-byte
    record, each structure group's nodes contiguous in breadth-first order
    with group-local child ids (leaf entries ``~leaf`` unchanged), indexed
    by ``group_node_lo``."""
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


def device_tables(artifact: ForestArtifact,
                  device: torch.device) -> ForestTables:
    """Upload an artifact's node tables once (the analog of the JAX
    package's ``_device_blocks``), with the kernel's node records beside
    them."""
    width = int(artifact.meta["width"])
    if width >= MAX_WIDTH:
        raise NotImplementedError(
            f"the traversal kernel packs feature ids into 28 bits; this "
            f"forest reads {width} features")
    b = artifact.buffers
    rec, gnl, groot, gsteps = node_records(b)

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
        block_node_lo=tuple(int(v) for v in np.asarray(b["block_node_lo"])),
        block_group_lo=tuple(int(v) for v in
                             np.asarray(b["block_group_lo"])),
        depths=tuple(int(d) for d in np.asarray(b["block_depth"])),
        width=width)


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
            _lib = lib
        if dev.index not in _ready_devices:
            with torch.cuda.device(dev):
                max_smem = _lib.lg_traverse_setup()
            if max_smem <= 0:
                raise RuntimeError(f"{TRAVERSE_SOURCE}: shared-memory setup "
                                   f"failed (code {-max_smem})")
            _ready_devices.add(dev.index)
        return _lib


def _check_tables(x: torch.Tensor, t: ForestTables) -> None:
    for name in ("rec", "group_node_lo", "group_root", "group_steps",
                 "cat_tab"):
        a = getattr(t, name)
        if a.device != x.device:
            raise ValueError(f"traverse_forest: table {name} is on "
                             f"{a.device}, rows on {x.device}")
        if not a.is_contiguous():
            raise ValueError(f"traverse_forest: table {name} must be "
                             "contiguous")
        want = torch.uint32 if name == "cat_tab" else torch.int32
        if a.dtype != want:
            raise TypeError(f"table {name} must be {want}, got {a.dtype}")
    if t.rec.dim() != 2 or t.rec.shape[1] != 4:
        raise ValueError(f"node records must be [n, 4], got "
                         f"{tuple(t.rec.shape)}")
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError("traverse_forest expects contiguous f32 rows "
                         f"[R, F], got {x.dtype} {tuple(x.shape)}")
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


class CompiledForest:
    """A device-resident compiled forest: the artifact's packed buffers
    uploaded once to ``device``.

    ``predict`` returns RAW per-class scores ``[num_class, N]`` f32;
    averaging and objective conversion stay with the caller
    (models/gbdt.py or the serve cache), as in the JAX package."""

    def __init__(self, artifact: ForestArtifact, device: torch.device, *,
                 early_stop_freq: int = 0,
                 early_stop_margin: float = 0.0) -> None:
        m = artifact.meta
        if bool(m["has_linear"]):
            raise NotImplementedError(
                "linear-leaf forests are not ported to lambdagap_tpu_torch "
                "yet (ROADMAP.md, port queue: linear leaves)")
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

    def predict_leaf(self, x: torch.Tensor) -> torch.Tensor:
        """Leaf index per (tree, row), [T, N] int32, from one traversal:
        tree t's leaf is ``~carry[r, group_of_tree[t]]`` (compiling
        renumbers nodes, never leaves). On the card: one launch."""
        x = x.to(device=self.device, dtype=torch.float32).contiguous()
        node = traverse_forest(x, self.tables)
        return ~node.T[self._group_of_tree.long()]

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        """x: [N, >= width] f32 rows on this forest's device. On the card:
        two launches, the traversal and the accumulation."""
        x = x.to(device=self.device, dtype=torch.float32).contiguous()
        node = traverse_forest(x, self.tables)
        # the maps were checked at upload: no host read per dispatch
        return _accumulate_forest(node, self._group_of_tree,
                                  self._leaf_value, self._tree_class,
                                  self.num_class, self.early_stop_freq,
                                  self._es_margin)
