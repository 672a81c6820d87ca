"""Compiled-forest traversal engine (``predict_engine=compiled``).

The port of ``lambdagap_tpu/infer/engine.py``: runs the serving-shaped
artifact :mod:`lambdagap_tpu_torch.infer.compile` emits. The traversal — the
JAX package's Pallas ``_traverse_kernel`` — is a hand-written CUDA kernel
here (``csrc/traverse.cu``, wrapper :func:`traverse_forest`) that carries
a ``[rows, groups]`` node lattice through every node block's breadth-first
level slabs, decoding the narrow palette codes in-kernel. Merged trees are
traversed ONCE per structure group; the per-tree leaf payloads are gathered
afterwards through the compile-time ``group_of_tree`` map.

Bit-exactness contract (the JAX package's): traversal only computes leaf
INDICES — any correct traversal yields the same ones — and the per-class
score accumulation then adds the trees in forest order, one f32 add per
tree into ``out[tree_class[t]]``, with the identical early-stop replay, as
the scan oracle (``ops/predict.py``) and the JAX package's ``lax.scan``.
That loop is ~T small torch ops per dispatch; fusing it into a kernel is
later work. ``sum``/``cumsum``/``index_add_`` over the tree axis would add
in another order and are not used.

On a CUDA tensor :func:`traverse_forest` launches the kernel or raises;
only a CPU tensor takes the plain version (:func:`_traverse_block_reference`,
block by block like the JAX package's ``_traverse_all``). ``PackedForests``
and linear leaves wait for later slices.
"""
from __future__ import annotations

import ctypes
import threading
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..ops.predict import (K_ZERO_THRESHOLD, MT_NAN, MT_ZERO, category_of,
                           cat_go_left, margin_of)
from .compile import (FLAG_CATEGORICAL, FLAG_DEFAULT_LEFT, FLAG_MT_SHIFT,
                      ForestArtifact)

TRAVERSE_SOURCE = "traverse.cu"


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


class ForestTables(NamedTuple):
    """An artifact's node tables on one device, block-major as compiled.

    The narrow palette dtypes are kept (u8/u16/u32; the kernel reads them
    as they are). ``group_base`` / ``group_depth`` give each structure
    group its node block's first node and step count, so one kernel launch
    covers every block; the host block directory keeps the per-block view
    the plain version walks."""
    feat: torch.Tensor         # u16/u32 [n]
    thr: torch.Tensor          # u8/u16/u32 [n] palette code into thr_tab
    flags: torch.Tensor        # u8 [n]
    catc: torch.Tensor         # u8/u16/u32 [n] row of cat_tab
    left: torch.Tensor         # i32 [n] block-local child id or ~leaf
    right: torch.Tensor        # i32 [n]
    thr_tab: torch.Tensor      # f32 [U]
    cat_tab: torch.Tensor      # u32 [C, W]
    root: torch.Tensor         # i32 [G] block-local root id or ~leaf
    group_base: torch.Tensor   # i32 [G]
    group_depth: torch.Tensor  # i32 [G]
    block_node_lo: Tuple[int, ...]
    block_group_lo: Tuple[int, ...]
    depths: Tuple[int, ...]
    width: int                 # 1 + max split feature


def device_tables(artifact: ForestArtifact,
                  device: torch.device) -> ForestTables:
    """Upload an artifact's node tables once (the analog of the JAX
    package's ``_device_blocks``)."""
    b = artifact.buffers
    lo = tuple(int(v) for v in np.asarray(b["block_node_lo"]))
    glo = tuple(int(v) for v in np.asarray(b["block_group_lo"]))
    depths = tuple(int(d) for d in np.asarray(b["block_depth"]))
    G = int(np.asarray(b["root"]).shape[0])
    gbase = np.zeros(G, np.int32)
    gdepth = np.zeros(G, np.int32)
    for i, d in enumerate(depths):
        gbase[glo[i]:glo[i + 1]] = lo[i]
        gdepth[glo[i]:glo[i + 1]] = d

    def up(a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return ForestTables(
        feat=up(b["node_feat"]), thr=up(b["node_thr"]),
        flags=up(b["node_flags"]), catc=up(b["node_cat"]),
        left=up(b["node_left"]), right=up(b["node_right"]),
        thr_tab=up(np.asarray(b["thr_table"], np.float32)),
        cat_tab=up(np.asarray(b["cat_table"], np.uint32)),
        root=up(b["root"]), group_base=up(gbase), group_depth=up(gdepth),
        block_node_lo=lo, block_group_lo=glo, depths=depths,
        width=int(artifact.meta["width"]))


# ---------------------------------------------------------------------------
# the plain version: one node block, [rows, groups] lattice
# ---------------------------------------------------------------------------
def _traverse_block_reference(x: torch.Tensor, feat, thr, flags, catc, left,
                              right, thr_tab, cat_tab, root,
                              depth: int) -> torch.Tensor:
    """Carry every row through every structure group of ONE node block ->
    [R, Gb] int32, in plain torch ops: the decision math of the JAX
    package's ``_traverse_kernel``, decision for decision. Narrow codes and
    bitset words are widened to int64 first (torch cannot index with u16
    nor shift u32 on the CPU)."""
    R = x.shape[0]
    feat, thr, catc = feat.long(), thr.long(), catc.long()
    flags = flags.long()
    left, right = left.long(), right.long()
    cat_bits = cat_tab.long()                          # [C, W]
    W = cat_bits.shape[1]
    node = root.long()[None, :].expand(R, -1)          # [R, Gb]
    for _ in range(depth):
        idx = node.clamp(min=0)
        f = feat[idx]
        fl = flags[idx]
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
        go_num = torch.where(missing, dl, v0 <= thr_tab[thr[idx]])
        go_cat = cat_go_left(category_of(v), cat_bits[catc[idx]], W * 32)
        go = torch.where(is_cat, go_cat, go_num)
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


# ---------------------------------------------------------------------------
# the kernel wrapper
# ---------------------------------------------------------------------------
_lib_lock = threading.Lock()
_lib = None


def _kernel_lib() -> ctypes.CDLL:
    """The built ``traverse.cu`` library with every argtype declared
    (pointers as c_void_p so ctypes never truncates them)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            from ..utils import cuda_build
            lib = cuda_build.load(TRAVERSE_SOURCE)
            p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
            lib.lg_traverse_forest.argtypes = [
                p, i64, i64,            # x, rows, x_stride
                p, i32, p, i32,         # feat, feat_bytes, thr, thr_bytes
                p, p, i32,              # flags, catc, cat_bytes
                p, p,                   # left, right
                p, p, i32,              # thr_tab, cat_tab, cat_words
                p, p, p, i64,           # root, gbase, gdepth, groups
                p, p]                   # out, stream
            lib.lg_traverse_forest.restype = ctypes.c_int
            _lib = lib
        return _lib


_CODE_DTYPES = {torch.uint8, torch.uint16, torch.uint32}


def _check_tables(x: torch.Tensor, t: ForestTables) -> None:
    for name in ("feat", "thr", "flags", "catc", "left", "right", "thr_tab",
                 "cat_tab", "root", "group_base", "group_depth"):
        a = getattr(t, name)
        if a.device != x.device:
            raise ValueError(f"traverse_forest: table {name} is on "
                             f"{a.device}, rows on {x.device}")
        if not a.is_contiguous():
            raise ValueError(f"traverse_forest: table {name} must be "
                             "contiguous")
    if t.feat.dtype not in (torch.uint16, torch.uint32):
        raise TypeError(f"node_feat must be u16/u32, got {t.feat.dtype}")
    if t.thr.dtype not in _CODE_DTYPES or t.catc.dtype not in _CODE_DTYPES:
        raise TypeError("palette codes must be u8/u16/u32, got "
                        f"{t.thr.dtype} / {t.catc.dtype}")
    for name, dt in (("flags", torch.uint8), ("left", torch.int32),
                     ("right", torch.int32), ("thr_tab", torch.float32),
                     ("cat_tab", torch.uint32), ("root", torch.int32),
                     ("group_base", torch.int32),
                     ("group_depth", torch.int32)):
        if getattr(t, name).dtype != dt:
            raise TypeError(f"table {name} must be {dt}, got "
                            f"{getattr(t, name).dtype}")
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
    node block in one launch) on the current stream and raises if the
    launch fails; the caller keeps ``x`` and ``t`` alive until it has
    read the result. On a CPU tensor it runs the plain version."""
    if x.device.type == "cpu":
        return _traverse_all_reference(x, t)
    if x.device.type != "cuda":
        raise ValueError(f"traverse_forest runs on cuda or cpu, "
                         f"not {x.device}")
    _check_tables(x, t)
    R, F = x.shape
    G = int(t.root.shape[0])
    out = torch.empty((R, G), dtype=torch.int32, device=x.device)
    lib = _kernel_lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.lg_traverse_forest(
            x.data_ptr(), R, F,
            t.feat.data_ptr(), t.feat.element_size(),
            t.thr.data_ptr(), t.thr.element_size(),
            t.flags.data_ptr(), t.catc.data_ptr(), t.catc.element_size(),
            t.left.data_ptr(), t.right.data_ptr(),
            t.thr_tab.data_ptr(), t.cat_tab.data_ptr(),
            int(t.cat_tab.shape[1]),
            t.root.data_ptr(), t.group_base.data_ptr(),
            t.group_depth.data_ptr(), G, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"traverse kernel launch failed (code {rc})")
    TRAVERSE_LAUNCHES.add()
    return out


# ---------------------------------------------------------------------------
# leaf gather + forest-order accumulation (plain torch ops)
# ---------------------------------------------------------------------------
def _leaf_values(node: torch.Tensor, group_of_tree: torch.Tensor,
                 leaf_value: torch.Tensor) -> torch.Tensor:
    """[R, G] group node carry -> [R, T] per-tree leaf values, through the
    flattened ``forest_to_arrays`` leaf table the artifact carries."""
    nodeT = node.long()[:, group_of_tree]              # [R, T]
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
        self.tables = device_tables(artifact, self.device)
        self._group_of_tree = torch.from_numpy(
            np.asarray(b["group_of_tree"], np.int64)).to(self.device)
        self._tree_class: List[int] = [
            int(k) for k in np.asarray(b["tree_class"])]
        self._leaf_value = torch.from_numpy(
            np.ascontiguousarray(b["leaf_value"], np.float32)).to(self.device)

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        """x: [N, >= width] f32 rows on this forest's device."""
        x = x.to(device=self.device, dtype=torch.float32).contiguous()
        node = traverse_forest(x, self.tables)
        vals = _leaf_values(node, self._group_of_tree, self._leaf_value)
        return _accumulate(vals, self._tree_class, self.num_class,
                           self.early_stop_freq, self._es_margin)
