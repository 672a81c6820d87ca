"""Row binning on the card: the hand-written CUDA kernel B.

The JAX package bins a dataset's numerical columns in host C++
(``lg_bin_matrix``, ``lambdagap_tpu/native/binner.cpp:172``, called from
``lambdagap_tpu/data/dataset.py:353,372``); the port bins them with B
(``csrc/bin.cu``, whose header gives its design and bound):

* :class:`BinTable` is the mappers' numerical bounds table (one float64
  array with per-feature offsets, each feature's source and output column
  and its NaN bin), built by ``data.binning.bounds_table``; beside it, once
  in host numpy, the trees B searches: each feature's bounds as an implicit
  breadth-first tree (:func:`eytzinger`), in float64 for float64 rows and,
  rounded down to float32 (:func:`round_down_f32`), for float32 rows;
* :func:`bin_rows` bins float32 / float64 rows ``[n, num_total_features]``
  on one device into u8 / u16 ``[n, num_used]``: on a CUDA tensor it
  launches B (counted in ``BIN_LAUNCHES``) or raises; only a CPU tensor
  takes the plain version (:func:`_bin_reference`: one ``torch.searchsorted``
  a feature over the float64 bounds, with the same NaN and clip rules);
* :func:`bin_matrix` bins a host matrix through :func:`bin_rows` on a
  device: blocks of at most ``BLOCK_VALUES`` values go up through two
  pinned staging slots (the copy of block k overlaps the device's work on
  block k - 1) and their bins come back the same way.

Columns outside the table (the categorical ones) are not written: the
caller bins them with their mapper on the host, as the JAX package does
(``lambdagap_tpu/native/__init__.py:187-192``). Both versions count the
float64 bounds below each value (B through the float32 table for float32
rows, which counts the same bounds), so they give the same bins as
``BinMapper.values_to_bins`` for every input, NaN and infinities included.
"""
from __future__ import annotations

import ctypes
import itertools
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..infer.engine import LaunchCounter

BIN_SOURCE = "bin.cu"
BIN_LAUNCHES = LaunchCounter()
# the largest block of values a host matrix sends up at once (the JAX
# package's own push block, lambdagap_tpu/data/dataset.py:360-368)
BLOCK_VALUES = 1 << 24
# row-tile heights (multiples of a warp) and row groups a block B may take:
# the plan takes the fewest feature tiles, then the most row groups an SM,
# then the tallest tile
_TILE_ROWS = (256, 128, 64, 32)
_GROUPS = (1, 2, 4)
_GROUP_THREADS = 256                    # csrc/bin.cu's kGroup
_MAX_THREADS = 1024                     # csrc/bin.cu's kMaxThreads
_MAX_TILE_FEATURES = 1024
_TASK_BYTES = 32                        # csrc/bin.cu's struct Task
# features whose own tree depth is at most this share the deepest such
# depth, so a table of up to 255 bins a feature is one depth (one search
# loop for every warp)
_SHARED_DEPTH = 8

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
_devices: Dict[int, Tuple[int, int]] = {}     # device -> (max smem, SMs)


def round_down_f32(b) -> np.ndarray:
    """RD32 of float64 bounds: the largest float32 not above each (+-inf
    stay, a bound past FLT_MAX becomes FLT_MAX, one below -FLT_MAX -inf).
    For a float32 ``x``, ``x <= b`` exactly when ``x <= RD32(b)``, so the
    count of bounds below ``x`` is the same over both."""
    b = np.asarray(b, np.float64)
    with np.errstate(over="ignore"):
        f = b.astype(np.float32)
    up = f.astype(np.float64) > b
    f[up] = np.nextafter(f[up], np.float32(-np.inf))
    return f


def _in_order(depth: int) -> np.ndarray:
    """The sorted index node k (k = 1 .. 2^depth - 1) of a complete binary
    search tree stored breadth first holds."""
    k = np.arange(1, 1 << depth, dtype=np.int64)
    level = np.frexp(k.astype(np.float64))[1].astype(np.int64) - 1
    return (2 * (k - (1 << level)) + 1) * (1 << (depth - 1 - level)) - 1


def eytzinger(bounds, depth: int, dtype) -> np.ndarray:
    """Sorted ``bounds`` (at most ``2^depth - 1``), padded with +inf to
    ``2^depth - 1``, as B's tree of ``max(2^depth, 8)`` slots: slot k in
    ``[1, 2^depth)`` holds node k (slot 0 and any slot past ``2^depth`` are
    +inf, unused). Starting at k = 1, ``k = 2k + (tree[k] < x)`` taken
    ``depth`` times ends at ``k - 2^depth`` = the number of bounds below
    x."""
    padded = np.full((1 << depth) - 1, np.inf, dtype)
    padded[:len(bounds)] = bounds
    tree = np.full(max(1 << depth, 8), np.inf, dtype)
    tree[1:1 << depth] = padded[_in_order(depth)]
    return tree


_F32 = np.finfo(np.float32)
# float32 values at the edges of the type: signed zeros, the smallest
# subnormals, the largest subnormal and the smallest normal, +-FLT_MAX,
# infinities, NaN
F32_EDGES = np.array(
    [0.0, -0.0, _F32.smallest_subnormal, -_F32.smallest_subnormal,
     2 * _F32.smallest_subnormal, -2 * _F32.smallest_subnormal,
     np.nextafter(_F32.tiny, np.float32(0)), _F32.tiny, -_F32.tiny,
     _F32.max, -_F32.max, np.inf, -np.inf, np.nan], np.float32)


def edge_rows(table: "BinTable", num_cols: int) -> np.ndarray:
    """float32 rows ``[M, num_cols]`` that probe the float32 table: column
    ``col[f]`` takes, in turn, each of feature f's finite bounds rounded
    down to float32, their float32 neighbours either side, and
    :data:`F32_EDGES`; the other columns hold 0."""
    cand = [np.zeros(1, np.float32)] * num_cols
    for f, j in enumerate(table.col):
        rd = round_down_f32(table.bounds[table.off[f]:table.off[f + 1]])
        rd = rd[np.isfinite(rd)]
        with np.errstate(over="ignore"):
            cand[j] = np.concatenate([
                rd, np.nextafter(rd, np.float32(np.inf)),
                np.nextafter(rd, np.float32(-np.inf)), F32_EDGES])
    M = max(len(c) for c in cand)
    return np.stack([np.resize(c, M) for c in cand], axis=1)


class BinTable:
    """The numerical bounds of a dataset's mappers, as B reads them.

    col / dst / nan_bin: int32 ``[Fn]`` per numerical used feature — its
    column in the raw rows, its column in the binned output, and its NaN
    bin (-1: a NaN reads as 0.0); bounds: float64, feature f's upper bounds
    without the NaN sentinel at ``[off[f], off[f + 1])``; ``num_used`` the
    output width; ``out_dtype`` u8 or u16. B's trees: feature f's ``depth``
    D (``2^D - 1 >= len(bounds_f)``; features of at most 255 bounds share
    the deepest such D), its tree at ``[toff[f], toff[f + 1])`` of
    ``tree64`` (float64) and ``tree32`` (its bounds rounded down to
    float32), and ``last`` = ``len(bounds_f) - 1``, the clip. Device copies
    and the tile plans are made once per device."""

    def __init__(self, col, dst, nan_bin, bounds, off, num_used: int,
                 out_dtype) -> None:
        self.col = np.asarray(col, np.int32)
        self.dst = np.asarray(dst, np.int32)
        self.nan_bin = np.asarray(nan_bin, np.int32)
        self.bounds = np.asarray(bounds, np.float64)
        self.off = np.asarray(off, np.int64)
        self.num_used = int(num_used)
        self.out_dtype = np.dtype(out_dtype)
        nb = np.diff(self.off)
        self.last = (nb - 1).astype(np.int32)
        own = np.array([max(1, int(b).bit_length()) for b in nb], np.int32)
        shallow = own <= _SHARED_DEPTH
        self.depth = np.where(shallow, own[shallow].max(initial=1),
                              own).astype(np.int32)
        self.toff = np.zeros(len(nb) + 1, np.int64)
        np.cumsum(np.maximum(np.left_shift(1, self.depth.astype(np.int64)),
                             8), out=self.toff[1:])
        parts = [self.bounds[lo:hi] for lo, hi in zip(self.off[:-1],
                                                      self.off[1:])]
        self.tree64 = np.concatenate(
            [eytzinger(b, int(d), np.float64)
             for b, d in zip(parts, self.depth)] or [np.empty(0)])
        self.tree32 = np.concatenate(
            [eytzinger(round_down_f32(b), int(d), np.float32)
             for b, d in zip(parts, self.depth)]
            or [np.empty(0, np.float32)])
        self._dev: Dict[str, dict] = {}

    @property
    def num_features(self) -> int:
        return len(self.col)

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.uint8 if self.out_dtype == np.uint8 else torch.uint16

    def on(self, device: torch.device) -> dict:
        """The table's tensors on ``device`` (on a card B's trees too)."""
        key = str(device)
        if key not in self._dev:
            names = ("col", "dst", "nan_bin", "bounds", "off")
            if device.type == "cuda":
                names += ("last", "depth", "toff", "tree32", "tree64")
            self._dev[key] = {name: torch.from_numpy(getattr(self, name)).to(
                device) for name in names}
            self._dev[key]["plans"] = {}
        return self._dev[key]

    def plan(self, device: torch.device, in_bytes: int, max_smem: int,
             blocks_per_sm) -> dict:
        """B's launch plan for rows of ``in_bytes`` (4 or 8) on ``device``:
        the row-tile height R, the row groups G of 256 threads a block, and
        the feature tiles (consecutive features whose trees, staged, fit
        one block's ``max_smem`` beside its groups' row buffers; a feature
        too large alone is a tile searched in device memory). Of the
        candidates it takes the fewest feature tiles, then the most threads
        an SM (``blocks_per_sm(threads, smem)`` blocks), then the most
        tasks a warp has in a row tile (up to 4: fewer leave warps idle at
        the tile's barrier), then the most row groups, then the tallest R
        (measured on the H100, PERF.md section 6). Made once per width."""
        t = self.on(device)
        if in_bytes not in t["plans"]:
            ob = self.out_dtype.itemsize
            best, best_key = None, None
            for R, G in itertools.product(_TILE_ROWS, _GROUPS):
                tiles, staged, smem = _feature_tiles(
                    np.diff(self.toff), R, in_bytes, ob, max_smem, G)
                tasks = (max(np.diff(tiles)) + 1) // 2 * (R // 32)
                threads = G * _GROUP_THREADS
                occ = blocks_per_sm(threads, smem) \
                    if smem <= max_smem and threads <= _MAX_THREADS else 0
                key = (len(staged), -occ * threads,
                       -min(tasks / (_GROUP_THREADS // 32), 4.0), -G, -R)
                if occ > 0 and (best_key is None or key < best_key):
                    best, best_key = (R, G, occ, tiles, staged, smem), key
            if best is None:
                raise RuntimeError(f"{BIN_SOURCE}: no launch plan fits "
                                   f"{max_smem} B of shared memory")
            R, G, occ, tiles, staged, smem = best
            t["plans"][in_bytes] = dict(
                rows=R, groups=G, threads=G * _GROUP_THREADS,
                blocks_per_sm=occ,
                n_tiles=len(staged), smem=smem,
                tiles=torch.tensor(tiles, dtype=torch.int32, device=device),
                staged=torch.tensor(staged, dtype=torch.uint8,
                                    device=device),
                # one tile writing every output column in order: its rows
                # of bins leave shared memory as whole 16-byte words
                whole_rows=len(staged) == 1 and np.array_equal(
                    self.dst, np.arange(self.num_used)))
        return t["plans"][in_bytes]


def _a16(b: int) -> int:
    return (int(b) + 15) & ~15


def _row_pitch(tf: int) -> int:
    """The staged row pitch in values (``csrc/bin.cu``'s ``row_pitch``):
    ``tf`` rounded up to even, plus 2 when that is a multiple of 4."""
    even = tf + (tf & 1)
    return even + (2 if even % 4 == 0 else 0)


def _tile_bytes(tf: int, words: int, staged: bool, R: int, es: int,
                ob: int, G: int = 1) -> int:
    """Shared bytes of a tile of ``tf`` features whose trees hold ``words``
    elements of ``es`` bytes: staged trees, the features' columns and
    output columns, the tasks, then for each of ``G`` row groups two row
    buffers and the bins (``csrc/bin.cu``'s ``Layout``)."""
    tasks = (tf + 1) // 2 * (-(-R // 32))
    return ((_a16(words * es) if staged else 0) + 2 * _a16(tf * 4)
            + _a16(tasks * _TASK_BYTES)
            + G * (2 * _a16(R * _row_pitch(tf) * es) + _a16(R * tf * ob)))


def _feature_tiles(sizes: np.ndarray, R: int, es: int, ob: int, cap: int,
                   G: int = 1) -> Tuple[List[int], List[int], int]:
    """Greedy feature tiles under ``cap`` shared bytes: (feature ranges,
    staged flags, the largest tile's bytes)."""
    tiles: List[int] = [0]
    staged: List[int] = []
    smem = 0
    f, Fn = 0, len(sizes)
    while f < Fn:
        g, words = f, 0
        while g < Fn and g - f < _MAX_TILE_FEATURES and _tile_bytes(
                g - f + 1, words + int(sizes[g]), True, R, es, ob,
                G) <= cap:
            words += int(sizes[g])
            g += 1
        if g == f:                      # one feature beyond the cap
            g = f + 1
            staged.append(0)
            smem = max(smem, _tile_bytes(1, 0, False, R, es, ob, G))
        else:
            staged.append(1)
            smem = max(smem, _tile_bytes(g - f, words, True, R, es, ob, G))
        tiles.append(g)
        f = g
    return tiles, staged, smem


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The C interface of ``csrc/bin.cu``'s library, declared."""
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.lg_bin_setup.argtypes = []
    lib.lg_bin_setup.restype = ctypes.c_int
    lib.lg_bin_occupancy.argtypes = [i32, i32, i32, i32]
    lib.lg_bin_occupancy.restype = ctypes.c_int
    lib.lg_bin_attributes.argtypes = [i32, i32, p]
    lib.lg_bin_attributes.restype = ctypes.c_int
    lib.lg_bin_rows.argtypes = [
        p, i32, i64, i64,           # x, in_bytes, n, ld
        p, p, p, p, p,              # col, dst, nan_bin, last, depth
        p, p, p, p, i32,            # toff, tree, tiles, staged,
                                    # n_tiles
        i32, i32, i32, i32, i32,    # rows, dense_out, smem, nblk,
                                    # threads
        p, i32, i64, p]             # out, out_bytes, U, stream
    lib.lg_bin_rows.restype = ctypes.c_int
    return lib


def _load(dev: torch.device) -> ctypes.CDLL:
    """The built library, declared, with its shared-memory limit raised on
    ``dev`` (once per device)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            from ..utils import cuda_build
            _lib = _declare(cuda_build.load(BIN_SOURCE))
        if dev.index not in _devices:
            with torch.cuda.device(dev):
                max_smem = _lib.lg_bin_setup()
            if max_smem <= 0:
                raise RuntimeError(f"{BIN_SOURCE}: shared-memory setup failed "
                                   f"(code {-max_smem})")
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            _devices[dev.index] = (max_smem, sms)
        return _lib


def kernel_attributes(dev: torch.device, in_bytes: int,
                      out_bytes: int) -> Tuple[int, int]:
    """(registers a thread, local spill bytes a thread) of B's compiled
    instantiation for rows of ``in_bytes`` and bins of ``out_bytes``."""
    lib = _load(dev)
    attrs = (ctypes.c_int * 2)()
    with torch.cuda.device(dev):
        rc = lib.lg_bin_attributes(in_bytes, out_bytes, attrs)
    if rc != 0:
        raise RuntimeError(f"{BIN_SOURCE}: attribute query failed (code "
                           f"{rc})")
    return attrs[0], attrs[1]


def _occupancy(lib: ctypes.CDLL, dev: torch.device, es: int, ob: int,
               threads: int, smem: int) -> int:
    """Resident blocks an SM of ``threads`` threads and ``smem`` shared
    bytes (0 where a block does not fit)."""
    with torch.cuda.device(dev):
        return max(0, lib.lg_bin_occupancy(es, ob, threads, smem))


def _check(x: torch.Tensor, table: BinTable, out: torch.Tensor) -> None:
    if x.dtype not in (torch.float32, torch.float64) or x.dim() != 2:
        raise TypeError(f"bin_rows: rows must be f32/f64 [n, F], got "
                        f"{x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("bin_rows: rows must be contiguous")
    if table.num_features and int(table.col.max()) >= x.shape[1]:
        raise ValueError(f"bin_rows: the table reads column "
                         f"{int(table.col.max())} of {x.shape[1]}-column rows")
    if out.shape != (x.shape[0], table.num_used) or \
            out.dtype != table.torch_dtype or out.device != x.device or \
            not out.is_contiguous():
        raise ValueError(f"bin_rows: out must be contiguous "
                         f"{table.torch_dtype} [{x.shape[0]}, "
                         f"{table.num_used}] on {x.device}")


def _bin_reference(x: torch.Tensor, table: BinTable,
                   out: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`bin_rows` in torch ops: per feature, the
    value widened to float64, a NaN read as 0.0 (or sent to the NaN bin),
    ``torch.searchsorted`` (side left) over its bounds, clipped."""
    t = table.on(x.device)
    bounds = t["bounds"]
    for f in range(table.num_features):
        lo, hi = int(table.off[f]), int(table.off[f + 1])
        v = x[:, int(table.col[f])].double()
        nan = torch.isnan(v)
        idx = torch.searchsorted(bounds[lo:hi],
                                 torch.where(nan, 0.0, v)).clamp_(
                                     max=hi - lo - 1)
        if table.nan_bin[f] >= 0:
            idx = torch.where(nan, int(table.nan_bin[f]), idx)
        # u16 through int16's bits: torch's uint16 has no cast from int64
        out[:, int(table.dst[f])] = (
            idx.to(torch.int16).view(torch.uint16)
            if out.dtype == torch.uint16 else idx.to(torch.uint8))
    return out


def bin_rows(x: torch.Tensor, table: BinTable,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Bins of rows ``x`` (f32 / f64 ``[n, num_total_features]``,
    contiguous) -> u8 / u16 ``[n, num_used]`` on x's device. Columns of
    ``out`` outside the table are left as they are (``out`` None: a new
    uninitialized tensor). A CUDA tensor launches B; a CPU tensor takes the
    plain version."""
    if out is None:
        out = torch.empty((x.shape[0], table.num_used),
                          dtype=table.torch_dtype, device=x.device)
    _check(x, table, out)
    if x.device.type == "cpu":
        return _bin_reference(x, table, out)
    if x.device.type != "cuda":
        raise ValueError(f"bin_rows runs on cuda or cpu, not {x.device}")
    n = x.shape[0]
    if n == 0 or table.num_features == 0:
        return out
    dev = x.device
    lib = _load(dev)
    t = table.on(dev)
    max_smem, sms = _devices[dev.index]
    es, ob = x.element_size(), out.element_size()
    plan = table.plan(dev, es, max_smem, lambda threads, smem: _occupancy(
        lib, dev, es, ob, threads, smem))
    G = plan["groups"]
    nblk = max(1, min(-(-n // (plan["rows"] * G)),
                      -(-sms * plan["blocks_per_sm"] // plan["n_tiles"])))
    dense = int(plan["whole_rows"] and out.data_ptr() % 16 == 0)
    tree = t["tree32"] if es == 4 else t["tree64"]
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.lg_bin_rows(
        x.data_ptr(), es, n, x.shape[1], t["col"].data_ptr(),
        t["dst"].data_ptr(), t["nan_bin"].data_ptr(), t["last"].data_ptr(),
        t["depth"].data_ptr(), t["toff"].data_ptr(), tree.data_ptr(),
        plan["tiles"].data_ptr(), plan["staged"].data_ptr(), plan["n_tiles"],
        plan["rows"], dense, plan["smem"], nblk, plan["threads"],
        out.data_ptr(), ob, table.num_used, stream)
    if rc != 0:
        raise RuntimeError(f"{BIN_SOURCE}: launch failed (code {rc})")
    BIN_LAUNCHES.add()
    return out


def _host_view(t: torch.Tensor) -> np.ndarray:
    """A CPU u8 / u16 tensor as numpy, without a copy."""
    if t.dtype == torch.uint16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def bin_matrix(data: np.ndarray, table: BinTable, device: torch.device,
               out: np.ndarray) -> None:
    """Bin the table's columns of a host matrix ``data`` ``[n, F]`` into
    ``out`` (u8 / u16 ``[n, num_used]``) with :func:`bin_rows` on
    ``device``; the columns outside the table come back 0 for the caller to
    fill. float32 and float64 rows are read as they are; other types
    convert to float64 block by block. On a card the blocks go up through
    two pinned slots and come back the same way."""
    n = data.shape[0]
    if n == 0:
        return
    dtype = data.dtype if data.dtype in (np.float32, np.float64) \
        else np.dtype(np.float64)
    step = max(BLOCK_VALUES // max(data.shape[1], 1), 1)
    U = table.num_used
    if device.type == "cpu":
        for lo in range(0, n, step):
            blk = np.ascontiguousarray(data[lo:lo + step], dtype=dtype)
            res = torch.zeros((blk.shape[0], U), dtype=table.torch_dtype)
            out[lo:lo + step] = _host_view(
                bin_rows(torch.from_numpy(blk), table, res))
        return
    tdtype = torch.float32 if dtype == np.float32 else torch.float64
    rows = min(step, n)
    slots = [(torch.empty((rows, data.shape[1]), dtype=tdtype,
                          pin_memory=True),
              torch.empty((rows, U), dtype=table.torch_dtype,
                          pin_memory=True),
              torch.cuda.Event()) for _ in range(2)]
    stream = torch.cuda.current_stream(device)
    pending = []                        # (slot, lo, hi) with bins in flight

    def drain() -> None:
        s, lo, hi = pending.pop(0)
        slots[s][2].synchronize()
        out[lo:hi] = _host_view(slots[s][1][:hi - lo])

    for k, lo in enumerate(range(0, n, step)):
        hi = min(lo + step, n)
        s = k % 2
        if len(pending) == 2:
            drain()
        host_in, host_out, done = slots[s]
        np.copyto(host_in[:hi - lo].numpy(), data[lo:hi], casting="unsafe")
        dev_out = torch.zeros((hi - lo, U), dtype=table.torch_dtype,
                              device=device)
        bin_rows(host_in[:hi - lo].to(device, non_blocking=True), table,
                 dev_out)
        host_out[:hi - lo].copy_(dev_out, non_blocking=True)
        done.record(stream)
        pending.append((s, lo, hi))
    while pending:
        drain()
