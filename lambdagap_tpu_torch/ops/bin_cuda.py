"""Row binning on the card: the hand-written CUDA kernel B.

The JAX package bins a dataset's numerical columns in host C++
(``lg_bin_matrix``, ``lambdagap_tpu/native/binner.cpp:172``, called from
``lambdagap_tpu/data/dataset.py:353,372``); the port bins them with B
(``csrc/bin.cu``, whose header gives its design and bound):

* :class:`BinTable` is the mappers' numerical bounds table (one float64
  array with per-feature offsets, each feature's source and output column
  and its NaN bin), built by ``data.binning.bounds_table``;
* :func:`bin_rows` bins float32 / float64 rows ``[n, num_total_features]``
  on one device into u8 / u16 ``[n, num_used]``: on a CUDA tensor it
  launches B (counted in ``BIN_LAUNCHES``) or raises; only a CPU tensor
  takes the plain version (:func:`_bin_reference`: one ``torch.searchsorted``
  a feature with the same NaN and clip rules);
* :func:`bin_matrix` bins a host matrix through :func:`bin_rows` on a
  device: blocks of at most ``BLOCK_VALUES`` values go up through two
  pinned staging slots (the copy of block k overlaps the device's work on
  block k - 1) and their bins come back the same way.

Columns outside the table (the categorical ones) are not written: the
caller bins them with their mapper on the host, as the JAX package does
(``lambdagap_tpu/native/__init__.py:187-192``). Both versions compare the
value widened to float64 with the float64 bounds, so they give the same
bins as ``BinMapper.values_to_bins`` for every input, NaN and infinities
included.
"""
from __future__ import annotations

import ctypes
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
# the most shared memory a tile's staged table takes, so two blocks of a
# wide table still fit an SM (a tile of HIGGS's 28 x 256 bounds is 57 KB)
_STAGE_CAP = 100 * 1024
_MAX_TILE_FEATURES = 1024
_THREADS = 256

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
_devices: Dict[int, Tuple[int, int]] = {}     # device -> (max smem, SMs)
_occupancy: Dict[Tuple, int] = {}


class BinTable:
    """The numerical bounds of a dataset's mappers, as B reads them.

    col / dst / nan_bin: int32 ``[Fn]`` per numerical used feature — its
    column in the raw rows, its column in the binned output, and its NaN
    bin (-1: a NaN reads as 0.0); bounds: float64, feature f's upper bounds
    without the NaN sentinel at ``[off[f], off[f + 1])``; ``num_used`` the
    output width; ``out_dtype`` u8 or u16. Device copies and the tile plan
    are made once per device."""

    def __init__(self, col, dst, nan_bin, bounds, off, num_used: int,
                 out_dtype) -> None:
        self.col = np.asarray(col, np.int32)
        self.dst = np.asarray(dst, np.int32)
        self.nan_bin = np.asarray(nan_bin, np.int32)
        self.bounds = np.asarray(bounds, np.float64)
        self.off = np.asarray(off, np.int64)
        self.num_used = int(num_used)
        self.out_dtype = np.dtype(out_dtype)
        self._dev: Dict[str, dict] = {}

    @property
    def num_features(self) -> int:
        return len(self.col)

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.uint8 if self.out_dtype == np.uint8 else torch.uint16

    def on(self, device: torch.device) -> dict:
        """The table's tensors on ``device`` (and on a card its tile plan)."""
        key = str(device)
        if key not in self._dev:
            t = {name: torch.from_numpy(getattr(self, name)).to(device)
                 for name in ("col", "dst", "nan_bin", "bounds", "off")}
            if device.type == "cuda":
                t.update(self._plan(device))
            self._dev[key] = t
        return self._dev[key]

    def _plan(self, device: torch.device) -> dict:
        """Feature tiles: consecutive features whose staged table (bounds
        and per-feature words) fits ``_STAGE_CAP``; a feature too large for
        it alone is a tile searched in device memory."""
        sizes = np.diff(self.off)
        tiles: List[int] = [0]
        staged: List[int] = []
        smem = 0
        f = 0
        Fn = self.num_features
        while f < Fn:
            g, nb = f, 0
            while g < Fn and g - f < _MAX_TILE_FEATURES and \
                    _tile_bytes(nb + sizes[g], g - f + 1) <= _STAGE_CAP:
                nb += int(sizes[g])
                g += 1
            if g == f:                  # one feature beyond the cap
                g = f + 1
                staged.append(0)
                smem = max(smem, _tile_bytes(0, 1))
            else:
                staged.append(1)
                smem = max(smem, _tile_bytes(nb, g - f))
            tiles.append(g)
            f = g
        return dict(tiles=torch.tensor(tiles, dtype=torch.int32,
                                       device=device),
                    staged=torch.tensor(staged, dtype=torch.uint8,
                                        device=device),
                    n_tiles=len(staged), smem=smem,
                    max_tf=max(np.diff(tiles), default=1))


def _tile_bytes(nb: int, tf: int) -> int:
    """Shared bytes of a tile: staged bounds, int64 offsets, three int32
    words a feature (``csrc/bin.cu``'s layout)."""
    return int(nb) * 8 + (tf + 1) * 8 + 3 * tf * 4


def _load(dev: torch.device) -> ctypes.CDLL:
    """The built library, declared, with its shared-memory limit raised on
    ``dev`` (once per device)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            from ..utils import cuda_build
            lib = cuda_build.load(BIN_SOURCE)
            p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
            lib.lg_bin_setup.argtypes = []
            lib.lg_bin_setup.restype = ctypes.c_int
            lib.lg_bin_occupancy.argtypes = [i32, i32, i32]
            lib.lg_bin_occupancy.restype = ctypes.c_int
            lib.lg_bin_rows.argtypes = [
                p, i32, i64, i64,           # x, in_bytes, n, ld
                p, p, p, p, p,              # col, dst, nan_bin, bounds, off
                p, p, i32, i32,             # tiles, staged, n_tiles, smem
                i32, i64,                   # nblk, chunk_rows
                p, i32, i64, p]             # out, out_bytes, U, stream
            lib.lg_bin_rows.restype = ctypes.c_int
            _lib = lib
        if dev.index not in _devices:
            with torch.cuda.device(dev):
                max_smem = _lib.lg_bin_setup()
            if max_smem <= 0:
                raise RuntimeError(f"{BIN_SOURCE}: shared-memory setup failed "
                                   f"(code {-max_smem})")
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            _devices[dev.index] = (max_smem, sms)
        return _lib


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
    _, sms = _devices[dev.index]
    key = (dev.index, x.element_size(), out.element_size(), t["smem"])
    if key not in _occupancy:
        _occupancy[key] = lib.lg_bin_occupancy(x.element_size(),
                                               out.element_size(), t["smem"])
    occ = _occupancy[key]
    if occ <= 0:
        raise RuntimeError(f"{BIN_SOURCE}: a block of {t['smem']} B of "
                           f"shared memory does not fit (code {occ})")
    # a row chunk gives each thread ~16 (row, feature) pairs
    chunk = max(1, 16 * _THREADS // t["max_tf"])
    nblk = max(1, min(-(-n // chunk), -(-sms * occ // t["n_tiles"])))
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.lg_bin_rows(
        x.data_ptr(), x.element_size(), n, x.shape[1],
        t["col"].data_ptr(), t["dst"].data_ptr(), t["nan_bin"].data_ptr(),
        t["bounds"].data_ptr(), t["off"].data_ptr(), t["tiles"].data_ptr(),
        t["staged"].data_ptr(), t["n_tiles"], t["smem"], nblk, chunk,
        out.data_ptr(), out.element_size(), table.num_used, stream)
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
