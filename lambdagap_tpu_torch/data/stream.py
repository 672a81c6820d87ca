"""Out-of-core sharded binned storage and the H2D window ring.

The port of ``lambdagap_tpu/data/stream.py``. The binned matrix of a
training set can stay in host RAM (optionally disk-backed, memory-mapped)
row shards; the learners stream row windows of it to the card through a
small ring of pinned staging slots, so the copy of window ``k+1`` runs
while the card works on window ``k`` ("Out-of-Core GPU Gradient
Boosting", arXiv:2005.09148 §3).

* :class:`ShardedBinnedDataset` — a ``BinnedDataset`` whose binned matrix
  is a list of host row shards of ``stream_shard_rows`` rows (the last one
  ragged; ``np.memmap`` files under ``stream_spill_dir``), built
  streamingly: one ``QuantileSketch`` per feature finds the boundaries over
  every row, then row blocks are binned straight into the shards.
* :class:`ShardRing` — the bounded H2D ring. On the card it holds
  ``depth`` slots, each a pinned host buffer and a device buffer per window
  buffer, and two CUDA events: ``ready``, recorded on the ring's copy
  stream after the slot's host-to-device copy, and ``done``, recorded on
  the compute stream after the consumer's launches that read the window.
  ``put`` waits (on the host) for the slot's last copy before it writes
  the pinned bytes, makes the copy stream wait on ``done`` before it
  overwrites the device bytes, and queues the copy; ``wait_ready`` blocks
  the host on ``ready`` and makes the compute stream wait on it before any
  kernel reads the window. On the CPU the ring is plain copies, in the same
  order.
* :class:`WindowPump` / :func:`stream_windows` — the run-ahead loop:
  before each window is handed to the consumer the ring is topped up, so
  up to ``depth`` copies are in flight.

The host-wall phases ``h2d_prefetch`` (fetching and issuing a window) and
``chunk_wait`` (waiting for its copy) add up in a :class:`PhaseClock`, the
port's own small timer; a large ``chunk_wait`` is the ring failing to hide
the link.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..config import Config
from ..utils import log
from ..utils.device import resolve_device
from .dataset import (BinnedDataset, _batches, _mappers_from_sketches,
                      bin_dtype)
from .binning import QuantileSketch

# below this, sharding is pure overhead
MIN_SHARD_ROWS = 1 << 10

_TORCH_DTYPES = {np.dtype(np.uint8): torch.uint8,
                 np.dtype(np.uint16): torch.uint16,
                 np.dtype(np.int32): torch.int32,
                 np.dtype(np.int64): torch.int64,
                 np.dtype(np.float32): torch.float32,
                 np.dtype(np.float64): torch.float64}


# the host's row moves (shard gathers, mirror reorders) split over this
# many threads once a call moves at least _PAR_ROWS rows: numpy's copies
# release the interpreter lock
_THREADS = max(1, min(4, os.cpu_count() or 1))
_PAR_ROWS = 1 << 16
_pool: Optional[ThreadPoolExecutor] = None
_pool_lock = threading.Lock()


def row_view(a: np.ndarray) -> np.ndarray:
    """A C-contiguous ``[n, C]`` matrix as ``[n]`` opaque rows of its row
    bytes: numpy then moves a gathered row as one copy, not C."""
    return a.view(np.dtype((np.void, a.shape[1] * a.itemsize))).reshape(-1)


def _in_parts(n: int, fn) -> None:
    """``fn(lo, hi)`` over up to ``_THREADS`` contiguous parts of
    ``range(n)``, on a thread pool made on first use; raises the first
    part's error."""
    global _pool
    k = min(_THREADS, max(1, n // _PAR_ROWS))
    if k == 1:
        fn(0, n)
        return
    with _pool_lock:
        if _pool is None:
            _pool = ThreadPoolExecutor(_THREADS,
                                       thread_name_prefix="lg-rows")
    step = -(-n // k)
    for f in [_pool.submit(fn, lo, min(lo + step, n))
              for lo in range(0, n, step)]:
        f.result()


def take_rows(src: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """``src[idx]`` of a 1-D array (opaque rows, row ids), large takes
    split over threads; ``idx`` must be in range."""
    out = np.empty(len(idx), dtype=src.dtype)

    def part(lo: int, hi: int) -> None:
        np.take(src, idx[lo:hi], out=out[lo:hi], mode="clip")

    _in_parts(len(idx), part)
    return out


def _shard_sizes(total: int, shard_rows: int) -> List[int]:
    """Row counts per shard: fixed-size shards plus one ragged tail."""
    shard_rows = max(int(shard_rows), MIN_SHARD_ROWS)
    sizes = [shard_rows] * (total // shard_rows)
    if total % shard_rows:
        sizes.append(total % shard_rows)
    return sizes or [0]


class ShardedBinnedDataset(BinnedDataset):
    """A BinnedDataset whose binned matrix lives as host row shards.

    ``shards[i]`` is a C-contiguous ``uint8``/``uint16`` array of
    ``shard_rows`` rows (the last one ragged); with ``spill_dir`` set the
    shards are ``np.memmap`` files. The mappers and metadata are the base
    class's. The ``binned`` property materializes (and keeps) the
    concatenated matrix for a resident consumer (an hbm learner, a
    validation set); the stream learners never touch it."""

    def __init__(self) -> None:
        super().__init__()
        self.shards: List[np.ndarray] = []
        self.shard_rows = 0
        self.spill_dir: Optional[str] = None
        self._binned_cache: Optional[np.ndarray] = None

    # -- storage -------------------------------------------------------
    def _alloc_shard(self, idx: int, rows: int, cols: int,
                     dtype) -> np.ndarray:
        if self.spill_dir:
            os.makedirs(self.spill_dir, exist_ok=True)
            path = os.path.join(self.spill_dir, f"shard_{idx:05d}.bin")
            return np.memmap(path, dtype=dtype, mode="w+",
                             shape=(rows, cols))
        return np.empty((rows, cols), dtype=dtype)

    @property
    def num_shards(self) -> int:
        return len(self.shards)

    @property
    def dtype(self) -> np.dtype:
        return self.shards[0].dtype

    @property
    def binned(self) -> Optional[np.ndarray]:
        """Dataset-order matrix, materialized on first use and kept."""
        if self._binned_cache is None and self.shards:
            self._binned_cache = np.concatenate(self.shards, axis=0)
        return self._binned_cache

    @binned.setter
    def binned(self, value) -> None:
        # BinnedDataset.__init__ assigns binned=None before shards exist
        self._binned_cache = value

    # -- window and gather access (the host side of the ring) ----------
    def row_block(self, lo: int, hi: int,
                  out: Optional[np.ndarray] = None) -> np.ndarray:
        """Rows [lo, hi) in dataset order, copied across shard boundaries
        into ``out`` (sequential copies)."""
        rows = hi - lo
        if out is None:
            out = np.empty((rows, self.num_features), dtype=self.dtype)
        filled, pos = 0, lo
        s = lo // self.shard_rows if self.shard_rows else 0
        while filled < rows:
            base = s * self.shard_rows
            sh = self.shards[s]
            a = pos - base
            b = min(hi - base, sh.shape[0])
            out[filled:filled + (b - a)] = sh[a:b]
            filled += b - a
            pos += b - a
            s += 1
        return out

    def _by_shard(self, indices: np.ndarray):
        """(shard, positions in ``indices``, local rows) for each shard the
        dataset row ids ``indices`` touch: one stable sort of the shard ids
        (a radix sort of small integers), not one mask pass a shard."""
        if self.num_shards == 1:
            yield 0, slice(None), indices
            return
        sidx = indices // self.shard_rows
        local = indices - sidx * self.shard_rows
        order = np.argsort(sidx.astype(np.uint16 if self.num_shards < 65536
                                       else np.int64), kind="stable")
        ends = np.cumsum(np.bincount(sidx, minlength=self.num_shards))
        lo = 0
        for s, hi in enumerate(ends):
            if hi > lo:
                sel = order[lo:hi]
                yield s, sel, local[sel]
            lo = hi

    def gather_rows(self, indices: np.ndarray,
                    out: Optional[np.ndarray] = None) -> np.ndarray:
        """Arbitrary rows by dataset index (the gather layout's fetch)."""
        if out is None:
            out = np.empty((len(indices), self.num_features),
                           dtype=self.dtype)
        rows = row_view(out)

        def part(lo: int, hi: int) -> None:
            dst = rows[lo:hi]
            for s, sel, local in self._by_shard(indices[lo:hi]):
                dst[sel] = row_view(self.shards[s])[local]

        _in_parts(len(indices), part)
        return out

    def gather_col(self, feature_k: int, indices: np.ndarray) -> np.ndarray:
        """One used-feature column for arbitrary rows (the partition's
        fetch: 1-2 bytes a row)."""
        out = np.empty(len(indices), dtype=self.dtype)

        def part(lo: int, hi: int) -> None:
            dst = out[lo:hi]
            for s, sel, local in self._by_shard(indices[lo:hi]):
                dst[sel] = self.shards[s][local, feature_k]

        _in_parts(len(indices), part)
        return out

    def dataset_order_copy(self) -> np.ndarray:
        """A fresh dataset-order copy of the binned matrix: the host rows
        that ``tree_layout=sorted`` reorders each tree."""
        return np.concatenate(self.shards, axis=0)

    # -- construction --------------------------------------------------
    @classmethod
    def from_dataset(cls, ds: BinnedDataset, shard_rows: int,
                     spill_dir: Optional[str] = None
                     ) -> "ShardedBinnedDataset":
        """Re-shard an already-constructed resident dataset."""
        out = cls()
        out.__dict__.update({k: v for k, v in ds.__dict__.items()
                             if k != "binned"})
        out.shards = []
        out._binned_cache = None
        out.spill_dir = spill_dir or None
        out.shard_rows = max(int(shard_rows), MIN_SHARD_ROWS)
        mat = ds.binned
        lo = 0
        for i, rows in enumerate(_shard_sizes(ds.num_data, out.shard_rows)):
            sh = out._alloc_shard(i, rows, mat.shape[1], mat.dtype)
            sh[:] = mat[lo:lo + rows]
            out.shards.append(sh)
            lo += rows
        return out

    @classmethod
    def from_matrix(cls, data, config: Config, shard_rows: int = 0,
                    spill_dir: Optional[str] = None,
                    **kwargs) -> "ShardedBinnedDataset":
        """Streaming construction from a dense matrix: row blocks of 65,536
        feed the sketches, then are binned straight into shards."""
        data = np.asarray(data)
        if data.ndim != 2:
            log.fatal("Training data must be 2-dimensional, got shape %s",
                      data.shape)

        class _View:
            batch_size = 65536

            def __len__(self) -> int:
                return data.shape[0]

            def __getitem__(self, sl):
                return data[sl]

        return cls.from_sequences([_View()], config, shard_rows=shard_rows,
                                  spill_dir=spill_dir, **kwargs)

    @classmethod
    def from_sequences(cls, seqs, config: Config, shard_rows: int = 0,
                       spill_dir: Optional[str] = None,
                       label=None, weight=None, group=None,
                       init_score=None, position=None,
                       categorical_features=(), feature_names=None,
                       reference: Optional[BinnedDataset] = None
                       ) -> "ShardedBinnedDataset":
        """Streaming construction from row-batch readers: each reader's
        rows feed sketches of its own, merged in reader order (exact below
        the sketch budget, so one reader or many bin alike), then a second
        pass bins every block into the shards. The float matrix never
        exists whole."""
        ds = cls()
        ds.spill_dir = spill_dir or (config.stream_spill_dir or None)
        ds.shard_rows = max(int(shard_rows or config.stream_shard_rows),
                            MIN_SHARD_ROWS)
        lens = [len(s) for s in seqs]
        total = int(sum(lens))
        if total == 0:
            log.fatal("Cannot construct Dataset from empty sequences")
        F = np.asarray(seqs[0][0:1], dtype=np.float64).shape[1]
        ds.num_data, ds.num_total_features = total, F
        ds.max_bin = config.max_bin
        ds.feature_names = (list(feature_names) if feature_names
                            else [f"Column_{i}" for i in range(F)])
        if reference is not None:
            ds._adopt_reference(reference)
        else:
            merged = None
            for s, ln in zip(seqs, lens):
                own = [QuantileSketch(budget=config.stream_sketch_budget)
                       for _ in range(F)]
                for _, blk in _batches(s, ln, 65536):
                    for j in range(F):
                        own[j].push(blk[:, j])
                if merged is None:
                    merged = own
                else:
                    for j in range(F):
                        merged[j].merge(own[j])
            _mappers_from_sketches(ds, merged, config,
                                   set(categorical_features))
        dtype = bin_dtype(ds.feature_num_bins)
        C = len(ds.used_features)
        ds.shards = [ds._alloc_shard(i, rows, C, dtype) for i, rows in
                     enumerate(_shard_sizes(total, ds.shard_rows))]
        device = resolve_device(config.device_type)
        row0 = 0
        for s, ln in zip(seqs, lens):
            for lo, blk in _batches(s, ln, 65536):
                ds._write_rows(row0 + lo, ds._bin_block(blk, device))
            row0 += ln
        ds._attach_metadata(label, weight, group, init_score, position)
        return ds

    def _write_rows(self, row0: int, packed: np.ndarray) -> None:
        """Scatter a binned row block into the fixed-size shards."""
        lo, hi = row0, row0 + packed.shape[0]
        filled = 0
        s = lo // self.shard_rows
        while filled < packed.shape[0]:
            base = s * self.shard_rows
            a = (lo + filled) - base
            b = min(hi - base, self.shards[s].shape[0])
            self.shards[s][a:b] = packed[filled:filled + (b - a)]
            filled += b - a
            s += 1


def as_sharded(ds: BinnedDataset, config: Config) -> ShardedBinnedDataset:
    """``ds`` as host shards for stream training (itself when it is
    one)."""
    if isinstance(ds, ShardedBinnedDataset):
        return ds
    return ShardedBinnedDataset.from_dataset(
        ds, config.stream_shard_rows,
        spill_dir=config.stream_spill_dir or None)


# ---------------------------------------------------------------------------
# the phase clock and the H2D ring
# ---------------------------------------------------------------------------
class PhaseClock:
    """Host-wall totals (seconds) of named phases: ``h2d_prefetch``,
    ``chunk_wait``, ``d2h_scores``. Thread-safe."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.totals: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.totals[name] = self.totals.get(name, 0.0) + dt

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return dict(self.totals)


class _Slot:
    """One ring slot on the card: per window buffer a pinned host byte
    buffer and a device byte buffer, and the slot's two events."""

    def __init__(self) -> None:
        self.host: List[torch.Tensor] = []
        self.dev: List[torch.Tensor] = []
        self.ready = torch.cuda.Event()
        self.done = torch.cuda.Event()

    def ensure(self, i: int, nbytes: int, device: torch.device,
               copy_stream) -> None:
        """Room for ``nbytes`` in buffer ``i`` (grown to a power of two;
        the caller has waited for the slot's last copy)."""
        if i < len(self.host) and self.host[i].numel() >= nbytes:
            return
        cap = 1 << max(int(nbytes - 1).bit_length(), 12)
        host = torch.empty(cap, dtype=torch.uint8, pin_memory=True)
        dev = torch.empty(cap, dtype=torch.uint8, device=device)
        # the copy stream writes it: the allocator must not hand its
        # bytes out again before that stream's work is done
        dev.record_stream(copy_stream)
        if i < len(self.host):
            self.host[i], self.dev[i] = host, dev
        else:
            self.host.append(host)
            self.dev.append(dev)


class ShardRing:
    """Bounded H2D ring of ``depth`` slots (module docstring).

    ``put(key, host_bufs)`` stages a window's numpy buffers and queues
    their copies; ``wait_ready()`` returns ``(key, device tensors)`` of the
    oldest window, its copy complete and ordered before the compute
    stream's next launches; ``release()`` marks the window just returned
    as consumed (the consumer's launches are queued). The device tensors
    are views of the slot: valid until the slot is reused ``depth`` windows
    later."""

    def __init__(self, device: torch.device, depth: int = 2,
                 clock: Optional[PhaseClock] = None) -> None:
        if device.type not in ("cuda", "cpu"):
            raise ValueError(f"ShardRing runs on cuda or cpu, not {device}")
        self.device = device
        self.depth = max(int(depth), 1)
        self.clock = clock if clock is not None else PhaseClock()
        self._queue: deque = deque()
        self._pending: Optional[_Slot] = None
        self.windows = 0
        self.bytes = 0
        if device.type == "cuda":
            self._copy = torch.cuda.Stream(device)
            self._slots = [_Slot() for _ in range(self.depth)]
            self._next = 0

    def __len__(self) -> int:
        return len(self._queue)

    @property
    def full(self) -> bool:
        return len(self._queue) >= self.depth

    def nbytes(self) -> int:
        """Device bytes of the slots' buffers."""
        if self.device.type != "cuda":
            return 0
        return sum(t.numel() for s in self._slots for t in s.dev)

    def put(self, key, host_bufs) -> None:
        with self.clock.phase("h2d_prefetch"):
            self.windows += 1
            self.bytes += sum(int(b.nbytes) for b in host_bufs)
            if self.device.type == "cpu":
                self._queue.append((key, tuple(torch.from_numpy(np.array(b))
                                               for b in host_bufs), None))
                return
            slot = self._slots[self._next]
            self._next = (self._next + 1) % self.depth
            # the slot's last copy has read its pinned bytes
            slot.ready.synchronize()
            # ... and its last consumer is done with its device bytes
            self._copy.wait_event(slot.done)
            views = []
            for i, b in enumerate(host_bufs):
                b = np.ascontiguousarray(b)
                nb = int(b.nbytes)
                slot.ensure(i, nb, self.device, self._copy)
                staged = slot.host[i][:nb].numpy().view(b.dtype)
                staged.reshape(b.shape)[...] = b
                with torch.cuda.stream(self._copy):
                    slot.dev[i][:nb].copy_(slot.host[i][:nb],
                                           non_blocking=True)
                views.append(slot.dev[i][:nb].view(
                    _TORCH_DTYPES[b.dtype]).view(b.shape))
            slot.ready.record(self._copy)
            self._queue.append((key, tuple(views), slot))

    def wait_ready(self):
        """(key, device tensors) of the oldest window."""
        key, bufs, slot = self._queue.popleft()
        with self.clock.phase("chunk_wait"):
            if slot is not None:
                slot.ready.synchronize()
                torch.cuda.current_stream(self.device).wait_event(slot.ready)
        self._pending = slot
        return key, bufs

    def release(self) -> None:
        """The window last returned by :meth:`wait_ready` is consumed: its
        slot's device bytes are free once the compute stream gets here."""
        slot, self._pending = self._pending, None
        if slot is not None:
            slot.done.record(torch.cuda.current_stream(self.device))


class WindowPump:
    """The run-ahead window loop over a :class:`ShardRing`
    (``lambdagap_tpu/data/stream.py:397-451``): iterating yields ``(key,
    device_bufs)`` per window, oldest first; before each yield the ring is
    topped up from ``windows`` (an iterator of ``(key, host_bufs)``), so
    the fetch and copy of window ``c+1`` are queued before window ``c`` is
    waited on. ``gate`` (optional) runs on the host just before each window
    is fetched: the co-tenant throttle's hook."""

    def __init__(self, windows, ring: ShardRing,
                 gate: Optional[Callable[[], None]] = None) -> None:
        self._it = iter(windows)
        self.ring = ring
        self.gate = gate

    def __iter__(self):
        ring = self.ring
        exhausted = False
        while True:
            while not exhausted and (not len(ring) or not ring.full):
                if self.gate is not None:
                    self.gate()
                try:
                    key, bufs = next(self._it)
                except StopIteration:
                    exhausted = True
                    break
                ring.put(key, bufs)
            if not len(ring):
                return
            item = ring.wait_ready()
            try:
                yield item
            finally:
                ring.release()


def stream_windows(nch: int, fetch: Callable, consume: Callable,
                   ring: ShardRing) -> None:
    """Drive ``nch`` windows through ``ring``: ``fetch(c)`` returns window
    ``c``'s host buffers, ``consume(c, *device_bufs)`` launches its work."""
    pump = WindowPump(((c, fetch(c)) for c in range(nch)), ring)
    for key, bufs in pump:
        consume(key, *bufs)
