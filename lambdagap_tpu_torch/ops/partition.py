"""Leaf data partition.

The port of ``lambdagap_tpu/ops/partition.py``: the analog of the
reference's ``DataPartition`` (reference:
src/treelearner/data_partition.hpp:21-123) — a permutation of row indices
grouped by leaf; splitting a leaf stably partitions its slice. Plain torch
ops on the permutation's device (the JAX package did this in XLA, not in a
Pallas kernel): the left rows keep their order at the front of the slice,
the right rows keep theirs behind them.

The learners hold their rows in one of two layouts with the same methods:
:class:`GatherRows` (``tree_layout=gather``) reads a leaf through its
slice of the permutation; :class:`SortedRows` (``tree_layout=sorted``,
:func:`split_partition_sorted`) applies the same stable partition to the
rows themselves — leaf-ordered copies of the binned matrix and of the
per-row channels — so that a leaf is a contiguous window the histogram
kernels read without a row list. :class:`StreamRows`
(``data_residency=stream``) keeps the binned matrix in host shards
(``data.stream.ShardedBinnedDataset``) and the rest on the device: the
split column is gathered on the host and uploaded, a split reads its
go-left flags back to keep the host's mirror of the permutation (or, under
sorted, the host's leaf-ordered rows) in step, and a histogram is a loop
over uploaded windows (:meth:`StreamRows.histogram`).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .split import MT_NAN, MT_ZERO


def decision_go_left(bin_vals: torch.Tensor, threshold, default_left,
                     default_bin, missing_type, num_bin, is_categorical,
                     cat_bitset: torch.Tensor) -> torch.Tensor:
    """Routing decision for bin values of one feature (reference: Bin::Split,
    src/io/dense_bin.hpp; tree.h Decision): numerical goes left iff
    ``bin <= threshold``, rows in the missing bin follow ``default_left``,
    categorical goes left iff its bin is set in ``cat_bitset`` (int64 words
    holding u32 values). The split fields may be Python scalars or 0-d
    tensors on the bins' device."""
    b = bin_vals.long()
    is_missing = torch.where(
        torch.as_tensor(missing_type == MT_ZERO, device=b.device),
        b == default_bin,
        torch.as_tensor(missing_type == MT_NAN, device=b.device)
        & (b == num_bin - 1))
    num_left = torch.where(is_missing, default_left, b <= threshold)
    word = torch.clamp(b // 32, 0, cat_bitset.shape[-1] - 1)
    cat_left = ((cat_bitset[word] >> (b % 32)) & 1) == 1
    return torch.where(torch.as_tensor(is_categorical, device=b.device),
                       cat_left, num_left)


def decode_bundled(cv: torch.Tensor, offset: int, default_bin: int,
                   num_bin: int) -> torch.Tensor:
    """A bundled feature's own bins from its EFB bundle column
    (``lambdagap_tpu/models/fused_learner.py:1196-1202``): the column holds
    ``offset + rank`` for the feature's non-default bins, where the rank
    skips the default bin; every other value (0, or another member's
    range) is the feature's default bin."""
    r = cv.long() - offset
    in_r = (r >= 0) & (r < num_bin - 1)
    return torch.where(in_r, r + (r >= default_bin).long(),
                       torch.full_like(r, default_bin))


def _stable_dest(go_left: torch.Tensor):
    """(each position's place in the stably partitioned slice, the left
    count), int64 on the device: the left rows first, each side in slice
    order."""
    gl = go_left.long()
    left_count = gl.sum()
    lpos = torch.cumsum(gl, 0) - 1
    rpos = left_count + torch.cumsum(1 - gl, 0) - 1
    return torch.where(go_left, lpos, rpos), left_count


def split_partition(perm: torch.Tensor, begin: int, count: int,
                    go_left: torch.Tensor):
    """Stably partition ``perm[begin:begin+count]`` by ``go_left`` (bool
    [count]) in place. Returns the left count as a 0-d int64 tensor on the
    permutation's device (no host read)."""
    rows = perm[begin:begin + count]
    dest, left_count = _stable_dest(go_left)
    out = torch.empty_like(rows)
    out[dest] = rows
    perm[begin:begin + count] = out
    return left_count


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The same bytes under a type every index op takes on every device:
    torch's CUDA index ops have no uint16, and bool moves as uint8."""
    if t.dtype == torch.uint16:
        return t.view(torch.int16)
    if t.dtype == torch.bool:
        return t.view(torch.uint8)
    return t


def _words(rows: torch.Tensor) -> torch.Tensor:
    """Rows ``[N, C]`` as the widest integer words their row bytes divide
    into (28 u8 bins: 7 int32), so a move handles a few words a row, not
    every byte."""
    nbytes = rows.shape[-1] * rows.element_size()
    for dtype in (torch.int64, torch.int32, torch.int16):
        size = torch.empty((), dtype=dtype).element_size()
        if nbytes % size == 0 and size >= rows.element_size():
            return rows.view(dtype)
    return _bits(rows)


def split_partition_sorted(perm: torch.Tensor, rows: Optional[torch.Tensor],
                           chans: Sequence[torch.Tensor],
                           scratch: Dict[tuple, torch.Tensor], begin: int,
                           count: int, go_left: torch.Tensor):
    """:func:`split_partition` under ``tree_layout=sorted``
    (``lambdagap_tpu/ops/partition.py:86-141``): the stable partition of
    the leaf ``[begin, begin + count)`` is applied to the permutation AND
    physically to the leaf-ordered rows ``rows`` ``[N, C]`` and to each
    channel of ``chans`` (``[..., N]``, positions last: grad/hess or their
    int8 levels, the in-bag mask), so both children stay contiguous
    windows. Each buffer's window is scattered into a persistent scratch
    buffer of its shape (``scratch``, filled on first use; the JAX
    learner's double buffer, ``fused_learner.py:1622-1631``) and copied
    back: no allocation of a window a split. ``rows`` None: the rows are
    not on the device (:class:`StreamRows`). Returns the left count, a 0-d
    int64 tensor on the device (no host read)."""
    dest, left_count = _stable_dest(go_left)
    moves = [(_bits(c), -1) for c in (perm, *chans)]
    if rows is not None:
        moves.insert(0, (_words(rows), 0))
    for t, dim in moves:
        key = (tuple(t.shape), t.dtype, t.device)
        if key not in scratch:
            scratch[key] = torch.empty_like(t)
        win = t.narrow(dim, begin, count)
        tmp = scratch[key].narrow(dim, 0, count)
        tmp.index_copy_(dim, dest, win)
        win.copy_(tmp)
    return left_count


class GatherRows:
    """``tree_layout=gather``: the rows stay in dataset order and a leaf is
    its slice of the permutation. The histogram kernels read a leaf's rows
    through that slice (the root, every row in order, with no row list);
    the partition reads the split column from a column-major copy of the
    rows (the JAX package's ``x_cols``; u16 widens to int32, since torch
    indexes no u16 everywhere). :class:`SortedRows` has the same methods,
    so the learners do not branch on the layout."""

    def __init__(self, x_rows: torch.Tensor) -> None:
        self.x_rows = x_rows
        cols = x_rows.T.contiguous()
        self.x_cols = cols if cols.dtype == torch.uint8 else cols.int()
        self.a = self.b = self.mask = None

    # host reads the layout made for the last tree (StreamRows makes some)
    reads = 0

    def nbytes(self) -> int:
        """Device bytes of the column-major copy."""
        return self.x_cols.numel() * self.x_cols.element_size()

    def rebuild(self, a: torch.Tensor, b: torch.Tensor,
                mask: Optional[torch.Tensor]) -> None:
        """The tree's channels ``a``, ``b`` [N] (grad/hess, or their int8
        levels) and in-bag mask (None: every row), kept as they are."""
        self.a, self.b, self.mask = a, b, mask

    def kernel_inputs(self, perm: torch.Tensor, begin: int, count: int,
                      whole: bool):
        """(bins, a, b, row list, mask) of the leaf ``[begin, begin +
        count)`` for a histogram kernel: its slice of the permutation; none
        for the root read whole (every row, in order)."""
        root = whole and count == self.x_rows.shape[0]
        return (self.x_rows, self.a, self.b,
                None if root else perm[begin:begin + count], self.mask)

    def column(self, perm: torch.Tensor, begin: int, count: int,
               col: int) -> torch.Tensor:
        """Column ``col`` of the leaf's rows, gathered through the
        permutation."""
        return self.x_cols[col][perm[begin:begin + count].long()]

    def split(self, perm: torch.Tensor, begin: int, count: int,
              go_left: torch.Tensor):
        """:func:`split_partition`. Returns the left count (device)."""
        return split_partition(perm, begin, count, go_left)


class SortedRows:
    """``tree_layout=sorted``: leaf-ordered copies of a learner's binned
    rows and per-row channels, each leaf's rows at its ``[begin, begin +
    count)`` (the JAX package's ``x_sorted`` / ``gh_sorted``,
    ``lambdagap_tpu/models/learner.py:773-790``, and the fused learner's
    ``srows``), with :class:`GatherRows`'s methods. The buffers persist
    across trees; each tree starts from the identity permutation, so
    :meth:`rebuild` is straight copies, no gather. Everything that depends
    on the order of the rows (the quantizer's per-row draws, the sampling
    masks, the fixed-point scale, any float reduction) is computed in
    dataset order before; these copies are only what the histogram kernels
    and the partition read. The permutation is kept as under gather, and
    moved with them."""

    def __init__(self, x_rows: torch.Tensor) -> None:
        self.x_rows = x_rows
        self.x = torch.empty_like(x_rows)
        # the partition's scratch buffers, one per buffer shape (the rows'
        # made now, so the resident count holds it from the start)
        self.scratch: Dict[tuple, torch.Tensor] = {}
        wx = _words(self.x)
        self.scratch[(tuple(wx.shape), wx.dtype, wx.device)] = \
            torch.empty_like(wx)
        self._bufs: Dict[tuple, torch.Tensor] = {}
        self.ch: Optional[torch.Tensor] = None
        self.mask: Optional[torch.Tensor] = None

    reads = 0

    def nbytes(self) -> int:
        """Device bytes of the copies and the scratch made so far."""
        ts = [self.x, *self.scratch.values(), *self._bufs.values()]
        return sum(t.numel() * t.element_size() for t in ts)

    def _buf(self, shape: tuple, dtype: torch.dtype) -> torch.Tensor:
        key = (shape, dtype)
        if key not in self._bufs:
            self._bufs[key] = torch.empty(shape, dtype=dtype,
                                          device=self.x.device)
        return self._bufs[key]

    def rebuild(self, a: torch.Tensor, b: torch.Tensor,
                mask: Optional[torch.Tensor]) -> None:
        """The tree's copies at the identity permutation: the rows, the two
        channels ``a``, ``b`` [N] (grad/hess, or their int8 levels) as one
        ``[2, N]`` buffer, and the in-bag mask (None: every row)."""
        _words(self.x).copy_(_words(self.x_rows))
        self.ch = self._buf((2, a.shape[0]), a.dtype)
        self.ch[0].copy_(a)
        self.ch[1].copy_(b)
        self.mask = None
        if mask is not None:
            self.mask = self._buf(tuple(mask.shape), torch.bool)
            self.mask.copy_(mask)

    def kernel_inputs(self, perm: torch.Tensor, begin: int, count: int,
                      whole: bool):
        """(bins, a, b, row list, mask) of the leaf ``[begin, begin +
        count)``: contiguous windows of the copies and no row list."""
        end = begin + count
        return (self.x[begin:end], self.ch[0, begin:end],
                self.ch[1, begin:end], None,
                None if self.mask is None else self.mask[begin:end])

    def column(self, perm: torch.Tensor, begin: int, count: int,
               col: int) -> torch.Tensor:
        """Column ``col`` of the leaf's window (no gather through the
        permutation, no column-major copy)."""
        c = _bits(self.x)[begin:begin + count, col]
        return c.int() & 0xFFFF if self.x.dtype == torch.uint16 else c

    def split(self, perm: torch.Tensor, begin: int, count: int,
              go_left: torch.Tensor):
        """:func:`split_partition_sorted` over the permutation, the rows,
        the channels and the mask. Returns the left count (device)."""
        chans = [self.ch] + ([] if self.mask is None else [self.mask])
        return split_partition_sorted(perm, self.x, chans, self.scratch,
                                      begin, count, go_left)


class StreamRows:
    """``data_residency=stream``: the binned matrix stays in host shards
    (``data.stream.ShardedBinnedDataset``); the device holds the tree's
    channels, the mask and the permutation, as under the resident
    layouts, with :class:`GatherRows`'s methods (the JAX package's stream
    mode, ``lambdagap_tpu/models/learner.py:577-760`` and
    ``fused_learner.py:2038-2215``).

    * ``tree_layout=gather``: the host keeps a mirror of the permutation
      (``perm_host``). A window of a leaf is its rows gathered from the
      shards on the host; on the device its channels and mask are gathered
      into window order through the device permutation's same slice, and
      K1 reads the window with no row list.
    * ``tree_layout=sorted``: the host keeps a leaf-ordered copy of the
      binned rows (``payload``, the JAX learner's ``_x_sorted_host``) and
      the device leaf-ordered channels and mask (as :class:`SortedRows`
      keeps them); a window of a leaf is a contiguous slice of each.

    :meth:`column` gathers the split column's bins on the host and uploads
    them; :meth:`split` partitions the device permutation (and, under
    sorted, the channels and mask) stably as the resident layouts do, reads
    the go-left flags back (one host read a split) and reorders the host
    mirror the same way. ``clock`` adds up the host wall of ``host_read``
    (those reads) and ``host_mirror`` (the reorders) beside the ring's
    phases. :meth:`histogram` pumps the leaf's windows
    through the H2D ring (``data.stream.ShardRing``, ``depth`` slots) and
    adds each into one int64 accumulator with K1's accumulate mode
    (``ops.hist_cuda.hist_rows_add``), rounded once at the end: integer
    sums of the same rows at the tree's scale, so the histogram equals the
    resident one bit for bit, whatever the windows.

    With an in-bag mask and ``compact`` (``stream_goss_compact``) the mask
    is read to the host once a tree and a window carries only its in-bag
    rows (their bins, and their row ids or lanes for the device gathers):
    the out-of-bag rows would add exact zeros.
    """

    def __init__(self, sdata, device: torch.device, layout: str, depth: int,
                 window_rows: int, compact: bool) -> None:
        from ..data.stream import PhaseClock, ShardRing
        self.sdata = sdata
        self.device = device
        self.sorted = layout == "sorted"
        self.window = max(int(window_rows), 1)
        self.compact = bool(compact)
        self.clock = PhaseClock()
        self.ring = ShardRing(device, depth, self.clock)
        self.reads = 0
        self.a = self.b = self.mask = None
        self.ch: Optional[torch.Tensor] = None
        self.perm_host: Optional[np.ndarray] = None
        self.payload: Optional[np.ndarray] = None
        self.mask_host: Optional[np.ndarray] = None
        self.scratch: Dict[tuple, torch.Tensor] = {}
        self._last = (-1, -1, 0)

    def nbytes(self) -> int:
        """Device bytes of the ring's slots, the sorted channels and the
        partition's scratch."""
        ts = [*self.scratch.values()]
        if self.sorted:
            ts += [t for t in (self.ch, self.mask) if t is not None]
        return self.ring.nbytes() + sum(t.numel() * t.element_size()
                                        for t in ts)

    def rebuild(self, a: torch.Tensor, b: torch.Tensor,
                mask: Optional[torch.Tensor]) -> None:
        """The tree's channels and mask, and the host mirror at the
        identity permutation; under compaction, the mask read once."""
        self.reads = 0
        N = self.sdata.num_data
        if self.sorted:
            self.payload = self.sdata.dataset_order_copy()
            self.ch = torch.stack([a, b])
            self.mask = None if mask is None else mask.clone()
        else:
            self.perm_host = np.arange(N, dtype=np.int64)
            self.a, self.b, self.mask = a, b, mask
        self.mask_host = None
        if mask is not None and self.compact:
            with self.clock.phase("host_read"):
                self.mask_host = mask.cpu().numpy().astype(bool)
            self.reads += 1

    def column(self, perm: torch.Tensor, begin: int, count: int,
               col: int) -> torch.Tensor:
        """Column ``col`` of the leaf's rows, from the host, uploaded."""
        with self.clock.phase("h2d_prefetch"):
            if self.sorted:
                vals = self.payload[begin:begin + count, col]
            else:
                vals = self.sdata.gather_col(
                    col, self.perm_host[begin:begin + count])
            if vals.dtype == np.uint16:
                vals = vals.astype(np.int32)
            return torch.from_numpy(np.ascontiguousarray(vals)).to(
                self.device)

    def split(self, perm: torch.Tensor, begin: int, count: int,
              go_left: torch.Tensor):
        """The resident layouts' stable partition on the device, then the
        go-left flags read back (one host read) and the host mirror moved
        the same way. Returns the left count (device)."""
        if self.sorted:
            chans = [self.ch] + ([] if self.mask is None else [self.mask])
            lc = split_partition_sorted(perm, None, chans, self.scratch,
                                        begin, count, go_left)
        else:
            lc = split_partition(perm, begin, count, go_left)
        from ..data.stream import row_view, take_rows
        with self.clock.phase("host_read"):
            gl = go_left.cpu().numpy()
        self.reads += 1
        with self.clock.phase("host_mirror"):
            order = np.concatenate([np.flatnonzero(gl),
                                    np.flatnonzero(~gl)])
            mirrors = ([row_view(self.payload)] if self.sorted
                       else [self.perm_host])
            if self.mask_host is not None and self.sorted:
                mirrors.append(self.mask_host)
            for m in mirrors:
                m[begin:begin + count] = take_rows(m[begin:begin + count],
                                                   order)
        self._last = (begin, count, int(gl.sum()))
        return lc

    def child(self, begin: int, count: int):
        """(begin, count) of the smaller child of the leaf ``[begin, begin
        + count)``, which must be the last leaf :meth:`split` split: both
        learners build exactly that child's histogram after a split (the
        device ``live`` / ``offset`` they pass name it too)."""
        b, c, lc = self._last
        if (b, c) != (begin, count):
            raise RuntimeError("StreamRows: a child histogram of a leaf "
                               "that was not the last split")
        return (begin, lc) if lc <= count - lc else (begin + lc, count - lc)

    def _fetch(self, lo: int, live: int):
        """Host buffers of positions [lo, lo + live): the bins and, when
        compacted, the in-bag rows' row ids (gather) or lanes (sorted)."""
        from ..data.stream import row_view, take_rows
        C = self.sdata.num_features
        if self.sorted:
            if self.mask_host is None:
                return (self.payload[lo:lo + live],)
            lanes = np.flatnonzero(self.mask_host[lo:lo + live])
            rows = take_rows(row_view(self.payload), lo + lanes)
            return (rows.view(self.payload.dtype).reshape(-1, C),
                    lanes.astype(np.int32))
        rows = self.perm_host[lo:lo + live]
        if self.mask_host is not None:
            rows = rows[self.mask_host[rows]]
            out = np.empty((len(rows), C), dtype=self.sdata.dtype)
            return (self.sdata.gather_rows(rows, out=out),
                    rows.astype(np.int32))
        return (self.sdata.gather_rows(rows),)

    def histogram(self, perm: torch.Tensor, begin: int, count: int,
                  num_bins: int, scale: torch.Tensor) -> torch.Tensor:
        """f32 ``[F, num_bins, 3]`` histogram of the leaf ``[begin, begin +
        count)``, its windows pumped through the ring into K1's accumulate
        mode (``scale``: the tree's exponents over all rows)."""
        from ..data.stream import WindowPump
        from .hist_cuda import hist_acc, hist_finish, hist_rows_add
        acc = hist_acc(self.sdata.num_features, num_bins, self.device)
        W = self.window
        spans = [(lo, min(W, begin + count - lo))
                 for lo in range(begin, begin + count, W)]

        def windows():
            for lo, live in spans:
                with self.clock.phase("h2d_prefetch"):
                    bufs = self._fetch(lo, live)
                yield (lo, live), bufs

        for (lo, live), bufs in WindowPump(windows(), self.ring):
            bins = bufs[0]
            n = bins.shape[0]
            if n == 0:
                continue
            m = None
            if len(bufs) == 2:            # compacted: in-bag rows only
                idx = bufs[1].long()
                if self.sorted:
                    idx = idx + lo
                    g, h = self.ch[0][idx], self.ch[1][idx]
                else:
                    g, h = self.a[idx], self.b[idx]
            elif self.sorted:
                g, h = self.ch[0, lo:lo + n], self.ch[1, lo:lo + n]
                m = None if self.mask is None else self.mask[lo:lo + n]
            else:
                rows = perm[lo:lo + n].long()
                g, h = self.a[rows], self.b[rows]
                m = None if self.mask is None else self.mask[rows]
            hist_rows_add(acc, bins, g, h, None, n, num_bins, scale, m)
        return hist_finish(acc, scale)
