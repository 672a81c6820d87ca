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
kernels read without a row list.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

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


def split_partition_sorted(perm: torch.Tensor, rows: torch.Tensor,
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
    back: no allocation of a window a split. Returns the left count, a 0-d
    int64 tensor on the device (no host read)."""
    dest, left_count = _stable_dest(go_left)
    for t, dim in ((_words(rows), 0), *((_bits(c), -1)
                                        for c in (perm, *chans))):
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
