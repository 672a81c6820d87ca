"""Leaf data partition.

The port of ``lambdagap_tpu/ops/partition.py``: the analog of the
reference's ``DataPartition`` (reference:
src/treelearner/data_partition.hpp:21-123) — a permutation of row indices
grouped by leaf; splitting a leaf stably partitions its slice. Plain torch
ops on the permutation's device (the JAX package did this in XLA, not in a
Pallas kernel): the left rows keep their order at the front of the slice,
the right rows keep theirs behind them.
"""
from __future__ import annotations

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


def split_partition(perm: torch.Tensor, begin: int, count: int,
                    go_left: torch.Tensor):
    """Stably partition ``perm[begin:begin+count]`` by ``go_left`` (bool
    [count]) in place. Returns the left count as a 0-d int64 tensor on the
    permutation's device (no host read)."""
    rows = perm[begin:begin + count]
    gl = go_left.long()
    left_count = gl.sum()
    lpos = torch.cumsum(gl, 0) - 1
    rpos = left_count + torch.cumsum(1 - gl, 0) - 1
    out = torch.empty_like(rows)
    out[torch.where(go_left, lpos, rpos)] = rows
    perm[begin:begin + count] = out
    return left_count
