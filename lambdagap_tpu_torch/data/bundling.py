"""Exclusive Feature Bundling (EFB).

The port of ``lambdagap_tpu/data/bundling.py``: the reference's greedy
conflict-bounded grouping (reference: src/io/dataset.cpp:107 FindGroups,
:246 FastFeatureBundling) over the same row sample, the encoded bundled
matrix, and the map that un-bundles a histogram — all host numpy, equal to
the JAX package's arrays. Mutually exclusive (rarely simultaneously
non-default) features share one stored column, which shrinks the
histograms the learner builds.

The dataset's ``binned`` matrix stays unbundled (validation scoring reads
it); the bundled matrix is a second artifact the fused learner trains on,
whose histograms are un-bundled back to per-feature space before every
split scan (``ops.histogram.unbundle_hist``). A bundle's bin 0 means "every
member at its default bin"; member ``m`` takes bins ``offset_m ..
offset_m + num_bin_m - 2`` for its non-default bins (the rank encoding
skips the default bin). A conflicting row keeps the last member's value:
the bounded corruption the reference accepts (``max_conflict_rate``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..utils import log

MAX_BUNDLE_BINS = 256            # keep bundled columns uint8-addressable
KIND_ZERO, KIND_COPY, KIND_DEFAULT = 0, 1, 2


@dataclass
class Bundle:
    """Bundled matrix + per-feature decode metadata (inner-feature indexed)."""
    cols: np.ndarray             # [N, C] uint8/uint16 bundled matrix
    num_bins: List[int]          # bins per bundled column
    col_of: np.ndarray           # i32 [F] column holding feature f
    off_of: np.ndarray           # i32 [F] rank offset of f inside its column
    single: np.ndarray           # bool [F] column holds only this feature
    members: List[List[int]]     # per column: inner feature indices

    @property
    def num_cols(self) -> int:
        return self.cols.shape[1]


def find_groups(nz: np.ndarray, feature_bins: np.ndarray,
                max_conflict_rate: float,
                max_scan: int = 64) -> List[List[int]]:
    """Greedy conflict-bounded grouping (reference: dataset.cpp:107).

    nz: bool [S, F] sampled non-default mask per feature. Returns the
    bundles as lists of feature indices."""
    S, F = nz.shape
    budget = max_conflict_rate * S
    nz_cnt = nz.sum(axis=0)
    order = np.argsort(-nz_cnt)                # most non-defaults first
    members: List[List[int]] = []
    masks: List[np.ndarray] = []
    cnts: List[int] = []                       # popcount of each mask
    conflicts: List[float] = []
    bins: List[int] = []
    for f in order:
        placed = False
        cnt_f = int(nz_cnt[f])
        for bi in range(min(len(members), max_scan)):
            extra_bins = int(feature_bins[f]) - 1
            if bins[bi] + extra_bins > MAX_BUNDLE_BINS:
                continue
            # pigeonhole lower bound on the conflict count: a candidate that
            # fails on the bound fails on the true count
            if conflicts[bi] + max(0, cnt_f + cnts[bi] - S) > budget:
                continue
            c = int((masks[bi] & nz[:, f]).sum())
            if conflicts[bi] + c <= budget:
                members[bi].append(int(f))
                masks[bi] |= nz[:, f]
                cnts[bi] = int(masks[bi].sum())
                conflicts[bi] += c
                bins[bi] += extra_bins
                placed = True
                break
        if not placed:
            members.append([int(f)])
            masks.append(nz[:, f].copy())
            cnts.append(cnt_f)
            conflicts.append(0.0)
            bins.append(int(feature_bins[f]))
    return members


def build_bundle(binned: np.ndarray, feature_bins: np.ndarray,
                 default_bins: np.ndarray, max_conflict_rate: float,
                 sample_cnt: int = 100_000) -> Optional[Bundle]:
    """Find groups on the JAX package's row sample (every ``N // S``-th
    row) and encode the bundled matrix.

    binned: the UNBUNDLED [N, F] matrix; feature_bins/default_bins are per
    inner feature. Returns None when no multi-feature bundle forms
    (bundling would only add decode work)."""
    N, F = binned.shape
    if F < 2:
        return None
    S = min(N, sample_cnt)
    step = max(N // S, 1)
    sample = binned[::step][:S]
    groups = find_groups(sample != default_bins[None, :], feature_bins,
                         max_conflict_rate)
    if all(len(g) == 1 for g in groups):
        return None

    # singles keep raw bins; multi-member bundles use rank encoding
    C = len(groups)
    max_bins = 2
    col_of = np.zeros(F, np.int32)
    off_of = np.zeros(F, np.int32)
    single = np.zeros(F, bool)
    num_bins_out: List[int] = []
    for ci, g in enumerate(groups):
        if len(g) == 1:
            f = g[0]
            col_of[f] = ci
            single[f] = True
            num_bins_out.append(int(feature_bins[f]))
        else:
            off = 1
            for f in g:
                col_of[f] = ci
                off_of[f] = off
                off += int(feature_bins[f]) - 1
            num_bins_out.append(off)
        max_bins = max(max_bins, num_bins_out[-1])

    dtype = np.uint8 if max_bins <= 256 else np.uint16
    cols = np.zeros((N, C), dtype=dtype)
    for ci, g in enumerate(groups):
        if len(g) == 1:
            cols[:, ci] = binned[:, g[0]].astype(dtype)
            continue
        for f in g:
            b = binned[:, f].astype(np.int32)
            d = int(default_bins[f])
            nzm = b != d
            rank = b - (b > d)
            cols[nzm, ci] = (off_of[f] + rank[nzm]).astype(dtype)
    log.info("EFB bundled %d features into %d columns "
             "(max %d bins per column)", F, C, max_bins)
    return Bundle(cols=cols, num_bins=num_bins_out, col_of=col_of,
                  off_of=off_of, single=single, members=groups)


def unbundle_map(bundle: Bundle, feature_bins: np.ndarray,
                 default_bins: np.ndarray, B: int, Bb: int):
    """The histogram un-bundling gather.

    Returns (src[F, B] i32 into the flattened [C*Bb] bundle histogram,
    kind[F, B] u8 in {ZERO, COPY, DEFAULT}): COPY bins gather straight from
    the bundle histogram; a bundled feature's default bin is the residual
    ``leaf_total - sum(its COPY bins)`` (rows whose winner was another
    member sit in other bins of the shared column)."""
    F = len(bundle.col_of)
    src = np.zeros((F, B), np.int32)
    kind = np.zeros((F, B), np.uint8)
    for f in range(F):
        nb = int(feature_bins[f])
        ci = int(bundle.col_of[f])
        if bundle.single[f]:
            src[f, :nb] = ci * Bb + np.arange(nb)
            kind[f, :nb] = KIND_COPY
            continue
        d = int(default_bins[f])
        for b in range(nb):
            if b == d:
                kind[f, b] = KIND_DEFAULT
            else:
                rank = b - (1 if b > d else 0)
                src[f, b] = ci * Bb + int(bundle.off_of[f]) + rank
                kind[f, b] = KIND_COPY
    return src, kind
