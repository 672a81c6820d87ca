"""Exclusive Feature Bundling (EFB): the grouping decision.

The port of the grouping half of ``lambdagap_tpu/data/bundling.py``: the
reference's greedy conflict-bounded grouping (reference:
src/io/dataset.cpp:107 FindGroups, :246 FastFeatureBundling) over the same
row sample, so the port decides exactly as the JAX package does whether a
multi-feature bundle forms. Dense data forms none. Training over bundled
columns (the encoded matrix and the histogram un-bundling) waits for a
later slice: the learner refuses a dataset whose grouping forms a bundle.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

MAX_BUNDLE_BINS = 256            # keep bundled columns uint8-addressable


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
                 sample_cnt: int = 100_000) -> Optional[List[List[int]]]:
    """Find groups on the JAX package's row sample (every ``N // S``-th
    row). Returns the groups when a multi-feature bundle forms, else None
    (no bundling)."""
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
    return groups
