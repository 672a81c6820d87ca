"""Per-feature value->bin mapping.

A copy of the JAX package's ``data/binning.py`` (the port imports nothing of
it): the reference's ``BinMapper`` (reference: src/io/bin.cpp:78-470,
include/LightGBM/bin.h:85-233) — greedy equal-count bin finding over
sampled values, zero as its own bin, missing types None/Zero/NaN,
categorical bins sorted by count.

Host-side numpy, arithmetic unchanged, so bin boundaries equal the JAX
package's exactly. The binned matrix is uploaded to the device by the
learner; see :mod:`lambdagap_tpu_torch.data.dataset`. The streaming
:class:`QuantileSketch` (the JAX package's, :426) finds the same boundaries
from row batches, exact below its budget and compacted above it with the
same float64 numpy steps.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

# Values with |v| <= kZeroThreshold are "zero" (reference: include/LightGBM/bin.h kZeroThreshold)
K_ZERO_THRESHOLD = 1e-35

MISSING_NONE = "None"
MISSING_ZERO = "Zero"
MISSING_NAN = "NaN"

BIN_NUMERICAL = "numerical"
BIN_CATEGORICAL = "categorical"


def _compress_distinct(distinct: np.ndarray, counts: np.ndarray,
                       target: int):
    """Merge adjacent distinct values into ~``target`` equal-count groups so
    the greedy boundary loop below stays O(target) regardless of sample
    cardinality. Each group is represented by its largest member (the
    midpoint-based boundaries shift by less than one group width)."""
    if len(distinct) <= target:
        return distinct, counts
    csum = np.cumsum(counts)
    edges = np.searchsorted(csum, np.linspace(0, csum[-1], target + 1)[1:],
                            side="left")
    edges = np.unique(np.clip(edges, 0, len(distinct) - 1))
    group_counts = np.diff(np.concatenate([[0], csum[edges]]))
    keep = group_counts > 0
    return distinct[edges][keep], group_counts[keep].astype(np.int64)


def _greedy_find_bin(distinct_values: np.ndarray, counts: np.ndarray,
                     max_bin: int, total_cnt: int, min_data_in_bin: int) -> List[float]:
    """Equal-count greedy bin boundary search
    (reference: src/io/bin.cpp:78-155 GreedyFindBin)."""
    if len(distinct_values) > 8 * max_bin:
        distinct_values, counts = _compress_distinct(
            distinct_values, counts, 8 * max_bin)
    num_distinct = len(distinct_values)
    bounds: List[float] = []
    if num_distinct == 0:
        return [np.inf]
    if num_distinct <= max_bin:
        cur_cnt = 0
        for i in range(num_distinct - 1):
            cur_cnt += counts[i]
            if cur_cnt >= min_data_in_bin:
                val = float(np.nextafter((distinct_values[i] + distinct_values[i + 1]) / 2.0,
                                         np.inf))
                if not bounds or val > bounds[-1]:
                    bounds.append(val)
                    cur_cnt = 0
        bounds.append(np.inf)
        return bounds
    if min_data_in_bin > 0:
        max_bin = max(1, min(max_bin, int(total_cnt // min_data_in_bin)))
    mean_bin_size = total_cnt / max_bin
    is_big = counts >= mean_bin_size
    rest_bin_cnt = max_bin - int(is_big.sum())
    rest_sample_cnt = int(total_cnt - counts[is_big].sum())
    mean_bin_size = rest_sample_cnt / max(rest_bin_cnt, 1)

    upper: List[float] = []
    lower: List[float] = [float(distinct_values[0])]
    cur_cnt = 0
    for i in range(num_distinct - 1):
        if not is_big[i]:
            rest_sample_cnt -= counts[i]
        cur_cnt += counts[i]
        if (is_big[i] or cur_cnt >= mean_bin_size
                or (is_big[i + 1] and cur_cnt >= max(1.0, mean_bin_size * 0.5))):
            upper.append(float(distinct_values[i]))
            lower.append(float(distinct_values[i + 1]))
            if len(upper) >= max_bin - 1:
                break
            cur_cnt = 0
            if not is_big[i]:
                rest_bin_cnt -= 1
                mean_bin_size = rest_sample_cnt / max(rest_bin_cnt, 1)
    for i in range(len(upper)):
        val = float(np.nextafter((upper[i] + lower[i + 1]) / 2.0, np.inf))
        if not bounds or val > bounds[-1]:
            bounds.append(val)
    bounds.append(np.inf)
    return bounds


def _find_bin_zero_as_one_bin(distinct_values: np.ndarray, counts: np.ndarray,
                              max_bin: int, total_cnt: int,
                              min_data_in_bin: int,
                              forced_bounds: Sequence[float] = ()) -> List[float]:
    """Zero gets its own bin; negative/positive parts binned separately
    (reference: src/io/bin.cpp:244-300 FindBinWithZeroAsOneBin)."""
    if forced_bounds:
        # Forced bounds: use them as mandatory boundaries, fill the rest greedily
        # (reference: src/io/bin.cpp:157-243 FindBinWithPredefinedBin).
        return _find_bin_with_forced(distinct_values, counts, max_bin, total_cnt,
                                     min_data_in_bin, forced_bounds)
    left_mask = distinct_values <= -K_ZERO_THRESHOLD
    right_mask = distinct_values > K_ZERO_THRESHOLD
    left_cnt_data = int(counts[left_mask].sum())
    right_cnt_data = int(counts[right_mask].sum())
    cnt_zero = int(total_cnt - left_cnt_data - right_cnt_data)

    right_start = int(np.argmax(right_mask)) if right_mask.any() else -1

    bounds: List[float] = []
    left_cnt = int(left_mask.sum())
    if left_cnt > 0:
        left_max_bin = max(1, int(left_cnt_data / max(total_cnt - cnt_zero, 1)
                                  * (max_bin - 1)))
        bounds = _greedy_find_bin(distinct_values[:left_cnt], counts[:left_cnt],
                                  left_max_bin, left_cnt_data, min_data_in_bin)
        bounds[-1] = -K_ZERO_THRESHOLD
    if right_start >= 0:
        right_max_bin = max_bin - 1 - len(bounds)
        if right_max_bin > 0:
            right_bounds = _greedy_find_bin(distinct_values[right_start:],
                                            counts[right_start:],
                                            right_max_bin, right_cnt_data,
                                            min_data_in_bin)
            bounds.append(K_ZERO_THRESHOLD)
            bounds.extend(right_bounds)
        else:
            bounds.append(np.inf)
    else:
        bounds.append(np.inf)
    # dedupe ascending
    out: List[float] = []
    for b in bounds:
        if not out or b > out[-1]:
            out.append(b)
    if out[-1] != np.inf:
        out.append(np.inf)
    return out


def _find_bin_with_forced(distinct_values: np.ndarray, counts: np.ndarray,
                          max_bin: int, total_cnt: int, min_data_in_bin: int,
                          forced_bounds: Sequence[float]) -> List[float]:
    """(reference: src/io/bin.cpp:157-243 FindBinWithPredefinedBin.)

    The +-kZeroThreshold zero bounds are inserted FIRST (when values exist
    on that side), before any forced bound, so zero rows never share a bin
    with nonzero values; forced bounds inside the zero band are dropped for
    the same reason."""
    bounds: List[float] = []
    has_left = bool((distinct_values <= -K_ZERO_THRESHOLD).any())
    has_right = bool((distinct_values > K_ZERO_THRESHOLD).any())
    if max_bin == 2:
        bounds.append(K_ZERO_THRESHOLD if not has_left else -K_ZERO_THRESHOLD)
    elif max_bin >= 3:
        if has_left:
            bounds.append(-K_ZERO_THRESHOLD)
        if has_right:
            bounds.append(K_ZERO_THRESHOLD)

    # forced bounds, excluding the zero band (already bounded above)
    forced = sorted(set(float(b) for b in forced_bounds
                        if abs(float(b)) > K_ZERO_THRESHOLD))
    max_to_insert = max_bin - 1 - len(bounds)
    bounds.extend(forced[:max(max_to_insert, 0)])
    bounds = sorted(set(bounds))

    # distribute remaining bins among the fixed intervals by sample count
    free = max_bin - 1 - len(bounds)
    if free > 0:
        edges = [-np.inf] + bounds + [np.inf]
        extra: List[float] = []
        for i, (lo, hi) in enumerate(zip(edges[:-1], edges[1:])):
            seg = (distinct_values > lo) & (distinct_values <= hi)
            if not seg.any():
                continue
            seg_cnt = int(counts[seg].sum())
            remaining = free - len(extra)
            if i == len(edges) - 2:
                seg_bins = remaining + 1
            else:
                seg_bins = min(int(round(free * seg_cnt
                                         / max(total_cnt, 1))),
                               remaining) + 1
            if seg_bins <= 1:
                continue
            seg_bounds = _greedy_find_bin(distinct_values[seg], counts[seg],
                                          seg_bins, seg_cnt, min_data_in_bin)
            extra.extend(b for b in seg_bounds
                         if b != np.inf and lo < b <= hi)
        bounds.extend(extra)
    bounds = sorted(set(bounds))
    bounds.append(np.inf)
    return bounds


@dataclass
class BinMapper:
    """Maps raw feature values to bin indices (reference: include/LightGBM/bin.h:85)."""

    bin_type: str = BIN_NUMERICAL
    missing_type: str = MISSING_NONE
    bin_upper_bound: List[float] = field(default_factory=list)
    # categorical
    bin_2_categorical: List[int] = field(default_factory=list)
    categorical_2_bin: Dict[int, int] = field(default_factory=dict)
    num_bin: int = 1
    default_bin: int = 0          # bin that value 0.0 falls into
    most_freq_bin: int = 0
    min_val: float = 0.0
    max_val: float = 0.0
    is_trivial: bool = False

    # ------------------------------------------------------------------
    @classmethod
    def find_bin(cls, sample_values: np.ndarray, total_sample_cnt: int,
                 max_bin: int, min_data_in_bin: int,
                 bin_type: str = BIN_NUMERICAL,
                 use_missing: bool = True, zero_as_missing: bool = False,
                 forced_bounds: Sequence[float] = ()) -> "BinMapper":
        """Build a mapper from sampled values. ``sample_values`` contains only
        the *non-zero* sampled entries (sparse convention of the reference:
        src/io/bin.cpp:302+ FindBin); zero count is inferred from
        ``total_sample_cnt``. NaNs may be present.
        """
        vals = np.asarray(sample_values, dtype=np.float64)
        na_mask = np.isnan(vals)
        na_cnt = int(na_mask.sum())
        non_na = vals[~na_mask]
        if len(non_na) > 0:
            distinct, counts = _distinct_with_counts(np.sort(non_na))
        else:
            distinct, counts = np.empty(0), np.empty(0, dtype=np.int64)
        return cls.find_bin_distinct(
            distinct, counts, nonzero_cnt=len(non_na), na_cnt=na_cnt,
            total_sample_cnt=total_sample_cnt, max_bin=max_bin,
            min_data_in_bin=min_data_in_bin, bin_type=bin_type,
            use_missing=use_missing, zero_as_missing=zero_as_missing,
            forced_bounds=forced_bounds)

    @classmethod
    def find_bin_distinct(cls, distinct: np.ndarray, counts: np.ndarray,
                          nonzero_cnt: int, na_cnt: int,
                          total_sample_cnt: int,
                          max_bin: int, min_data_in_bin: int,
                          bin_type: str = BIN_NUMERICAL,
                          use_missing: bool = True,
                          zero_as_missing: bool = False,
                          forced_bounds: Sequence[float] = ()) -> "BinMapper":
        """:meth:`find_bin` over a pre-aggregated (distinct, counts) pair
        (the entry point a streaming sketch uses, which never holds raw
        sample values). ``nonzero_cnt`` is the number of
        non-NaN values the aggregation covers; the zero count is inferred
        from ``total_sample_cnt`` exactly like the raw-sample path."""
        m = cls(bin_type=bin_type)
        distinct = np.asarray(distinct, dtype=np.float64)
        # the zero-count insertion below mutates counts in place; the
        # caller's aggregation (a reusable sketch) must not see it
        counts = np.array(counts, dtype=np.int64, copy=True)

        if not use_missing:
            m.missing_type = MISSING_NONE
        elif zero_as_missing:
            m.missing_type = MISSING_ZERO
        else:
            m.missing_type = MISSING_NAN if na_cnt > 0 else MISSING_NONE

        # NaNs count as zeros unless they get their own NaN bin
        # (reference: src/io/bin.cpp:318-340)
        if m.missing_type != MISSING_NAN:
            na_cnt = 0
        zero_cnt = max(int(total_sample_cnt - nonzero_cnt - na_cnt), 0)

        # distinct values with counts, zero inserted with its inferred count
        # (reference: src/io/bin.cpp:341-380)
        if zero_cnt > 0 or len(distinct) == 0:
            idx = int(np.searchsorted(distinct, 0.0))
            if idx < len(distinct) and abs(distinct[idx]) <= K_ZERO_THRESHOLD:
                counts[idx] += zero_cnt
            else:
                distinct = np.insert(distinct, idx, 0.0)
                counts = np.insert(counts, idx, zero_cnt)

        m.min_val = float(distinct[0]) if len(distinct) else 0.0
        m.max_val = float(distinct[-1]) if len(distinct) else 0.0

        if bin_type == BIN_NUMERICAL:
            if m.missing_type == MISSING_NAN:
                m.bin_upper_bound = _find_bin_zero_as_one_bin(
                    distinct, counts, max_bin - 1, total_sample_cnt - na_cnt,
                    min_data_in_bin, forced_bounds)
                m.bin_upper_bound.append(np.nan)   # last bin = NaN bin
            else:
                m.bin_upper_bound = _find_bin_zero_as_one_bin(
                    distinct, counts, max_bin, total_sample_cnt,
                    min_data_in_bin, forced_bounds)
                if m.missing_type == MISSING_ZERO and len(m.bin_upper_bound) == 2:
                    m.missing_type = MISSING_NONE
            m.num_bin = len(m.bin_upper_bound)
            m.default_bin = m._value_to_bin_scalar(0.0)
            cnt_in_bin = np.zeros(m.num_bin, dtype=np.int64)
            if len(distinct):
                bin_ids = np.searchsorted(
                    np.asarray([b for b in m.bin_upper_bound if not np.isnan(b)]),
                    distinct, side="left")
                np.add.at(cnt_in_bin, np.minimum(bin_ids, m.num_bin - 1), counts)
            if m.missing_type == MISSING_NAN:
                cnt_in_bin[-1] = na_cnt
            m.most_freq_bin = int(np.argmax(cnt_in_bin)) if m.num_bin else 0
        else:
            m._find_bin_categorical(distinct, counts, max_bin, total_sample_cnt,
                                    min_data_in_bin, na_cnt)
        m.is_trivial = m.num_bin <= 1
        return m

    def _find_bin_categorical(self, distinct: np.ndarray, counts: np.ndarray,
                              max_bin: int, total_sample_cnt: int,
                              min_data_in_bin: int, na_cnt: int) -> None:
        """Categorical bins sorted by count desc, bin 0 reserved for NaN/unseen
        (reference: src/io/bin.cpp:413-470)."""
        ivals: List[int] = []
        icnts: List[int] = []
        for v, c in zip(distinct, counts):
            iv = int(v)
            if iv < 0:
                na_cnt += int(c)
                continue
            if ivals and iv == ivals[-1]:
                icnts[-1] += int(c)
            else:
                ivals.append(iv)
                icnts.append(int(c))
        order = np.argsort(np.asarray(icnts))[::-1] if icnts else []
        cut_cnt = int(round((total_sample_cnt - na_cnt) * 0.99))
        self.bin_2_categorical = [-1]       # dummy NaN bin
        self.categorical_2_bin = {-1: 0}
        self.num_bin = 1
        used_cnt = 0
        distinct_cnt = len(ivals) + (1 if na_cnt > 0 else 0)
        max_bin = min(distinct_cnt, max_bin)
        for rank, oi in enumerate(order):
            if used_cnt >= cut_cnt and self.num_bin >= max_bin:
                break
            if icnts[oi] < min_data_in_bin and rank > 1:
                break
            if self.num_bin >= max_bin and used_cnt >= cut_cnt:
                break
            self.bin_2_categorical.append(ivals[oi])
            self.categorical_2_bin[ivals[oi]] = self.num_bin
            used_cnt += icnts[oi]
            self.num_bin += 1
            if self.num_bin >= max_bin and used_cnt >= cut_cnt:
                break
        self.missing_type = MISSING_NAN if na_cnt > 0 else MISSING_NONE
        self.default_bin = 0
        self.most_freq_bin = 1 if self.num_bin > 1 else 0

    # ------------------------------------------------------------------
    def _value_to_bin_scalar(self, value: float) -> int:
        return int(self.values_to_bins(np.asarray([value]))[0])

    def values_to_bins(self, values: np.ndarray) -> np.ndarray:
        """Vectorized value->bin (reference: bin.h ValueToBin)."""
        values = np.asarray(values, dtype=np.float64)
        if self.bin_type == BIN_CATEGORICAL:
            out = np.zeros(len(values), dtype=np.int32)
            # build lookup; unseen/negative/NaN -> bin 0 (dummy)
            if self.categorical_2_bin:
                keys = np.asarray(list(self.categorical_2_bin.keys()))
                vals = np.asarray(list(self.categorical_2_bin.values()))
                ivalues = np.where(np.isnan(values), -1, values).astype(np.int64)
                sorter = np.argsort(keys)
                pos = np.searchsorted(keys[sorter], ivalues)
                pos = np.clip(pos, 0, len(keys) - 1)
                hit = keys[sorter][pos] == ivalues
                out = np.where(hit, vals[sorter][pos], 0).astype(np.int32)
            return out
        bounds = self.upper_bounds()
        nan_mask = np.isnan(values)
        vals = np.where(nan_mask, 0.0, values)
        if self.missing_type == MISSING_ZERO:
            # NaN treated as zero (reference: bin.h ValueToBin w/ MissingType::Zero)
            pass
        bins = np.searchsorted(bounds, vals, side="left").astype(np.int32)
        bins = np.minimum(bins, len(bounds) - 1)
        if self.missing_type == MISSING_NAN:
            bins = np.where(nan_mask, self.num_bin - 1, bins)
        return bins

    def upper_bounds(self) -> np.ndarray:
        """The numerical upper bounds without the NaN bin's sentinel,
        float64: what ``values_to_bins`` searches (and kernel B reads)."""
        return np.asarray([b for b in self.bin_upper_bound if not np.isnan(b)],
                          np.float64)

    def bin_to_value(self, bin_idx: int) -> float:
        """Representative raw threshold for a bin boundary: the upper bound
        (used when serializing tree thresholds; reference: tree.cpp uses
        BinToValue for threshold_)."""
        if self.bin_type == BIN_CATEGORICAL:
            if 0 <= bin_idx < len(self.bin_2_categorical):
                return float(self.bin_2_categorical[bin_idx])
            return -1.0
        if bin_idx < 0:
            return -np.inf
        if bin_idx >= len(self.bin_upper_bound):
            return np.inf
        b = self.bin_upper_bound[bin_idx]
        return float(b) if not np.isnan(b) else np.inf


def bounds_table(mappers: Sequence[BinMapper], used_features: Sequence[int]):
    """The numerical used features' bounds as one table, the layout of the
    JAX package's native binner (``lambdagap_tpu/native/__init__.py:
    180-203``) and of kernel B: ``(col, dst, nan_bin, bounds, off)`` — each
    numerical feature's raw column, its column among the used features, its
    NaN bin (-1 unless the missing type is NaN: a NaN then reads as 0.0),
    and its upper bounds at ``bounds[off[f]:off[f + 1]]``. Categorical
    features are left out: their mapper bins them."""
    col, dst, nan_bin, parts = [], [], [], []
    for k, j in enumerate(used_features):
        m = mappers[j]
        if m.bin_type == BIN_CATEGORICAL:
            continue
        col.append(j)
        dst.append(k)
        nan_bin.append(m.num_bin - 1 if m.missing_type == MISSING_NAN else -1)
        parts.append(m.upper_bounds())
    off = np.zeros(len(parts) + 1, np.int64)
    np.cumsum([len(b) for b in parts], out=off[1:])
    bounds = np.concatenate(parts) if parts else np.empty(0, np.float64)
    return (np.asarray(col, np.int32), np.asarray(dst, np.int32),
            np.asarray(nan_bin, np.int32), bounds, off)


def _distinct_with_counts(sorted_vals: np.ndarray):
    """Distinct values + counts, merging float-equal neighbors
    (reference: src/io/bin.cpp:356-371 w/ CheckDoubleEqualOrdered)."""
    if len(sorted_vals) == 0:
        return np.empty(0), np.empty(0, dtype=np.int64)
    distinct, counts = np.unique(sorted_vals, return_counts=True)
    return distinct, counts.astype(np.int64)


class QuantileSketch:
    """Bounded-memory incremental (distinct value, count) sketch for one
    feature, feeding :meth:`BinMapper.find_bin_distinct`.

    The streaming construction path (``BinnedDataset.from_sequences``,
    ``ShardedBinnedDataset``) pushes row batches through one sketch per
    feature, so bin boundaries are found without ever materializing the
    raw float matrix ("Out-of-Core GPU Gradient Boosting",
    arXiv:2005.09148 §3.1; GK-style summaries). Every step is the JAX
    package's (``lambdagap_tpu/data/binning.py:426-561``), so the distinct
    values, counts and mappers are equal to its own.

    Exact while the number of distinct non-zero values stays within
    ``budget`` (the common case for binned-feature workloads: the greedy
    boundary search only ever wants ~8*max_bin groups). Beyond the budget,
    adjacent distinct values merge into equal-count groups represented by
    their largest member (:func:`_compress_distinct` — the same compaction
    the in-memory path applies before its boundary search), so boundaries
    shift by less than one group's count — a GK-flavored rank-error bound
    of ~total/budget per boundary.
    """

    __slots__ = ("budget", "distinct", "counts", "na_cnt", "total",
                 "_pend", "_pend_n")

    def __init__(self, budget: int = 65536) -> None:
        self.budget = max(int(budget), 256)
        self.distinct = np.empty(0, np.float64)
        self.counts = np.empty(0, np.int64)
        self.na_cnt = 0
        self.total = 0
        self._pend: list = []
        self._pend_n = 0

    def push(self, values: np.ndarray) -> None:
        """Absorb one row-block's raw column (zeros included — like the
        sparse find_bin convention they are inferred from ``total`` rather
        than stored)."""
        v = np.asarray(values, np.float64).ravel()
        self.total += len(v)
        nan_mask = np.isnan(v)
        self.na_cnt += int(nan_mask.sum())
        # same non-zero convention as BinnedDataset._find_bins: exact 0.0
        # is inferred, near-zeros are kept (K_ZERO_THRESHOLD banding
        # happens inside the boundary search)
        nz = v[~nan_mask]
        nz = nz[nz != 0.0]
        if nz.size:
            self._pend.append(nz)
            self._pend_n += nz.size
        if self._pend_n >= self.budget * 4:
            self._merge_pending()

    def _absorb(self, distinct: np.ndarray, counts: np.ndarray) -> None:
        """Union-merge an aggregated (distinct, counts) pair into this
        sketch, compacting past the budget — the shared reduction step of
        the pending-buffer flush and :meth:`merge`."""
        d = np.concatenate([self.distinct, distinct])
        c = np.concatenate([self.counts, counts])
        order = np.argsort(d, kind="mergesort")
        d, c = d[order], c[order]
        du, inverse = np.unique(d, return_inverse=True)
        cu = np.zeros(len(du), np.int64)
        np.add.at(cu, inverse, c)
        if len(du) > self.budget:
            du, cu = _compress_distinct(du, cu, self.budget)
        self.distinct, self.counts = du, cu

    def _merge_pending(self) -> None:
        if not self._pend:
            return
        pend, pcnt = _distinct_with_counts(
            np.sort(np.concatenate([np.asarray(v, np.float64).ravel()
                                    for v in self._pend])))
        self._pend = []
        self._pend_n = 0
        self._absorb(pend, pcnt)

    def merge(self, other: "QuantileSketch") -> "QuantileSketch":
        """Absorb ``other`` (the psum-style sketch reduction): after the
        merge this sketch summarizes the union of both input streams.

        Exact when the union's distinct count fits the budget, so merging
        per-shard sketches equals one sketch over all rows — which is why
        sharded dataset construction (one sketch set per row shard, merged,
        boundaries broadcast) bins identically to single-host construction
        ("XGBoost: Scalable GPU Accelerated Learning", arXiv:1806.11248
        §5 — only summaries cross the interconnect). Merge order must be
        deterministic (rank order) so every host derives identical
        boundaries once compaction kicks in.
        """
        other._merge_pending()
        self._merge_pending()
        self._absorb(other.distinct, other.counts)
        self.na_cnt += other.na_cnt
        self.total += other.total
        return self

    def to_mapper(self, max_bin: int, min_data_in_bin: int,
                  bin_type: str = BIN_NUMERICAL, use_missing: bool = True,
                  zero_as_missing: bool = False,
                  forced_bounds: Sequence[float] = ()) -> BinMapper:
        """Finalize into a BinMapper over everything pushed so far."""
        self._merge_pending()
        return BinMapper.find_bin_distinct(
            self.distinct, self.counts,
            nonzero_cnt=int(self.counts.sum()),
            na_cnt=self.na_cnt, total_sample_cnt=self.total,
            max_bin=max_bin, min_data_in_bin=min_data_in_bin,
            bin_type=bin_type, use_missing=use_missing,
            zero_as_missing=zero_as_missing, forced_bounds=forced_bounds)
