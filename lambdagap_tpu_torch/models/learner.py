"""The tree learners' shared plumbing and the host-driven SerialTreeLearner.

The port of ``lambdagap_tpu/models/learner.py``. The plumbing the fused
learner inherits: the per-feature bin metadata on the training device, the
``SplitParams`` from the config, per-tree column sampling with the JAX
package's numpy ``RandomState`` draw (so the same seed samples the same
features), the tree options' state (monotone constraints, interaction
groups, extra_trees, ``feature_contri``, the forced-split JSON and its
bin mapping; ``lambdagap_tpu/models/learner.py:130-232,678-705``), the
layout resolution and the export of categorical bitsets.

``SerialTreeLearner.train`` grows a tree leaf by leaf from the host, as
the JAX package's serial learner does (``learner.py:759-1135``), and is
the learner of ``tpu_fused_learner=0``, of CEGB and of
``monotone_constraints_method=advanced``. Its state on the host: the tree,
each leaf's begin and count in the permutation, sums, monotone bounds,
interaction path, bin-space box (advanced) and best split, and the order
the leaves were stored in. On the device: the per-feature binned matrix
(row-major for the histogram kernel, and a column-major copy for the
partition under ``tree_layout=gather``), the permutation, one f32
``[F, B, 3]`` histogram per leaf and, under lazy CEGB, the ``[F, N]`` mask
of rows that paid each feature's cost.

* The root histogram and each smaller child's come from K1
  (``ops/hist_cuda.hist_rows``), which reads the child's rows in place in
  the parent's slice of the permutation (a device offset, no gathered copy,
  no power-of-two padding); the larger child's is the parent's minus it.
* ``tree_layout=sorted`` (``auto`` at 2^20 rows and more, as in the JAX
  package): each tree copies the rows, grad/hess and the in-bag mask into
  leaf-ordered buffers (``ops/partition.SortedRows``, phase
  ``layout_apply``); a split moves the leaf's rows with the permutation,
  reading the split column from the leaf's window, and K1 reads each leaf
  as a window of those copies. Both layouts sit behind one interface
  (``row_layout``: ``GatherRows`` or ``SortedRows``; the histograms through
  ``ops/histogram.leaf_histogram``), so the loop does not branch on it.
  The permutation is kept as under gather, so CEGB's paid rows, the score
  update and the L1 refit read through it unchanged, and the trees equal
  gather's bit for bit.
* A split partitions the leaf's slice stably (out-of-bag rows too), builds
  the children's histograms and scans both children in one batched call
  (``ops/split.best_split`` with no depth guard, the JAX package's
  ``find_best_split``), then reads the left count and both children's
  best splits in ONE host read. The JAX package reads three times a split
  (the left count, then each child's split).
* Under intermediate and advanced monotone constraints the leaves whose
  bounds moved are re-scanned in one batched scan and one more read;
  advanced's dense per-threshold bounds are built on the device for a
  whole batch of leaves (:func:`advanced_bound_arrays`), exactly (they are
  only minima and maxima), and the bin-space boxes stay on the host.
* The random options draw the serial learner's numpy streams: by-node
  sampling off ``feature_fraction_seed`` (``_col_rng``, also the per-tree
  draw), extra_trees' thresholds off ``extra_seed``, F ints on every scan
  of a leaf (re-scans included), in the JAX package's call order: the
  smaller child first.
* CEGB (reference: cost_effective_gradient_boosting.hpp): the split
  penalty times the leaf's count, the coupled penalty of each feature no
  split of the model has used yet (kept across trees) and the lazy
  penalty of each in-bag row of the leaf that no split on the feature has
  routed yet, counted on the device from the leaf's slice of the
  permutation; a split marks its parent's in-bag rows, the last split of
  a tree included.

* ``data_residency`` resolves as in the JAX package
  (``lambdagap_tpu/models/learner.py:248-311``): ``stream`` (or ``auto``
  with a ``ShardedBinnedDataset``, or ``auto`` above
  ``stream_hbm_budget_mb``) keeps the binned matrix in host shards and
  trains through ``ops/partition.StreamRows`` (every histogram a loop of
  uploaded windows into K1's accumulate mode, the split column gathered
  on the host, the go-left flags read back once a split), both layouts,
  with the same trees as resident training; options a learner's stream
  mode does not carry fall back to ``hbm`` with the JAX warning.

``host_syncs`` and ``hist_builds`` count the last tree's host reads and
histograms, as the fused learner's do.
"""
from __future__ import annotations

import contextlib
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..data.dataset import BinnedDataset
from ..ops.hist_cuda import hist_scale
from ..ops.histogram import leaf_histogram, subtract_histogram
from ..ops.partition import (GatherRows, SortedRows, StreamRows,
                             decision_go_left)
from ..ops.split import (CAT_WORDS, SplitParams, best_split,
                         calculate_leaf_output, gather_threshold_split,
                         monotone_split_penalty)
from ..utils import log
from .tree import Tree

_MT_CODES = {"None": 0, "Zero": 1, "NaN": 2}
# a packed best-split record: 6 f32 bit patterns (gain, left g / h / count,
# left and right output), feature, threshold, default_left, is_categorical
# and the 8 bitset words, all int32
_REC_F, _REC_W = 6, 18


def cegb_requested(cfg: Config) -> bool:
    """Any CEGB penalty configured (``lambdagap_tpu/models/gbdt.py:60``):
    it routes training to the serial learner, which then applies it."""
    return cfg.cegb_tradeoff > 0 and bool(
        cfg.cegb_penalty_split > 0 or cfg.cegb_penalty_feature_coupled
        or cfg.cegb_penalty_feature_lazy)


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


class _PhaseTimer:
    """Device-stream time of named phases within one tree, from CUDA events
    around each phase (launch gaps inside a phase count). Off unless the
    learner's ``time_phases`` is set; the CPU has no events."""

    def __init__(self, enabled: bool) -> None:
        self.enabled = enabled
        self.events: Dict[str, List] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        if not self.enabled:
            yield
            return
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        yield
        b.record()
        self.events.setdefault(name, []).append((a, b))

    def totals_ms(self) -> Dict[str, float]:
        if not self.enabled:
            return {}
        torch.cuda.synchronize()
        return {k: sum(a.elapsed_time(b) for a, b in v)
                for k, v in self.events.items()}


class _HostSplit:
    """A read best-split record (the host mirror of SplitInfo): the f32
    fields as numpy float32, the right sums the parent's minus the left's
    in float32, as the JAX package's ``find_best_split`` returns them."""
    __slots__ = ("gain_f", "feature", "threshold", "default_left",
                 "left_sum_g", "left_sum_h", "left_count",
                 "right_sum_g", "right_sum_h", "right_count",
                 "left_output", "right_output", "is_categorical",
                 "cat_bitset")

    @classmethod
    def from_record(cls, rec: np.ndarray, parent) -> "_HostSplit":
        """``rec``: int32 [_REC_W] (``_pack``); ``parent``: the leaf's
        (g, h, count, output) float32."""
        s = cls()
        f = np.ascontiguousarray(rec[:_REC_F]).view(np.float32)
        s.gain_f = float(f[0])
        s.left_sum_g, s.left_sum_h, s.left_count = f[1], f[2], f[3]
        s.left_output, s.right_output = f[4], f[5]
        s.right_sum_g = np.float32(parent[0] - s.left_sum_g)
        s.right_sum_h = np.float32(parent[1] - s.left_sum_h)
        s.right_count = np.float32(parent[2] - s.left_count)
        s.feature, s.threshold = int(rec[6]), int(rec[7])
        s.default_left, s.is_categorical = bool(rec[8]), bool(rec[9])
        s.cat_bitset = np.ascontiguousarray(rec[10:_REC_W]).view(np.uint32)
        return s


def _pack(bs) -> torch.Tensor:
    """A batch of best splits -> int32 [n, _REC_W] records, one read."""
    fl = torch.stack([bs.gain, bs.left_g, bs.left_h, bs.left_c,
                      bs.left_output, bs.right_output], -1).contiguous()
    it = torch.cat([torch.stack([bs.feature, bs.threshold,
                                 bs.default_left.long(),
                                 bs.is_categorical.long()], -1),
                    bs.cat_bitset], -1)
    return torch.cat([fl.view(torch.int32), it.to(torch.int32)], -1)


def _f32_bits(x: torch.Tensor) -> torch.Tensor:
    """f32 values as their int32 bit patterns, flat (to ride a read)."""
    return x.float().contiguous().reshape(-1).view(torch.int32)


def advanced_bound_arrays(lo_t: torch.Tensor, hi_t: torch.Tensor,
                          los: torch.Tensor, his: torch.Tensor,
                          outs: torch.Tensor, not_self: torch.Tensor,
                          mono: np.ndarray, B: int):
    """The advanced monotone method's dense bounds for a batch of leaves
    (``lambdagap_tpu/models/learner.py:482-550``, ``_adv_constrainers`` +
    ``_advanced_bound_arrays``, over every target leaf at once).

    lo_t, hi_t: int64 ``[T, F]`` the target leaves' bin-space boxes
    ``[lo, hi)``; los, his: ``[M, F]`` the boxes of the tree's leaves and
    outs f32 ``[M]`` their outputs; not_self: bool ``[T, M]`` False where
    leaf m is target t itself; mono: the monotone directions [F] (host).
    A leaf m bounds target t through monotone feature g when it lies
    across g's boundary of t's box (at or above t's hi: above; at or below
    its lo: below) and overlaps t in every other feature; an upper bound
    (above for an increasing g, below for a decreasing one) caps the
    outputs over m's own bin range of each scan feature f != g and over the
    whole range of g. Returns (min_left, max_left, min_right, max_right),
    f32 ``[T, F, B]``: index b bounds the left child of a split at
    threshold b (bins <= b) and the right child (bins > b; the last index
    repeats the one before).

    The JAX package builds the raw per-bin extrema over ``[n, F, B]`` masks
    and cumulates them. A prefix extremum over bins <= b only asks which
    ranges START at or before b (a range [lo, hi) meets [0, b] iff lo <= b),
    and a suffix one which END at or after it, so each range is scattered
    once, at its first and at its last bin, ``[T, M, F]`` work instead of
    ``[T, M, F, B]``. Exact: minima and maxima only."""
    dev = lo_t.device
    T, F = lo_t.shape
    M = los.shape[0]
    inf = float("inf")
    ext = {}        # (upper?, prefix?) -> per-bin extremum before cumulating
    for upper in (True, False):
        for prefix in (True, False):
            ext[upper, prefix] = torch.full(
                (T, F, B), inf if upper else -inf, dtype=torch.float32,
                device=dev)
    G = np.nonzero(mono)[0]
    if M and len(G):
        g = torch.from_numpy(G).to(dev)
        ov = (los[None] < hi_t[:, None]) & (lo_t[:, None] < his[None])
        others = (ov.sum(-1, keepdim=True) - ov[..., g].long()) == F - 1
        ok = others & not_self[..., None]                      # [T, M, G]
        above = (los[:, g][None] >= hi_t[:, g][:, None]) & ok
        below = (his[:, g][None] <= lo_t[:, g][:, None]) & ok
        inc = torch.from_numpy(mono[G] > 0).to(dev)
        for sel, upper in ((torch.where(inc, above, below), True),
                           (torch.where(inc, below, above), False)):
            # m's range of each scan feature: its box's, or the whole range
            # of the feature it bounds t through
            whole = torch.zeros((T, M, F), dtype=torch.bool, device=dev)
            whole[..., g] = sel
            lo = torch.where(whole, 0, los[None]).transpose(1, 2)
            hi = torch.where(whole, B, his[None]).transpose(1, 2)
            src = torch.where(sel.any(-1)[:, None, :], outs,
                              inf if upper else -inf).expand(T, F, M)
            for prefix, at in ((True, lo), (False, hi - 1)):
                ext[upper, prefix].scatter_reduce_(
                    2, at.contiguous(), src.contiguous(),
                    "amin" if upper else "amax")
    min_l = torch.cummax(ext[False, True], -1).values
    max_l = torch.cummin(ext[True, True], -1).values
    sfx_min = torch.flip(torch.cummax(torch.flip(ext[False, False], [-1]),
                                      -1).values, [-1])
    sfx_max = torch.flip(torch.cummin(torch.flip(ext[True, False], [-1]),
                                      -1).values, [-1])
    min_r = torch.cat([sfx_min[..., 1:], sfx_min[..., -1:]], -1)
    max_r = torch.cat([sfx_max[..., 1:], sfx_max[..., -1:]], -1)
    return min_l, max_l, min_r, max_r


def _adv_constrainers(mono_np, lo_l, hi_l, los, his):
    """For each monotone feature g, host masks over the leaves (boxes
    ``los``/``his`` [M, F]) that bound the box (lo_l, hi_l) from above /
    below in g while overlapping it in every other feature
    (``lambdagap_tpu/models/learner.py:482-495``). Returns {g: (above[M],
    below[M])}."""
    ov = (los < hi_l[None, :]) & (lo_l[None, :] < his)
    n_ov = ov.sum(axis=1)
    F = lo_l.shape[0]
    out = {}
    for g in np.nonzero(mono_np)[0]:
        others_ok = (n_ov - ov[:, g]) == (F - 1)
        out[int(g)] = ((los[:, g] >= hi_l[g]) & others_ok,
                       (his[:, g] <= lo_l[g]) & others_ok)
    return out


def _intermediate_propagate(tree: Tree, node_parent: List[int],
                            start_node: int, split_feat: int, thr_bin: int,
                            s, bounds: Dict[int, tuple], mono_np: np.ndarray,
                            splittable) -> List[int]:
    """The intermediate method's propagation, host code copied from
    ``lambdagap_tpu/models/learner.py:1142-1238`` (reference:
    monotone_constraints.hpp:560-850 IntermediateLeafConstraints): walk up
    from the new split node; in every monotone ancestor's opposite subtree,
    tighten the min/max bound of each leaf contiguous to the new children
    with their outputs. Mutates ``bounds``; returns the leaves whose bounds
    tightened (their best splits are re-scanned)."""
    updated: List[int] = []
    up_feats: List[int] = []
    up_thrs: List[int] = []
    up_was_right: List[bool] = []
    lout, rout = float(s.left_output), float(s.right_output)

    def go_down(nidx: int, update_max: bool, use_left: bool,
                use_right: bool) -> None:
        if nidx < 0:
            leaf = ~nidx
            # unsplittable leaves never split again, so their (already
            # clamped) outputs need no tighter bound
            if not splittable(leaf):
                return
            if use_left and use_right:
                lo_v, hi_v = min(lout, rout), max(lout, rout)
            elif use_right:
                lo_v = hi_v = rout
            else:
                lo_v = hi_v = lout
            plo, phi = bounds.get(leaf, (-np.inf, np.inf))
            if update_max:
                new_hi = min(phi, lo_v)
                if new_hi < phi:
                    bounds[leaf] = (plo, new_hi)
                    updated.append(leaf)
            else:
                new_lo = max(plo, hi_v)
                if new_lo > plo:
                    bounds[leaf] = (new_lo, phi)
                    updated.append(leaf)
            return
        inner_f = tree.split_feature_inner[nidx]
        thr = tree.threshold_bin[nidx]
        is_num = not tree.is_categorical[nidx]
        # contiguity pruning against the recorded up-path splits
        keep_left = keep_right = True
        if is_num:
            for f_i, t_i, r_i in zip(up_feats, up_thrs, up_was_right):
                if f_i == inner_f:
                    if thr >= t_i and not r_i:
                        keep_right = False
                    if thr <= t_i and r_i:
                        keep_left = False
        # same-feature splits below decide which new leaf stays contiguous
        use_l_for_right = use_r_for_left = True
        if is_num and inner_f == split_feat:
            if thr >= thr_bin:
                use_l_for_right = False
            if thr <= thr_bin:
                use_r_for_left = False
        if keep_left:
            go_down(tree.left_child[nidx], update_max,
                    use_left, use_right and use_r_for_left)
        if keep_right:
            go_down(tree.right_child[nidx], update_max,
                    use_left and use_l_for_right, use_right)

    node = start_node
    while True:
        parent = node_parent[node] if 0 <= node < len(node_parent) else -1
        if parent < 0:
            break
        inner_f = tree.split_feature_inner[parent]
        is_right = tree.right_child[parent] == node
        # only branches contiguous to the original leaf can need updates:
        # for a feature already crossed in the same direction going up,
        # the opposite child cannot be contiguous
        opposite_ok = (not tree.is_categorical[parent]) and all(
            not (f_i == inner_f and r_i == is_right)
            for f_i, r_i in zip(up_feats, up_was_right))
        if opposite_ok:
            if mono_np[inner_f] != 0:
                left_is_curr = tree.left_child[parent] == node
                opposite = (tree.right_child[parent] if left_is_curr
                            else tree.left_child[parent])
                update_max = (left_is_curr if mono_np[inner_f] < 0
                              else not left_is_curr)
                go_down(opposite, update_max, True, True)
            up_was_right.append(is_right)
            up_thrs.append(tree.threshold_bin[parent])
            up_feats.append(inner_f)
        node = parent
    return updated


class SerialTreeLearner:
    """Single-device leaf-wise learner over a BinnedDataset, driven from
    the host (``train``); its plumbing is the fused subclass's too."""

    def __init__(self, dataset: BinnedDataset, config: Config,
                 device: torch.device) -> None:
        self.dataset = dataset
        self.config = config
        self.device = device
        self.num_data = dataset.num_data
        self.num_features = dataset.num_features
        meta = dataset.feature_arrays()
        self.meta_host = meta

        def up(a):
            return torch.from_numpy(np.asarray(a)).to(device)

        self.num_bins_arr = up(meta["num_bins"].astype(np.int64))
        self.default_bins_arr = up(meta["default_bins"].astype(np.int64))
        self.missing_types_arr = up(meta["missing_types"].astype(np.int64))
        self.is_categorical_arr = up(meta["is_categorical"])
        self.has_categorical = bool(meta["is_categorical"].any())
        # uniform per-feature bin budget (a power of two, at least 8)
        self.B = max(_next_pow2(int(meta["num_bins"].max())), 8)
        self.params = SplitParams.from_config(config)
        self.layout = self._resolve_layout(config)
        self._col_rng = np.random.RandomState(config.feature_fraction_seed)
        self._init_options(dataset, config)
        self.residency = self._resolve_residency(config)
        if self.residency == "stream":
            # the binned matrix stays in host shards (JAX learner.py:95-104)
            from ..data.stream import as_sharded
            self.sdata = as_sharded(dataset, config)
            self.bundle = None
            self.Bb = self.B
            self.x_rows = None
            self.row_layout = StreamRows(
                self.sdata, device, self.layout,
                config.stream_prefetch_depth, self.sdata.shard_rows,
                config.stream_goss_compact)
        else:
            self.sdata = None
            self._upload_matrix()
            # the layout's second copy of the rows: column-major for the
            # gather partition, or leaf-ordered copies rebuilt each tree
            # (then no column-major copy, JAX fused_learner.py:233-245)
            self.row_layout = (SortedRows if self.layout == "sorted"
                               else GatherRows)(self.x_rows)
        # the serial learner's state: extra_trees' numpy stream, CEGB, the
        # last tree's partition (for the score update and the L1 refit)
        self._extra_rng = np.random.RandomState(config.extra_seed)
        self._init_cegb(dataset, config)
        self.last_perm: Optional[torch.Tensor] = None
        self.last_leaf_begin: Optional[np.ndarray] = None
        self.last_leaf_count: Optional[np.ndarray] = None
        self.last_row_leaf: Optional[torch.Tensor] = None
        # both learners': the depth rows of feature_contri x the monotone
        # penalty; the non-finite guard's device flag, read with a round's
        # first record (models/gbdt.py sets it), and what that read found;
        # the last tree's counters and phase times
        self._mult_cache: Dict[int, Optional[torch.Tensor]] = {}
        self.guard_flag: Optional[torch.Tensor] = None
        self.guard_read: Optional[List[bool]] = None
        self.host_syncs = 0
        self.hist_builds = 0
        self.time_phases = False
        self.phase_ms: Dict[str, float] = {}

    def _upload_matrix(self) -> None:
        """The per-feature binned matrix on the device, row-major (``x_rows``,
        K1's input; the constructor adds the layout's second copy,
        ``row_layout``). The serial learner reads per-feature bins, never
        EFB's bundled columns (JAX ``learner.py:102``)."""
        self.bundle = None
        self.Bb = self.B
        self.x_rows = torch.from_numpy(
            np.ascontiguousarray(self.dataset.binned)).to(self.device)

    def _init_cegb(self, dataset: BinnedDataset, config: Config) -> None:
        """CEGB's penalties per used feature (``lambdagap_tpu/models/
        learner.py:154-191``): the split penalty, the coupled penalty (paid
        once a model: ``_cegb_used`` lives across trees) and the lazy
        per-row one, whose paid rows are a bool ``[F, N]`` device mask."""
        c = config
        F = self.num_features
        used = dataset.used_features

        def per_feature(values, dtype):
            out = np.zeros(F, dtype=dtype)
            for k, j in enumerate(used):
                if j < len(values):
                    out[k] = values[j]
            return out

        self.cegb_on = cegb_requested(c)
        self._cegb_coupled = c.cegb_tradeoff * per_feature(
            c.cegb_penalty_feature_coupled, np.float32)
        self._cegb_split_pen = np.float32(c.cegb_tradeoff
                                          * c.cegb_penalty_split)
        self._cegb_used = np.zeros(F, dtype=bool)
        self._cegb_lazy = None
        self._paid = None
        if c.cegb_tradeoff > 0 and c.cegb_penalty_feature_lazy:
            self._cegb_lazy = torch.from_numpy(c.cegb_tradeoff * per_feature(
                c.cegb_penalty_feature_lazy, np.float64)).to(self.device)
            self._paid = torch.zeros((F, self.num_data), dtype=torch.bool,
                                     device=self.device)

    def resident_bytes(self) -> int:
        """Device bytes this learner keeps for the run: the row-major
        binned matrix and its layout's second copy (gather: the
        column-major copy; sorted: the leaf-ordered copies, their channels
        and the partition's scratch, as made so far) and lazy CEGB's
        paid-row mask; per-tree state is counted by the caller."""
        rows = (0 if self.x_rows is None
                else self.x_rows.numel() * self.x_rows.element_size())
        return (rows + self.row_layout.nbytes()
                + (0 if self._paid is None else self._paid.numel()))

    def _init_options(self, dataset: BinnedDataset, config: Config) -> None:
        """The tree options, mapped from original to used features."""
        F = self.num_features
        used = dataset.used_features
        self._inner_of = {j: k for k, j in enumerate(used)}

        def per_feature(values, default, dtype):
            out = np.full(F, default, dtype=dtype)
            for k, j in enumerate(used):
                if j < len(values):
                    out[k] = values[j]
            return out

        # monotone constraints (reference: monotone_constraints.hpp; the
        # basic and intermediate methods)
        self.mono_method = config.monotone_constraints_method
        mono = per_feature([int(m) for m in config.monotone_constraints], 0,
                           np.int64)
        if (mono != 0)[self.meta_host["is_categorical"]].any():
            log.fatal("monotone_constraints cannot be set on categorical "
                      "features")
        self.mono_np = mono
        self.mono_arr = torch.from_numpy(mono).to(self.device)
        self.mono_on = bool((mono != 0).any())
        self.mono_penalty = float(config.monotone_penalty)
        # interaction constraints (reference: col_sampler.hpp interaction
        # sets): groups of inner feature indices
        self.ic_groups = None
        if config.interaction_constraints:
            self.ic_groups = [frozenset(self._inner_of[j] for j in g
                                        if j in self._inner_of)
                              for g in config.interaction_constraints]
        # extra_trees: one uniform-random threshold bin per feature and
        # scan (reference: feature_histogram.hpp:192-205 USE_RAND)
        self.extra_on = bool(config.extra_trees)
        self.nb_minus1 = np.maximum(
            self.meta_host["num_bins"].astype(np.int64) - 1, 1)
        # feature_contri: a multiplier on each feature's post-shift gain
        # (reference: feature_histogram.hpp:174 output->gain *= penalty)
        self.contri_arr = None
        if config.feature_contri:
            self.contri_arr = torch.from_numpy(per_feature(
                [float(v) for v in config.feature_contri], 1.0,
                np.float32)).to(self.device)
        # forced splits (reference: serial_tree_learner.cpp:624 ForceSplits;
        # the schema of examples/binary_classification/forced_splits.json)
        self.forced_json = None
        if config.forcedsplits_filename:
            import json
            try:
                with open(config.forcedsplits_filename) as fh:
                    fj = json.load(fh)
            except (OSError, ValueError) as e:
                log.fatal("cannot read forcedsplits_filename=%r: %s",
                          config.forcedsplits_filename, e)
            if fj:
                self.forced_json = fj

    def _forced_bin(self, node) -> Optional[Tuple[int, int]]:
        """A forced-split JSON node -> (inner feature, threshold bin), or
        None (forcing aborts) when the feature is unused or the threshold
        maps to no bin (the analog of InnerFeatureIndex + BinThreshold in
        ForceSplits)."""
        try:
            j = int(node["feature"])
            thr = float(node["threshold"])
        except (KeyError, TypeError, ValueError):
            log.warning("Malformed forced-split node %r; aborting forced "
                        "splits", node)
            return None
        k = self._inner_of.get(j)
        if k is None:
            log.warning("Forced split on unused feature %d; aborting forced "
                        "splits", j)
            return None
        mapper = self.dataset.mappers[j]
        if self.meta_host["is_categorical"][k]:
            thr_bin = mapper.categorical_2_bin.get(int(thr))
            if thr_bin is None:
                log.warning("Forced categorical split on unseen category %d "
                            "of feature %d; aborting forced splits",
                            int(thr), j)
                return None
        else:
            thr_bin = mapper._value_to_bin_scalar(thr)
        return k, int(thr_bin)

    # both ported learners train either layout (the JAX package's parallel
    # learners opt out; they are not ported)
    supports_sorted_layout = True

    # both ported learners can train with the binned matrix in host shards
    # (the JAX package's distributed learners cannot; they are not ported)
    supports_stream = True

    def _stream_blockers(self, config: Config) -> List[str]:
        """Options this learner's stream mode does not carry, from the
        config alone (JAX ``learner.py:252-256``): none here."""
        return []

    def _estimate_residency_bytes(self) -> int:
        """Approximate device bytes the hbm path would pin for the binned
        matrix (``stream_hbm_budget_mb``'s input; JAX ``learner.py:
        258-262``)."""
        item = 1 if int(self.meta_host["num_bins"].max()) <= 256 else 2
        return self.num_data * self.num_features * item

    def _resolve_residency(self, config: Config) -> str:
        """``data_residency`` as the JAX package resolves it
        (``learner.py:264-311``): ``auto`` streams a
        ``ShardedBinnedDataset``, and any dataset whose estimated
        residency passes ``stream_hbm_budget_mb`` when that is set; options
        the stream mode does not carry fall back to ``hbm`` with a warning
        when streaming was asked for."""
        from ..data.stream import ShardedBinnedDataset
        mode = config.data_residency
        sharded = isinstance(self.dataset, ShardedBinnedDataset)
        if mode == "hbm":
            return "hbm"
        if not self.supports_stream:
            if mode == "stream" or sharded:
                log.warning("data_residency=stream is not supported with "
                            "tree_learner=%s (%s keeps its device "
                            "matrices resident); falling back to "
                            "data_residency=hbm", config.tree_learner,
                            type(self).__name__)
            return "hbm"
        blocker_knobs = self._stream_blockers(config)
        if blocker_knobs:
            if mode == "stream" or sharded:
                log.warning("data_residency=stream does not support %s; "
                            "training device-resident",
                            ", ".join(blocker_knobs))
            return "hbm"
        if mode == "stream" or sharded:
            return "stream"
        if config.stream_hbm_budget_mb > 0 and (
                self._estimate_residency_bytes()
                > config.stream_hbm_budget_mb << 20):
            log.info("data_residency=auto: estimated %.0f MB residency "
                     "exceeds stream_hbm_budget_mb=%d; streaming",
                     self._estimate_residency_bytes() / 2**20,
                     config.stream_hbm_budget_mb)
            return "stream"
        return "hbm"

    def _resolve_layout(self, config: Config) -> str:
        """``tree_layout`` as the JAX package resolves it
        (``lambdagap_tpu/models/learner.py:333-349``): a learner without the
        sorted layout keeps gather, with the reference's info line for an
        explicit sorted; ``auto`` is sorted at 2^20 rows and more, gather
        below. The two layouts grow the same trees bit for bit: the same
        rows in the same order reach exact integer sums."""
        layout = config.tree_layout
        if not self.supports_sorted_layout:
            if layout == "sorted":
                log.info("tree_layout=sorted is not supported with "
                         "tree_learner=%s (%s); using the gather layout",
                         config.tree_learner, type(self).__name__)
            return "gather"
        if layout == "auto":
            return "sorted" if self.num_data >= (1 << 20) else "gather"
        return layout

    def _feature_mask(self) -> np.ndarray:
        """Per-tree column sampling (reference: src/treelearner/
        col_sampler.hpp), the JAX package's draw: bool [F] on the host."""
        frac = self.config.feature_fraction
        mask = np.ones(self.num_features, dtype=bool)
        if frac < 1.0:
            k = max(1, int(np.ceil(frac * self.num_features)))
            chosen = self._col_rng.choice(self.num_features, k,
                                          replace=False)
            mask[:] = False
            mask[chosen] = True
        return mask

    def _cat_bitset_real(self, feature_k: int,
                         bitset_bins: np.ndarray) -> np.ndarray:
        """A bin-space bitset -> raw-category space for model export, sized
        to the largest selected category (reference: Common::ConstructBitset,
        src/io/tree.cpp cat_threshold_)."""
        mapper = self.dataset.mappers[self.dataset.used_features[feature_k]]
        cats = []
        for b in range(mapper.num_bin):
            if (int(bitset_bins[b // 32]) >> (b % 32)) & 1:
                cat = (mapper.bin_2_categorical[b]
                       if b < len(mapper.bin_2_categorical) else -1)
                if cat >= 0:
                    cats.append(int(cat))
        words = max(8, (max(cats) + 32) // 32) if cats else 8
        out = np.zeros(words, dtype=np.uint32)
        for cat in cats:
            out[cat // 32] |= np.uint32(1) << np.uint32(cat % 32)
        return out

    # ------------------------------------------------------------------
    # the serial learner: its draws, CEGB and host reads
    # ------------------------------------------------------------------
    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """A small host array on the device without a sync: staged in
        pinned memory and copied asynchronously on the card."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _bynode_mask(self, fmask: np.ndarray, path: frozenset) -> np.ndarray:
        """A leaf's features (``lambdagap_tpu/models/learner.py:366-386``):
        the tree's mask filtered to the interaction groups that contain the
        leaf's path, then by-node sampling's numpy draw of
        ceil(fraction x available) of them."""
        frac = self.config.feature_fraction_bynode
        m = fmask.copy()
        if self.ic_groups is not None:
            allowed = np.zeros(self.num_features, dtype=bool)
            for g in self.ic_groups:
                if path <= g:
                    allowed[list(g)] = True
            m &= allowed
        if frac < 1.0 and m.any():
            avail = np.nonzero(m)[0]
            k = max(1, int(np.ceil(frac * len(avail))))
            keep = self._col_rng.choice(avail, k, replace=False)
            m[:] = False
            m[keep] = True
        return m

    def _draw_extra_thresholds(self) -> np.ndarray:
        """extra_trees' one threshold bin per feature for one scan
        (``lambdagap_tpu/models/learner.py:388-395``)."""
        return (self._extra_rng.randint(0, 1 << 30, self.num_features)
                % self.nb_minus1).astype(np.int32)

    def _mult_row(self, depth: int) -> Optional[torch.Tensor]:
        """``feature_contri`` times the monotone split penalty at a depth
        (``lambdagap_tpu/models/learner.py:449-455``), float32 [F]."""
        if depth not in self._mult_cache:
            mult = self.contri_arr
            if self.mono_on and self.mono_penalty > 0:
                mp = torch.where(self.mono_arr != 0, monotone_split_penalty(
                    torch.full((), depth, device=self.device),
                    self.mono_penalty), torch.ones((), device=self.device))
                mult = mp if mult is None else mult * mp
            self._mult_cache[depth] = mult
        return self._mult_cache[depth]

    def _coupled_host(self, used: np.ndarray) -> np.ndarray:
        """CEGB's coupled penalty of the features no split has used yet,
        float32 [F]."""
        return self._cegb_coupled * (~used).astype(np.float32)

    def _pen_host(self, counts, used: np.ndarray) -> np.ndarray:
        """CEGB's split and coupled penalties of leaves with ``counts``
        in-bag rows, float32 [n, F] (``lambdagap_tpu/models/
        learner.py:441-443``, the same float32 operations)."""
        c = np.asarray(counts, dtype=np.float32)[:, None]
        return self._cegb_split_pen * c + self._coupled_host(used)

    def _lazy_unpaid(self, rows: torch.Tensor, mask, split_at=None):
        """Per feature, the in-bag rows among ``rows`` (a slice of the
        permutation) that have not paid its lazy cost, int64 [F]; with
        ``split_at`` (a device count) [2, F], for the positions before it
        and from it on."""
        r = rows.long()
        u = ~self._paid[:, r]
        if mask is not None:
            u &= mask[r]
        if split_at is None:
            return u.sum(1)
        left = (u & (torch.arange(r.numel(), device=r.device)
                     < split_at)).sum(1)
        return torch.stack([left, u.sum(1) - left])

    def _lazy_pen(self, unpaid: torch.Tensor) -> torch.Tensor:
        """The lazy penalty, float64 cost x count rounded to float32
        (``lambdagap_tpu/models/learner.py:407-417``)."""
        return (self._cegb_lazy * unpaid.double()).float()

    def _lazy_mark(self, rows: torch.Tensor, mask, feat: int) -> None:
        """A split on ``feat`` marks its parent's in-bag rows as paid
        (``lambdagap_tpu/models/learner.py:419-427``)."""
        r = rows.long()
        self._paid[feat, r] = (True if mask is None
                               else self._paid[feat, r] | mask[r])

    def _adv_affected(self, lo_p, hi_p, boxes, leaves) -> List[int]:
        """The leaves whose advanced bounds may move when the leaf of box
        (lo_p, hi_p) splits: every leaf that box constrained
        (``lambdagap_tpu/models/learner.py:552-568``), in ``leaves``
        order."""
        cand = [m for m in leaves if m in boxes]
        if not cand:
            return []
        los = np.stack([boxes[m][0] for m in cand])
        his = np.stack([boxes[m][1] for m in cand])
        hit = np.zeros(len(cand), dtype=bool)
        for above, below in _adv_constrainers(self.mono_np, lo_p, hi_p,
                                              los, his).values():
            hit |= above | below
        return [m for m, h in zip(cand, hit) if h]

    def rng_state(self) -> tuple:
        """The learner's streams (``_col_rng``, ``_extra_rng``) and CEGB's
        state across trees."""
        return (self._col_rng.get_state(), self._extra_rng.get_state(),
                self._cegb_used.copy(),
                None if self._paid is None else self._paid.clone())

    def set_rng_state(self, st: tuple) -> None:
        self._col_rng.set_state(st[0])
        self._extra_rng.set_state(st[1])
        self._cegb_used = st[2].copy()
        if st[3] is not None:
            self._paid = st[3].clone()

    # ------------------------------------------------------------------
    def train(self, grad: torch.Tensor, hess: torch.Tensor,
              row_mask: Optional[torch.Tensor] = None) -> Tree:
        """Grow one tree from f32 grad/hess [N] and an optional bool in-bag
        mask [N] (None: every row). Returns the host Tree; its partition is
        left in ``last_perm`` / ``last_leaf_begin`` / ``last_leaf_count``
        and each training row's leaf in ``last_row_leaf`` (int64 [N], on
        the device)."""
        cfg = self.config
        dev = self.device
        L, max_depth = cfg.num_leaves, cfg.max_depth
        N, F, B = self.num_data, self.num_features, self.B
        p = self.params
        meta = self.meta_host
        timer = _PhaseTimer(self.time_phases and dev.type == "cuda")
        tree = Tree(max_leaves=L)
        fmask = self._feature_mask()
        fmask_dev = self._upload(fmask)
        grad, hess = grad.contiguous(), hess.contiguous()
        mask = None if row_mask is None else row_mask.contiguous()
        hscale = hist_scale(grad, hess)      # K1's exponents, once a tree
        lay = self.row_layout
        # sorted: the tree's leaf-ordered copies, from the dataset-order
        # gradients and mask (JAX learner.py:773-790)
        with timer.phase("layout_apply"):
            lay.rebuild(grad, hess, mask)
        mono_on = self.mono_on
        adv_on = mono_on and self.mono_method == "advanced"
        # advanced keeps intermediate's bookkeeping (AdvancedLeafConstraints
        # : IntermediateLeafConstraints)
        inter_on = mono_on and self.mono_method in ("intermediate",
                                                    "advanced")
        bynode = cfg.feature_fraction_bynode < 1.0
        per_node = self.ic_groups is not None or bynode
        use_mult = self.contri_arr is not None or (mono_on
                                                   and self.mono_penalty > 0)
        lazy = self._cegb_lazy is not None
        base_args = (self.num_bins_arr, self.default_bins_arr,
                     self.missing_types_arr, self.is_categorical_arr)
        inf = float("inf")
        syncs = 0
        self.guard_read = None

        def scan(h, sums, depths, paths, cons=None, pen=None, order=None):
            """Best splits of n leaves: histograms [n, F, B, 3], sums [n, 4]
            (g, h, count, output), constraints and CEGB penalties [n, F] on
            the device; host depths and paths. The random draws are made in
            the JAX call order and go up in one copy; ``order`` maps the
            batch to them (the children: the smaller child draws first)."""
            rand, fm = None, fmask_dev
            if self.extra_on or per_node:
                parts = []
                if self.extra_on:
                    parts.append(np.stack([self._draw_extra_thresholds()
                                           for _ in paths]))
                if per_node:
                    parts.append(np.stack([self._bynode_mask(fmask, pth)
                                           for pth in paths]))
                up = self._upload(np.concatenate(
                    [a.astype(np.int64) for a in parts], axis=1))
                if order is not None:
                    up = up[order]
                if self.extra_on:
                    rand = up[:, :F]
                if per_node:
                    fm = up[:, -F:] != 0
            mult = (torch.stack([self._mult_row(d) for d in depths])
                    if use_mult else None)
            return best_split(h, sums[:, 0], sums[:, 1], sums[:, 2],
                              sums[:, 3], 0, *base_args, fm, p,
                              self.has_categorical, 0, constraints=cons,
                              rand_thresholds=rand, gain_mult=mult,
                              gain_penalty=pen)

        def host_inputs(sums_l, bounds_l):
            """Leaves' sums and scalar monotone bounds in one copy: (sums
            [n, 4], min [n], max [n]) f32 on the device."""
            a = np.empty((len(sums_l), 6), dtype=np.float32)
            a[:, :4] = sums_l
            a[:, 4:] = bounds_l
            up = self._upload(a)
            return up[:, :4], up[:, 4], up[:, 5]

        def adv_bounds(targets, bx, value):
            """The advanced method's dense bounds of ``targets`` against
            every leaf of boxes ``bx`` (outputs ``value(m)``), built on the
            device in one batch."""
            live = sorted(bx)
            pos = {m: i for i, m in enumerate(live)}
            ti = [pos[t] for t in targets]
            los = np.stack([bx[m][0] for m in live])
            his = np.stack([bx[m][1] for m in live])
            M, T = len(live), len(targets)
            ints = self._upload(np.concatenate(
                [los, his, los[ti], his[ti]]).astype(np.int64))
            outs = self._upload(np.asarray([value(m) for m in live],
                                           dtype=np.float32))
            not_self = np.ones((T, M), dtype=bool)
            not_self[np.arange(T), ti] = False
            return advanced_bound_arrays(
                ints[2 * M:2 * M + T], ints[2 * M + T:], ints[:M],
                ints[M:2 * M], outs, self._upload(not_self), self.mono_np, B)

        def penalties(counts, used, unpaid=None):
            """CEGB's [n, F] penalties: split + coupled from the host, the
            lazy term from the device's unpaid-row counts."""
            pen = self._upload(self._pen_host(counts, used))
            return pen if unpaid is None else pen + self._lazy_pen(unpaid)

        # -- the root (BeforeTrain analog) --------------------------------
        perm = torch.arange(N, dtype=torch.int32, device=dev)
        hist = torch.empty((L, F, B, 3), dtype=torch.float32, device=dev)
        with timer.phase("histogram"):
            hist[0] = leaf_histogram(lay, perm, 0, N, B, scale=hscale)
        self.hist_builds = 1
        # the root's sums over feature 0's bins, in float64 so the card and
        # the CPU agree to the bit
        totals = hist[0, 0].double().sum(dim=0).float()
        root_out = calculate_leaf_output(totals[0], totals[1], p, totals[2],
                                         0.0)
        root_sums = torch.stack([totals[0], totals[1], totals[2],
                                 root_out])[None]
        cons = pen = None
        if mono_on:
            cons = (self.mono_arr, torch.full((1,), -inf, device=dev),
                    torch.full((1,), inf, device=dev))
        if self.cegb_on:
            pen = (root_sums[:, 2:3] * torch.tensor(
                self._cegb_split_pen, device=dev)
                + self._upload(self._coupled_host(self._cegb_used)))
            if lazy:
                pen = pen + self._lazy_pen(self._lazy_unpaid(perm, mask))
        with timer.phase("split_scan"):
            b0 = scan(hist[0:1], root_sums, [0], [frozenset()], cons, pen)
        # ONE read: the root's sums and output, its best split and, in a
        # round's first tree, the non-finite guard's flag
        parts = [_f32_bits(root_sums), _pack(b0).reshape(-1)]
        if self.guard_flag is not None:
            parts.append(self.guard_flag.to(torch.int32).reshape(-1))
        rec = torch.cat(parts).cpu().numpy()
        syncs += 1
        if self.guard_flag is not None:
            self.guard_read = [bool(v) for v in rec[4 + _REC_W:]]
        root = tuple(np.ascontiguousarray(rec[:4]).view(np.float32))
        tree.leaf_value[0] = float(root[3])
        tree.leaf_weight[0] = float(root[1])
        tree.leaf_count[0] = int(root[2]) if np.isfinite(root[2]) else 0

        leaf_begin = np.zeros(L, dtype=np.int64)
        leaf_count = np.zeros(L, dtype=np.int64)
        leaf_count[0] = N
        sums: Dict[int, tuple] = {0: root}
        bounds: Dict[int, tuple] = {0: (-np.inf, np.inf)}
        paths: Dict[int, frozenset] = {0: frozenset()}
        best: Dict[int, _HostSplit] = {
            0: _HostSplit.from_record(rec[4:4 + _REC_W], root)}
        # the order the leaves' histograms were stored in (the JAX
        # package's ``hists`` dict): advanced's re-scans follow it
        stored: Dict[int, None] = {0: None}
        node_parent: List[int] = []
        leaf_mono: Dict[int, bool] = {}
        boxes: Dict[int, tuple] = {}
        if adv_on:
            boxes[0] = (np.zeros(F, dtype=np.int64),
                        meta["num_bins"].astype(np.int64))
        zero_bits = torch.zeros(CAT_WORDS, dtype=torch.int64, device=dev)
        lr_order = self._upload(np.array([[0, 1], [1, 0]], dtype=np.int64))

        def rescan(todo: List[int]) -> None:
            """Re-scan the leaves ``todo`` against their new bounds in one
            batched scan and one read (the JAX package scans them one at a
            time, in this order)."""
            nonlocal syncs
            idx = self._upload(np.asarray(todo, dtype=np.int64))
            sm = [sums[u] for u in todo]
            up_sums, lo, hi = host_inputs(sm, [bounds[u] for u in todo])
            with timer.phase("constraints"):
                cons = None
                if adv_on:
                    cons = (self.mono_arr,) + adv_bounds(
                        todo, boxes, lambda m: tree.leaf_value[m])
                elif mono_on:
                    cons = (self.mono_arr, lo, hi)
                pen = None
                if self.cegb_on:
                    pen = penalties(
                        [x[2] for x in sm], self._cegb_used,
                        torch.stack([self._lazy_unpaid(
                            perm[leaf_begin[u]:leaf_begin[u]
                                 + leaf_count[u]], mask) for u in todo])
                        if lazy else None)
                bs = scan(hist[idx], up_sums,
                          [int(tree.leaf_depth[u]) for u in todo],
                          [paths[u] for u in todo], cons, pen)
                recs = _pack(bs).cpu().numpy()
            syncs += 1
            for u, r in zip(todo, recs):
                best[u] = _HostSplit.from_record(r, sums[u])

        def apply_split(leaf: int, s: _HostSplit) -> Optional[int]:
            """Partition and record split ``s`` of ``leaf``, then build both
            children's histograms and best splits (the JAX package's
            ``apply_split``, learner.py:846-1077). The left count and the
            children's splits come back in one read; on a degenerate
            partition nothing is recorded and the draws are undone. Returns
            the right child's leaf id, or None."""
            nonlocal syncs
            begin, count = int(leaf_begin[leaf]), int(leaf_count[leaf])
            feat, thr, cat = s.feature, s.threshold, s.is_categorical
            pnode_before = int(tree.leaf_parent[leaf])
            new_leaf = tree.num_leaves
            full = new_leaf + 1 >= L    # no more splits: no children scans
            saved = (None if full else
                     (self._col_rng.get_state(), self._extra_rng.get_state()))
            with timer.phase("partition"):
                rows = perm[begin:begin + count]
                gl = decision_go_left(
                    lay.column(perm, begin, count, feat), thr,
                    s.default_left, int(meta["default_bins"][feat]),
                    int(meta["missing_types"][feat]),
                    int(meta["num_bins"][feat]), cat,
                    self._upload(s.cat_bitset.astype(np.int64)) if cat
                    else zero_bits)
                lc_dev = lay.split(perm, begin, count, gl)

            # the children's bounds (basic: the mid of the two outputs caps
            # the constrained side; intermediate and advanced: each child
            # by its sibling's output; learner.py:948-975), path and box
            l_sums = (s.left_sum_g, s.left_sum_h, s.left_count,
                      s.left_output)
            r_sums = (s.right_sum_g, s.right_sum_h, s.right_count,
                      s.right_output)
            plo, phi = bounds.get(leaf, (-np.inf, np.inf))
            llo, lhi, rlo, rhi = plo, phi, plo, phi
            m = int(self.mono_np[feat])
            if m != 0:
                lout_f, rout_f = float(s.left_output), float(s.right_output)
                if inter_on:
                    if m > 0:
                        lhi, rlo = min(phi, rout_f), max(plo, lout_f)
                    else:
                        llo, rhi = max(plo, rout_f), min(phi, lout_f)
                else:
                    mid = (lout_f + rout_f) / 2.0
                    if m > 0:
                        lhi, rlo = min(phi, mid), max(plo, mid)
                    else:
                        llo, rhi = max(plo, mid), min(phi, mid)
            child_path = paths.get(leaf, frozenset()) | {feat}
            child_depth = int(tree.leaf_depth[leaf]) + 1
            if adv_on:
                # the parent's box narrowed on the split feature (a
                # categorical split sends bins to both sides: both keep it)
                lo_p, hi_p = boxes[leaf]
                l_box = (lo_p.copy(), hi_p.copy())
                r_box = (lo_p.copy(), hi_p.copy())
                if not cat:
                    l_box[1][feat] = thr + 1
                    r_box[0][feat] = thr + 1

            if not full:
                # the smaller child's histogram from K1 over its rows in the
                # parent's slice of the permutation (gather) or of the
                # sorted copies (a window), the larger's by subtraction
                with timer.phase("histogram"):
                    rc_dev = count - lc_dev
                    sil = lc_dev <= rc_dev
                    small_count = torch.where(sil, lc_dev, rc_dev).to(
                        torch.int32).reshape(1)
                    off = torch.where(sil, 0, lc_dev).to(
                        torch.int32).reshape(1)
                    h_small = leaf_histogram(lay, perm, begin, count, B,
                                             small_count, off, hscale)
                    h_large = subtract_histogram(hist[leaf], h_small)
                    h_lr = torch.stack([torch.where(sil, h_small, h_large),
                                        torch.where(sil, h_large, h_small)])
                self.hist_builds += 1
                up_sums, lo, hi = host_inputs([l_sums, r_sums],
                                              [(llo, lhi), (rlo, rhi)])
                cons = pen = None
                if adv_on:
                    with timer.phase("constraints"):
                        bx = dict(boxes)
                        bx[leaf], bx[new_leaf] = l_box, r_box
                        vals = {leaf: s.left_output,
                                new_leaf: s.right_output}
                        cons = (self.mono_arr,) + adv_bounds(
                            [leaf, new_leaf], bx,
                            lambda m_: vals.get(m_, tree.leaf_value[m_]))
                elif mono_on:
                    cons = (self.mono_arr, lo, hi)
                if self.cegb_on:
                    # the split pays its feature: the coupled cost for good,
                    # the lazy cost of every in-bag row of its parent
                    used = self._cegb_used.copy()
                    used[feat] = True
                    unpaid = None
                    if lazy:
                        unpaid = self._lazy_unpaid(rows, mask, lc_dev)
                        unpaid[:, feat] = 0
                    pen = penalties([s.left_count, s.right_count], used,
                                    unpaid)
                with timer.phase("split_scan"):
                    bs = scan(h_lr, up_sums, [child_depth] * 2,
                              [child_path] * 2, cons, pen,
                              lr_order[(~sil).long()])
                rec = torch.cat([lc_dev.to(torch.int32).reshape(1),
                                 _pack(bs).reshape(-1)]).cpu().numpy()
            else:
                rec = lc_dev.to(torch.int32).reshape(1).cpu().numpy()
            syncs += 1
            left_cnt = int(rec[0])
            right_cnt = count - left_cnt
            if left_cnt == 0 or right_cnt == 0:
                # a degenerate split: the leaf leaves the candidates
                log.warning("Degenerate split on leaf %d (feature %d): "
                            "left=%d right=%d; skipping", leaf, feat,
                            left_cnt, right_cnt)
                if saved is not None:
                    self._col_rng.set_state(saved[0])
                    self._extra_rng.set_state(saved[1])
                return None

            j = self.dataset.used_features[feat]
            mapper = self.dataset.mappers[j]
            # recorded counts are the in-bag histogram counts
            right_leaf = tree.split(
                leaf, feature=j, feature_inner=feat, threshold_bin=thr,
                threshold_real=mapper.bin_to_value(thr),
                default_left=s.default_left,
                missing_type=_MT_CODES[mapper.missing_type], gain=s.gain_f,
                left_value=float(s.left_output),
                right_value=float(s.right_output),
                left_weight=float(s.left_sum_h),
                right_weight=float(s.right_sum_h),
                left_count=int(round(float(s.left_count))),
                right_count=int(round(float(s.right_count))),
                is_categorical=cat, cat_bitset=s.cat_bitset.copy(),
                cat_bitset_real=(self._cat_bitset_real(feat, s.cat_bitset)
                                 if cat else None))
            if inter_on:
                # the new node's parent; the monotone subtree's members
                node_parent.append(pnode_before)
                if m != 0 or leaf_mono.get(leaf, False):
                    leaf_mono[leaf] = leaf_mono[right_leaf] = True
            leaf_begin[right_leaf] = begin + left_cnt
            leaf_count[leaf], leaf_count[right_leaf] = left_cnt, right_cnt
            bounds[leaf], bounds[right_leaf] = (llo, lhi), (rlo, rhi)
            paths[leaf] = paths[right_leaf] = child_path
            if adv_on:
                boxes[leaf], boxes[right_leaf] = l_box, r_box
            if self.cegb_on:
                # marked even on the tree's last split (learner.py:991-998)
                self._cegb_used[feat] = True
                if lazy:
                    self._lazy_mark(rows, mask, feat)
            if full:
                return right_leaf

            hist[leaf] = h_lr[0]
            hist[right_leaf] = h_lr[1]
            stored.pop(leaf, None)
            small_is_left = left_cnt <= right_cnt
            for lf_ in ((leaf, right_leaf) if small_is_left
                        else (right_leaf, leaf)):
                stored[lf_] = None
            recs = rec[1:].reshape(2, _REC_W)
            for r, lf_, sm in ((recs[0], leaf, l_sums),
                               (recs[1], right_leaf, r_sums)):
                sums[lf_] = sm
                best[lf_] = _HostSplit.from_record(r, sm)

            todo: List[int] = []
            if inter_on and not adv_on and leaf_mono.get(leaf, False):
                # tighten the bounds of contiguous leaves in monotone
                # ancestors' opposite subtrees, then re-scan them
                with timer.phase("constraints"):
                    upd = _intermediate_propagate(
                        tree, node_parent, tree.num_leaves - 2, feat, thr, s,
                        bounds, self.mono_np,
                        lambda lf_: lf_ in best
                        and np.isfinite(best[lf_].gain_f))
                todo = [u for u in set(upd) if u in stored]
            elif adv_on:
                # every leaf the parent's box constrained sees two new
                # outputs (reference: leaves_to_update_)
                lo_pre, hi_pre = boxes[leaf][0].copy(), boxes[leaf][1].copy()
                if not cat:
                    hi_pre[feat] = boxes[right_leaf][1][feat]
                todo = self._adv_affected(
                    lo_pre, hi_pre, boxes,
                    [u for u in stored if u not in (leaf, right_leaf)])
            if todo:
                rescan(todo)
            return right_leaf

        # -- forced splits (reference: serial_tree_learner.cpp:624
        # ForceSplits): BFS over the JSON tree before any gain-driven
        # split; a non-positive forced gain aborts the rest
        if self.forced_json is not None:
            q = deque([(self.forced_json, 0)])
            while q and tree.num_leaves < L:
                node, leaf = q.popleft()
                fb = self._forced_bin(node)
                if fb is None:
                    break
                k, thr_bin = fb
                if max_depth > 0 and tree.leaf_depth[leaf] >= max_depth:
                    break
                is_cat = bool(meta["is_categorical"][k])
                sv = self._upload(np.array([*sums[leaf],
                                            *bounds.get(leaf, (-inf, inf))],
                                           dtype=np.float32))
                res = gather_threshold_split(
                    hist[leaf, k], sv[0], sv[1], sv[2], sv[3], k, thr_bin,
                    int(meta["num_bins"][k]), int(meta["default_bins"][k]),
                    int(meta["missing_types"][k]), is_cat, p,
                    bounds=(sv[4], sv[5]) if mono_on else None)
                bits = (res.cat_bitset if is_cat else zero_bits).to(
                    torch.int32)
                fr = torch.cat([_f32_bits(torch.stack(
                    [res.gain, res.left_sum_g, res.left_sum_h,
                     res.left_count, res.left_output, res.right_output])),
                    torch.tensor([k, thr_bin, int(not is_cat), int(is_cat)],
                                 dtype=torch.int32, device=dev),
                    bits]).cpu().numpy()
                syncs += 1
                s = _HostSplit.from_record(fr, sums[leaf])
                if not np.isfinite(s.gain_f) or s.gain_f <= 0:
                    log.warning("Forced split on feature %d ignored (gain "
                                "not positive); aborting remaining forced "
                                "splits", int(node["feature"]))
                    break
                best.pop(leaf, None)
                right_leaf = apply_split(leaf, s)
                if right_leaf is None:
                    break
                for key, child in (("left", leaf), ("right", right_leaf)):
                    ch = node.get(key)
                    if (isinstance(ch, dict) and "feature" in ch
                            and "threshold" in ch):
                        q.append((ch, child))

        # -- the gain-driven loop: the leaf of largest gain, an exact tie
        # to the larger leaf id (``max`` over (gain, leaf); reference:
        # serial_tree_learner.cpp:225 ArgMax)
        while tree.num_leaves < L:
            cand = [(s.gain_f, leaf) for leaf, s in best.items()
                    if np.isfinite(s.gain_f) and s.gain_f > 0
                    and (max_depth <= 0 or tree.leaf_depth[leaf] < max_depth)]
            if not cand:
                break
            _, leaf = max(cand)
            apply_split(leaf, best.pop(leaf))

        # -- row -> leaf from the final permutation (JAX gbdt.py:70
        # _add_tree_score: each position's leaf by its slice's begin)
        nl = tree.num_leaves
        self.last_perm = perm
        self.last_leaf_begin = leaf_begin[:nl].copy()
        self.last_leaf_count = leaf_count[:nl].copy()
        order = np.argsort(self.last_leaf_begin, kind="stable")
        up = self._upload(np.stack([self.last_leaf_begin[order], order]))
        which = torch.searchsorted(up[0], torch.arange(N, device=dev),
                                   right=True) - 1
        row_leaf = torch.empty(N, dtype=torch.int64, device=dev)
        row_leaf[perm.long()] = up[1][which]
        self.last_row_leaf = row_leaf
        self.host_syncs = syncs + lay.reads
        self.phase_ms = timer.totals_ms()
        return tree
