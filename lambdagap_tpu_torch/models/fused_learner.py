"""Device-resident leaf-wise tree learner.

The port of ``lambdagap_tpu/models/fused_learner.py``. The JAX learner
compiles one whole tree into one XLA program (a ``fori_loop`` over splits
with masked no-op steps and no host sync). PyTorch runs eagerly, so the
port keeps the algorithm and the device residency, not the loop form:

* The binned matrix (row-major ``[N, C]`` for the histogram kernel and,
  under ``tree_layout=gather``, a column-major copy for the partition),
  grad/hess, the leaf permutation, the per-leaf and per-node tables and
  the per-leaf histograms ``[L, C, B, 3]`` f32 all live on the device.
* Each split step reads back ONE record of 10 to 21 int64s — the chosen
  leaf, whether its stored best gain is > 0, its begin, count, split
  feature, depth, parent pointer, threshold and kind (with forced splits
  also the forced leaf's and the forced split's validity; in a round's
  first tree also the non-finite guard's flag) — and the loop stops at
  the first step where no leaf can split. The masked JAX loop leaves its state unchanged
  from that step on, so the tree is the same. ``host_syncs`` counts the
  reads of the last tree.
* The split leaf is the first argmax of the stored best gains; the smaller
  child's histogram comes from the CUDA kernel (``ops/hist_cuda``), which
  reads the child's rows in place in the parent's slice of the permutation
  (a device offset, no gather), the larger child's is the parent's minus
  it; both children's best splits are scanned in one batched call; leaf
  and node ids are assigned as the JAX state updates assign them;
  ``row_leaf`` comes from the final permutation.
* The partition is a stable partition of the chosen leaf's slice in plain
  torch ops (left rows first, each side in slice order).
* A bagging/GOSS in-bag mask rides into every histogram kernel launch:
  out-of-bag rows stay in the partition and add nothing to any channel.
* ``use_quantized_grad``: each tree splits its own key off
  ``PRNGKey(data_random_seed + 7919)``, quantizes grad/hess to int8 levels
  (``ops.hist_cuda.quantize_gradients``), and builds every leaf histogram
  with the int8 kernel (K2, exact int32 sums). Each is scaled to f32 at
  once, as the JAX program does in its exact-accumulation mode, so the
  stored histograms, the subtraction and the scans are the f32 path's;
  ``quant_train_renew_leaf`` refits the leaf values from the full-precision
  sums of each leaf's slice of the final permutation.
* EFB: when the dataset forms a bundle, both row layouts hold the bundled
  columns; histograms are built and stored over them and un-bundled to
  per-feature space before each scan, and the partition decodes the split
  feature's bin from its bundle column.

* The tree options run in the same loop, at the JAX program's semantics
  and random streams (fused_learner.py:156-172, :685-731, :739-920,
  :963-975, :1026-1146, :1298-1311, :1338-1370, :1383-1520):
  extra_trees' thresholds (``randint`` of ``fold_in`` keys off
  ``PRNGKey(extra_seed)``) and the by-node and interaction feature masks
  (off ``PRNGKey(feature_fraction_seed + 7)``) are drawn on the host a
  leaf at a time and go up in one pinned copy; monotone bounds are two
  more ``leaf_f`` columns that clamp the scan and the children (basic: the
  mid of the two outputs, intermediate: the sibling's); ``feature_contri``
  and the monotone split penalty scale the post-shift gain; a forced split
  is gathered from its leaf's histogram, and its validity rides the
  step's record read (invalid: forcing stops and the same step takes the
  argmax). The intermediate method walks up the split leaf's ancestors
  with its control on the host (which has read every split) and its
  ``[L]``-vector updates on the device; the leaves it tightens are read
  back once (a second host read of that step) and re-scanned in one
  batched scan before the next step's argmax.

* ``tree_layout=sorted`` (``auto`` at 2^20 rows and more, as the JAX
  learner resolves it): each tree (each class's, under multiclass) first
  copies the rows, the channels — grad/hess, or the quantized levels
  drawn in dataset order — and the in-bag mask into persistent
  leaf-ordered buffers (``row_layout``, ``ops/partition.SortedRows``,
  phase ``layout_apply``; the JAX learner's ``srows``, :401-410); every leaf
  histogram reads a window of them at ``begin + offset`` with no row list,
  and the partition reads the split column from the leaf's window (EFB:
  its bundle column, decoded) and moves the rows, channels and mask with
  the permutation. No column-major copy is kept. The permutation is kept
  too, so ``row_leaf`` and the leaf renewal read through it as under
  gather, and the trees equal gather's bit for bit.

* ``data_residency=stream`` (``lambdagap_tpu/models/fused_learner.py:
  1588-2215``): the binned matrix stays in host shards and the layout is
  ``ops/partition.StreamRows``; the loop is the one above. The split
  column is gathered on the host and uploaded, the go-left flags come
  back once a split (the learner's second host read of a step: the
  smaller child's span and the host mirror need them), and every
  histogram is a loop of uploaded windows into K1's accumulate mode, so
  the trees equal resident training's. As in the JAX package, quantized
  gradients, forced splits, interaction constraints, extra_trees, by-node
  sampling, monotone constraints and ``feature_contri`` fall back to
  ``hbm`` with its warning (K2 is never streamed), and EFB is not formed.

CEGB and ``monotone_constraints_method=advanced`` train on the host-driven
``SerialTreeLearner`` (``models/learner.py``), where the booster routes
them.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..config import Config
from ..data.bundling import unbundle_map
from ..data.dataset import BinnedDataset
from ..ops.hist_cuda import (exact_accum_limit, hist_scale,
                             quantize_gradients)
from ..ops.histogram import leaf_histogram, subtract_histogram, \
    unbundle_hist
from ..ops.partition import decision_go_left, decode_bundled
from ..ops.split import CAT_WORDS, K_MIN_SCORE, BestSplit, best_split, \
    calculate_leaf_output, gather_threshold_split
from ..utils import log, prng
from .learner import SerialTreeLearner, _next_pow2, _PhaseTimer
from .tree import Tree

# leaf_f columns (the last two: the leaf's monotone bounds)
LF_G, LF_H, LF_C, LF_OUT, LF_GAIN, LF_LG, LF_LH, LF_LC, LF_LOUT, LF_ROUT, \
    LF_MIN, LF_MAX = range(12)
# leaf_i columns
LI_BEGIN, LI_COUNT, LI_DEPTH, LI_PARENT, LI_IS_LEFT, LI_FEAT, LI_THR, \
    LI_DL, LI_CAT = range(9)


class DeviceTree(NamedTuple):
    """One trained tree, resident on the device."""
    node_feature: torch.Tensor      # int64 [NODES] inner feature index
    node_threshold: torch.Tensor    # int64 [NODES]
    node_default_left: torch.Tensor  # bool [NODES]
    node_is_cat: torch.Tensor       # bool [NODES]
    node_cat_bits: torch.Tensor     # int64 [NODES, 8] (u32 words)
    node_left: torch.Tensor         # int64 [NODES] (>= 0 node, < 0 ~leaf)
    node_right: torch.Tensor        # int64 [NODES]
    node_gain: torch.Tensor         # f32 [NODES]
    node_value: torch.Tensor        # f32 [NODES] parent output
    node_weight: torch.Tensor       # f32 [NODES] parent hess sum
    node_count: torch.Tensor        # f32 [NODES]
    leaf_value: torch.Tensor        # f32 [L]
    leaf_weight: torch.Tensor       # f32 [L]
    leaf_count: torch.Tensor        # f32 [L]
    leaf_depth: torch.Tensor        # int64 [L]
    leaf_parent_node: torch.Tensor  # int64 [L]
    num_leaves: int
    max_depth: int
    row_leaf: Optional[torch.Tensor]  # int64 [N] leaf of each training row


class FusedTreeLearner(SerialTreeLearner):
    """Leaf-wise learner whose state stays on the device."""

    def __init__(self, dataset: BinnedDataset, config: Config,
                 device: torch.device) -> None:
        super().__init__(dataset, config, device)
        # quantized gradients (the JAX learner, fused_learner.py:116-155):
        # K2 sums int8 levels in int32, exact while rows x levels stays
        # below int32 max; past it each histogram sums int32 windows of
        # limit // levels positions in int64 (exact, where the JAX learner
        # falls back to per-chunk scaled float32 sums)
        self.quant = bool(config.use_quantized_grad)
        self.q_window = None
        if self.quant:
            qb = config.num_grad_quant_bins
            limit = exact_accum_limit("pallas")
            if self.num_data * qb >= limit:
                self.q_window = limit // qb
                log.warning("quantized histogram level sums may exceed the "
                            "int32 accumulator (%d rows x %d levels); "
                            "summing K2 windows of %d rows in int64",
                            self.num_data, qb, self.q_window)
            self._qkey = prng.PRNGKey(config.data_random_seed + 7919)
        # the tree options' step state (fused_learner.py:156-172); the
        # booster routes monotone_constraints_method=advanced to the
        # serial learner
        self.inter = self.mono_on and self.mono_method == "intermediate"
        self.bynode = config.feature_fraction_bynode < 1.0
        self.forced_seq = (self._build_forced_seq(max(config.num_leaves - 1,
                                                      1))
                           if self.forced_json is not None else None)
        self._need_step_keys = self.extra_on or self.bynode
        if self._need_step_keys:
            # independent streams: extra_seed drives the random
            # thresholds, feature_fraction_seed the by-node sampling
            self._ekey = prng.PRNGKey(config.extra_seed)
            self._bkey = prng.PRNGKey(config.feature_fraction_seed + 7)
        self._rec_cols = torch.tensor([LI_BEGIN, LI_COUNT, LI_FEAT, LI_DEPTH,
                                       LI_PARENT, LI_IS_LEFT, LI_THR,
                                       LI_CAT], device=device)

    def _stream_blockers(self, config: Config) -> List[str]:
        """Options the stream mode does not carry, from the config alone
        (JAX ``fused_learner.py:1606-1625``): training falls back to hbm
        with a warning."""
        blockers = []
        if config.use_quantized_grad:
            blockers.append("use_quantized_grad")
        if config.forcedsplits_filename:
            blockers.append("forcedsplits_filename")
        if config.interaction_constraints:
            blockers.append("interaction_constraints")
        if config.extra_trees:
            blockers.append("extra_trees")
        if config.feature_fraction_bynode < 1.0:
            blockers.append("feature_fraction_bynode")
        if config.monotone_constraints and any(
                int(m) != 0 for m in config.monotone_constraints):
            blockers.append("monotone_constraints")
        if config.feature_contri:
            blockers.append("feature_contri")
        return blockers

    def _estimate_residency_bytes(self) -> int:
        """The JAX fused learner's estimate (``fused_learner.py:
        1627-1634``): the packed rows with their channels, twice (the
        layout's second copy)."""
        item = 1 if int(self.meta_host["num_bins"].max()) <= 256 else 2
        return 2 * self.num_data * (self.num_features * item + 9)

    def _upload_matrix(self) -> None:
        """The binned matrix on the device, row-major, bundled when EFB
        forms a bundle (the JAX learner, fused_learner.py:91-114: histograms
        and partitions run over the bundled columns); the constructor adds
        the layout's second copy, column-major or leaf-ordered."""
        meta, device = self.meta_host, self.device
        bun = self.dataset.ensure_bundle(self.config)
        self.bundle = bun
        if bun is not None:
            hx = bun.cols
            self.Bb = _next_pow2(max(bun.num_bins))
            src, kind = unbundle_map(bun, meta["num_bins"],
                                     meta["default_bins"], self.B, self.Bb)
            self.ub_src = torch.from_numpy(src.astype(np.int64)).to(device)
            self.ub_kind = torch.from_numpy(kind).to(device)
        else:
            hx = self.dataset.binned
            self.Bb = self.B
        self.x_rows = torch.from_numpy(np.ascontiguousarray(hx)).to(device)

    def _build_forced_seq(self, nodes: int):
        """The forced-split JSON as a BFS schedule of (leaf, inner feature,
        threshold bin), one entry per split step from the root on (the JAX
        learner, fused_learner.py:203-231): the split at step k hands its
        right child leaf id k + 1. Truncated at the first unmappable node;
        None when nothing maps."""
        seq = []
        q = [(self.forced_json, 0)]
        while q and len(seq) < nodes:
            node, leaf = q.pop(0)
            fb = self._forced_bin(node)
            if fb is None:
                break
            step = len(seq)
            seq.append((leaf, fb[0], fb[1]))
            for key, child in (("left", leaf), ("right", step + 1)):
                ch = node.get(key)
                if (isinstance(ch, dict) and "feature" in ch
                        and "threshold" in ch):
                    q.append((ch, child))
        return seq or None

    def _node_fmask(self, fmask: np.ndarray, path: frozenset,
                    key: Optional[torch.Tensor]) -> np.ndarray:
        """A leaf's feature mask on the host (the JAX learner's
        ``node_fmask``, fused_learner.py:708-731): the tree's mask filtered
        to the union of the interaction groups that contain the leaf's
        path (the root's empty path: every group, so a feature outside all
        groups is never used), then by-node sampling keeps the
        ceil(fraction x available) features of largest uniform draw."""
        m = fmask.copy()
        if self.ic_groups is not None:
            allowed = np.zeros_like(m)
            for g in self.ic_groups:
                if path <= g:
                    allowed[list(g)] = True
            m &= allowed
        if self.bynode:
            F = self.num_features
            r = np.where(m, prng.uniform_host(key.numpy()[None], F)[0],
                         np.float32(-np.inf))
            avail = np.float32(m.sum())
            k = max(np.ceil(np.float32(self.config.feature_fraction_bynode)
                            * avail), np.float32(1.0))
            rank = np.argsort(np.argsort(-r, kind="stable"), kind="stable")
            m &= rank < int(k)
        return m

    # ------------------------------------------------------------------
    def train_device(self, grad: torch.Tensor, hess: torch.Tensor,
                     row_mask: Optional[torch.Tensor] = None) -> DeviceTree:
        """Grow one tree on the device from f32 grad/hess [N] and an
        optional bool in-bag mask [N] (None: every row)."""
        cfg = self.config
        dev = self.device
        N, L, F = self.num_data, cfg.num_leaves, self.num_features
        C = F if self.x_rows is None else self.x_rows.shape[1]
        Bb = self.Bb
        NODES = max(L - 1, 1)
        p = self.params
        meta = self.meta_host
        timer = _PhaseTimer(self.time_phases and dev.type == "cuda")
        fmask_np = self._feature_mask()
        fmask = self._upload(fmask_np)
        grad = grad.contiguous()
        hess = hess.contiguous()
        mask = None if row_mask is None else row_mask.contiguous()
        mono_on, inter = self.mono_on, self.inter
        ic_on = self.ic_groups is not None
        draws = self.extra_on or ic_on or self.bynode
        use_mult = self.contri_arr is not None or (mono_on
                                                   and self.mono_penalty > 0)
        base_args = (self.num_bins_arr, self.default_bins_arr,
                     self.missing_types_arr, self.is_categorical_arr)

        if self.quant:
            keys = prng.split(self._qkey)
            self._qkey = keys[0]
            with timer.phase("quantize"):
                gq, hq, gs, hs = quantize_gradients(
                    grad, hess, keys[1], cfg.num_grad_quant_bins,
                    cfg.stochastic_rounding)
                qscale = torch.stack([gs, hs, torch.ones_like(gs)])
            hscale = None
        else:
            # K1's fixed-point exponents, once per tree (no host read)
            hscale = hist_scale(grad, hess)
        lay = self.row_layout
        # sorted: the tree's leaf-ordered copies, from the dataset-order
        # channels and mask (fused_learner.py:401-410)
        with timer.phase("layout_apply"):
            if self.quant:
                lay.rebuild(gq, hq, mask)
            else:
                lay.rebuild(grad, hess, mask)
        # two independent streams a tree (fused_learner.py:395-398): [0]
        # extra_trees' thresholds, [1] by-node sampling
        xkey = bkey = None
        if self._need_step_keys:
            k2 = prng.split(self._ekey)
            self._ekey, xkey = k2[0], k2[1]
            k2 = prng.split(self._bkey)
            self._bkey, bkey = k2[0], k2[1]

        def leaf_hist(begin, count, live=None, offset=None) -> torch.Tensor:
            """One f32 [C, Bb, 3] histogram from the kernel over the first
            ``live`` positions from ``offset`` of the leaf ``[begin, begin +
            count)`` (None: all of it); under quantization the exact int32
            level sums scaled to gradient units (the JAX learner,
            fused_learner.py:679-681)."""
            h = leaf_histogram(lay, perm, begin, count, Bb, live, offset,
                               hscale, self.q_window)
            return h.float() * qscale if self.quant else h

        def scan_hist(h, sums) -> torch.Tensor:
            """Stored histograms [..., C, Bb, 3] -> per-feature [..., F, B,
            3] for the scan; sums [..., 3] are each leaf's own totals."""
            if self.bundle is None:
                return h
            return unbundle_hist(h, self.ub_src, self.ub_kind, sums)

        def scan(h, sums, depths, xkeys, bkeys, paths, lo, hi) -> BestSplit:
            """Best splits of a batch of n leaves: histograms [n, C, Bb,
            3], sums [n, 4] (g, h, count, output), host depths, each
            leaf's keys and path, monotone bounds [n]. The random
            thresholds and feature masks are drawn on the host and go up
            in one copy."""
            rand, fm = None, fmask
            if draws:
                parts = []
                if self.extra_on:
                    parts.append(prng.randint(torch.stack(xkeys), F, 0,
                                              1 << 30) % self.nb_minus1)
                if ic_on or self.bynode:
                    parts.append(np.stack([
                        self._node_fmask(fmask_np, pth, bk) for pth, bk in
                        zip(paths, bkeys or [None] * len(paths))]))
                up = self._upload(np.concatenate(
                    [a.astype(np.int64) for a in parts], axis=1))
                if self.extra_on:
                    rand = up[:, :F]
                if ic_on or self.bynode:
                    fm = up[:, -F:] != 0
            mult = (torch.stack([self._mult_row(d) for d in depths])
                    if use_mult else None)
            depth = (depths[0] if len(set(depths)) == 1
                     else self._upload(np.asarray(depths)))
            return best_split(
                scan_hist(h, sums[:, :3]), sums[:, 0], sums[:, 1],
                sums[:, 2], sums[:, 3], depth, *base_args, fm, p,
                self.has_categorical, cfg.max_depth,
                constraints=(self.mono_arr, lo, hi) if mono_on else None,
                rand_thresholds=rand, gain_mult=mult)

        perm = torch.arange(N, dtype=torch.int32, device=dev)
        hist = torch.zeros((L, C, Bb, 3), dtype=torch.float32, device=dev)
        with timer.phase("histogram"):
            hist[0] = leaf_hist(0, N)
        self.hist_builds = 1
        # the root's sums over the first stored column's bins, taken in
        # float64 so the card and the CPU agree to the bit
        totals = hist[0, 0].double().sum(dim=0).float()
        root_out = calculate_leaf_output(totals[0], totals[1], p, totals[2],
                                         0.0)
        inf = torch.full((1,), float("inf"), device=dev)
        root_sums = torch.stack([totals[0], totals[1], totals[2],
                                 root_out])[None]
        with timer.phase("split_scan"):
            b0 = scan(hist[0][None], root_sums, [0],
                      None if xkey is None else [prng.fold_in(xkey, NODES)],
                      None if bkey is None else [prng.fold_in(bkey, NODES)],
                      [frozenset()], -inf, inf)

        leaf_f = torch.zeros((L, 12), dtype=torch.float32, device=dev)
        leaf_f[:, LF_GAIN] = K_MIN_SCORE
        leaf_f[:, LF_MIN] = float("-inf")
        leaf_f[:, LF_MAX] = float("inf")
        leaf_f[0] = torch.cat([root_sums[0], torch.stack(
            [b0.gain[0], b0.left_g[0], b0.left_h[0], b0.left_c[0],
             b0.left_output[0], b0.right_output[0]]), -inf, inf])
        leaf_i = torch.zeros((L, 9), dtype=torch.int64, device=dev)
        leaf_i[:, LI_PARENT] = -1
        leaf_i[0, LI_COUNT] = N
        leaf_i[0, LI_FEAT:] = torch.stack([
            b0.feature[0], b0.threshold[0], b0.default_left[0].long(),
            b0.is_categorical[0].long()])
        leaf_bits = torch.zeros((L, CAT_WORDS), dtype=torch.int64,
                                device=dev)
        leaf_bits[0] = b0.cat_bitset[0]
        node_f = torch.zeros((NODES, 4), dtype=torch.float32, device=dev)
        node_i = torch.zeros((NODES, 6), dtype=torch.int64, device=dev)
        node_i[:, 4:6] = ~0
        node_bits = torch.zeros((NODES, CAT_WORDS), dtype=torch.int64,
                                device=dev)
        # host-side per-leaf depth and interaction path (the host reads
        # every split's leaf and feature anyway)
        leaf_depth = [0] * L
        leaf_path = [frozenset()] * L
        if inter:
            # per-leaf bin-space boxes [lo, hi) per feature, per-leaf
            # ancestor-node sets, the stale marks (fused_learner.py:
            # 1014-1023); the node parent pointers and split fields stay on
            # the host, which reads them as the splits happen
            box_lo = torch.zeros((L, F), dtype=torch.int64, device=dev)
            box_hi = torch.zeros((L, F), dtype=torch.int64, device=dev)
            box_hi[0] = self.num_bins_arr
            npath = torch.zeros((L, NODES), dtype=torch.bool, device=dev)
            stale = torch.zeros(L, dtype=torch.bool, device=dev)
            node_host = []      # (parent, was_left, feature, thr, is_cat)
            xres, bres = (None if xkey is None else prng.fold_in(xkey,
                                                                 NODES + 1),
                          None if bkey is None else prng.fold_in(bkey,
                                                                 NODES + 1))
        forced = self.forced_seq
        forcing = forced is not None

        rec_cols = self._rec_cols
        num_leaves = 1
        max_depth = 0
        syncs = 0
        self.guard_read = None
        # The loop counter k is the JAX program's step index (the keys fold
        # it in). The port leaves the loop at the first step with nothing
        # to split; the JAX program runs on with masked no-op steps, which
        # is the same tree only because a no-op step is followed by no-op
        # steps alone: the forced schedule is a prefix of the steps and an
        # aborted forced split turns forcing off for good, and a no-op step
        # marks no leaf stale.
        for k in range(NODES if L > 1 else 0):
            # -- the one host read of the step ---------------------------
            leaf_t = torch.argmax(leaf_f[:, LF_GAIN])
            parts = [(leaf_f[leaf_t, LF_GAIN] > 0.0).long()[None],
                     leaf_t[None], leaf_i[leaf_t].index_select(0, rec_cols)]
            forced_now = forcing and k < len(forced)
            if forced_now:
                # the forced split's stats from the forced leaf's histogram
                # (fused_learner.py:1092-1146); invalid, forcing aborts and
                # this same step takes the argmax split
                fleaf, fk, fthr = forced[k]
                fcat = bool(meta["is_categorical"][fk])
                flf = leaf_f[fleaf]
                with timer.phase("split_scan"):
                    res = gather_threshold_split(
                        scan_hist(hist[fleaf], flf[:3])[fk], flf[LF_G],
                        flf[LF_H], flf[LF_C], flf[LF_OUT], fk, fthr,
                        int(meta["num_bins"][fk]),
                        int(meta["default_bins"][fk]),
                        int(meta["missing_types"][fk]), fcat, p,
                        bounds=((flf[LF_MIN], flf[LF_MAX]) if mono_on
                                else None))
                parts += [(res.gain > 0.0).long()[None],
                          leaf_i[fleaf].index_select(0, rec_cols)]
            if k == 0 and self.guard_flag is not None:
                # the non-finite guard's flag rides the round's first read
                parts.append(self.guard_flag.long().reshape(-1))
            rec = torch.cat(parts).tolist()
            syncs += 1
            if k == 0 and self.guard_flag is not None:
                gn = self.guard_flag.numel()
                self.guard_read = [bool(v) for v in rec[-gn:]]
            ok, leaf = rec[0], rec[1]
            begin, count, feat, depth, pnode, was_left, thr, cat = rec[2:10]
            if forced_now:
                if rec[10] and (cfg.max_depth <= 0 or rec[14] < cfg.max_depth):
                    # the valid forced split written over the forced leaf's
                    # best split (fused_learner.py:1124-1145); the step then
                    # splits that leaf as it would the argmax one
                    leaf_f[fleaf, LF_GAIN:LF_MIN] = torch.stack(
                        [res.gain, res.left_sum_g, res.left_sum_h,
                         res.left_count, res.left_output, res.right_output])
                    leaf_i[fleaf, LI_FEAT:] = self._upload(np.array(
                        [fk, fthr, int(not fcat), int(fcat)], np.int64))
                    leaf_bits[fleaf] = res.cat_bitset
                    ok, leaf = 1, fleaf
                    begin, count, _, depth, pnode, was_left = rec[11:17]
                    feat, thr, cat = fk, fthr, int(fcat)
                else:
                    forcing = False
            if not ok:
                break
            new_leaf = num_leaves
            nidx = new_leaf - 1
            lf = leaf_f[leaf].clone()
            # views: the step reads them before it rewrites the leaf's rows
            li, bits = leaf_i[leaf], leaf_bits[leaf]

            # -- stable partition of the leaf's slice --------------------
            with timer.phase("partition"):
                bun = self.bundle
                col = feat if bun is None else int(bun.col_of[feat])
                cv = lay.column(perm, begin, count, col)
                if bun is not None and not bun.single[feat]:
                    cv = decode_bundled(cv, int(bun.off_of[feat]),
                                        int(meta["default_bins"][feat]),
                                        int(meta["num_bins"][feat]))
                gl = decision_go_left(
                    cv, li[LI_THR], li[LI_DL] == 1,
                    int(meta["default_bins"][feat]),
                    int(meta["missing_types"][feat]),
                    int(meta["num_bins"][feat]), bool(cat), bits)
                left_count = lay.split(perm, begin, count, gl)
            right_count = count - left_count

            # -- node bookkeeping ----------------------------------------
            if pnode >= 0:
                node_i[pnode, 4 if was_left else 5] = nidx
            node_f[nidx] = torch.stack([lf[LF_GAIN], lf[LF_OUT], lf[LF_H],
                                        lf[LF_C]])
            node_i[nidx, :4] = li[LI_FEAT:]
            node_i[nidx, 4] = ~leaf
            node_i[nidx, 5] = ~new_leaf
            node_bits[nidx] = bits

            # -- children histograms: smaller built, larger subtracted ---
            with timer.phase("histogram"):
                small_is_left = left_count <= right_count
                small_count = torch.where(small_is_left, left_count,
                                          right_count).to(torch.int32)
                # the smaller child's rows are the parent's slice (or
                # window) from `off` on: the kernel reads them there
                off = torch.where(small_is_left, 0, left_count).to(
                    torch.int32).reshape(1)
                hist_small = leaf_hist(begin, count, small_count.reshape(1),
                                       off)
                hist_large = subtract_histogram(hist[leaf], hist_small)
                hist_left = torch.where(small_is_left, hist_small,
                                        hist_large)
                hist_right = torch.where(small_is_left, hist_large,
                                         hist_small)
                hist[leaf] = hist_left
                hist[new_leaf] = hist_right
            self.hist_builds += 1

            # -- children's monotone bounds (fused_learner.py:1298-1311):
            # basic caps each child at the mid of the two outputs,
            # intermediate by its sibling's output
            lout, rout = lf[LF_LOUT], lf[LF_ROUT]
            pmin, pmax = lf[LF_MIN], lf[LF_MAX]
            mf = int(self.mono_np[feat])
            if mf != 0:
                lcap, rcap = ((rout, lout) if inter
                              else ((lout + rout) * 0.5,) * 2)
                bmin = torch.stack([
                    torch.maximum(pmin, lcap) if mf < 0 else pmin,
                    torch.maximum(pmin, rcap) if mf > 0 else pmin])
                bmax = torch.stack([
                    torch.minimum(pmax, lcap) if mf > 0 else pmax,
                    torch.minimum(pmax, rcap) if mf < 0 else pmax])
            else:
                # the children inherit the parent's bounds
                bmin, bmax = pmin.expand(2), pmax.expand(2)

            # -- both children's best splits in one batched scan ---------
            lg, lh, lc = lf[LF_LG], lf[LF_LH], lf[LF_LC]
            sums = torch.stack([
                torch.stack([lg, lh, lc, lout]),
                torch.stack([lf[LF_G] - lg, lf[LF_H] - lh, lf[LF_C] - lc,
                             rout])])                          # [2, 4]
            child_path = (leaf_path[leaf] | {feat}) if ic_on else frozenset()
            ckx = ckb = None
            if xkey is not None:
                xs, bs_ = prng.fold_in(xkey, k), prng.fold_in(bkey, k)
                ckx = [prng.fold_in(xs, 0), prng.fold_in(xs, 1)]
                ckb = [prng.fold_in(bs_, 2), prng.fold_in(bs_, 3)]
            with timer.phase("split_scan"):
                bs = scan(torch.stack([hist_left, hist_right]), sums,
                          [depth + 1] * 2, ckx, ckb, [child_path] * 2, bmin,
                          bmax)
            rows_f = torch.cat(
                [sums, torch.stack([bs.gain, bs.left_g, bs.left_h, bs.left_c,
                                    bs.left_output, bs.right_output], 1),
                 bmin[:, None], bmax[:, None]], 1)
            rows_i = torch.empty((2, 9), dtype=torch.int64, device=dev)
            rows_i[0, LI_BEGIN] = begin
            rows_i[0, LI_COUNT] = left_count
            rows_i[1, LI_BEGIN] = left_count + begin
            rows_i[1, LI_COUNT] = right_count
            rows_i[:, LI_DEPTH] = depth + 1
            rows_i[:, LI_PARENT] = nidx
            rows_i[0, LI_IS_LEFT] = 1
            rows_i[1, LI_IS_LEFT] = 0
            rows_i[:, LI_FEAT:] = torch.stack(
                [bs.feature, bs.threshold, bs.default_left.long(),
                 bs.is_categorical.long()], 1)

            marked = False
            if inter:
                with timer.phase("constraints"):
                    marked = self._propagate(
                        leaf_f, leaf_i, stale, box_lo, box_hi, npath,
                        node_host, pnode, bool(was_left), feat, thr,
                        bool(cat), lout, rout)
                    node_host.append((pnode, bool(was_left), feat, thr,
                                      bool(cat)))
                    plo, phi = box_lo[leaf].clone(), box_hi[leaf].clone()
                    if not cat:
                        box_hi[leaf, feat] = thr + 1
                        box_lo[new_leaf] = plo
                        box_lo[new_leaf, feat] = thr + 1
                        box_hi[new_leaf] = phi
                    else:
                        box_lo[new_leaf], box_hi[new_leaf] = plo, phi
                    anc = npath[leaf].clone()
                    anc[nidx] = True
                    npath[leaf] = anc
                    npath[new_leaf] = anc
            for side, row in ((0, leaf), (1, new_leaf)):
                leaf_f[row] = rows_f[side]
                leaf_i[row] = rows_i[side]
                leaf_bits[row] = bs.cat_bitset[side]
                leaf_depth[row] = depth + 1
                leaf_path[row] = child_path
            num_leaves += 1
            max_depth = max(max_depth, depth + 1)

            if marked and k + 1 < NODES:
                # the leaves whose bounds tightened, re-scanned before the
                # next step's argmax (fused_learner.py:1036-1086) in one
                # batched scan, each with the key of its own JAX trip
                stale[leaf] = False
                stale[new_leaf] = False
                todo = torch.nonzero(stale).flatten().tolist()
                syncs += 1
                stale.zero_()
                if todo:
                    nk = (k + 1) * (L + 1)
                    with timer.phase("constraints"):
                        self._rescan(
                            todo, leaf_f, leaf_i, leaf_bits, hist, scan,
                            [leaf_depth[r] for r in todo],
                            None if xres is None else
                            [prng.fold_in(xres, nk + r) for r in todo],
                            None if bres is None else
                            [prng.fold_in(bres, nk + r) for r in todo],
                            [leaf_path[r] for r in todo])

        # -- row -> leaf from the final permutation ------------------------
        iota = torch.arange(L, device=dev)
        leaf_begin = torch.where((leaf_i[:, LI_COUNT] > 0) & (iota <
                                                               num_leaves),
                                 leaf_i[:, LI_BEGIN], N + iota)
        order = torch.argsort(leaf_begin)
        which = torch.searchsorted(leaf_begin[order],
                                   torch.arange(N, device=dev),
                                   right=True) - 1
        row_leaf = torch.empty(N, dtype=torch.int64, device=dev)
        row_leaf[perm.long()] = order[which]
        # an unsplittable tree contributes nothing (reference: gbdt.cpp:408-436
        # AsConstantTree(0))
        leaf_value = (leaf_f[:, LF_OUT] if num_leaves > 1
                      else torch.zeros_like(leaf_f[:, LF_OUT]))
        if self.quant and cfg.quant_train_renew_leaf and num_leaves > 1:
            with timer.phase("renew"):
                leaf_value = self._renew_leaves(
                    grad, hess, perm, leaf_f, leaf_i, node_f, num_leaves,
                    leaf_value)
            syncs += 1
        self.host_syncs = syncs + lay.reads
        self.phase_ms = timer.totals_ms()
        return DeviceTree(
            node_feature=node_i[:, 0], node_threshold=node_i[:, 1],
            node_default_left=node_i[:, 2] == 1,
            node_is_cat=node_i[:, 3] == 1, node_cat_bits=node_bits,
            node_left=node_i[:, 4], node_right=node_i[:, 5],
            node_gain=node_f[:, 0], node_value=node_f[:, 1],
            node_weight=node_f[:, 2], node_count=node_f[:, 3],
            leaf_value=leaf_value, leaf_weight=leaf_f[:, LF_H],
            leaf_count=leaf_f[:, LF_C], leaf_depth=leaf_i[:, LI_DEPTH],
            leaf_parent_node=leaf_i[:, LI_PARENT], num_leaves=num_leaves,
            max_depth=max_depth, row_leaf=row_leaf)

    def rng_state(self) -> tuple:
        """The learner's random streams: the quantization, extra_trees and
        by-node keys and the per-tree column sampler."""
        return (getattr(self, "_qkey", None), getattr(self, "_ekey", None),
                getattr(self, "_bkey", None), self._col_rng.get_state())

    def set_rng_state(self, st: tuple) -> None:
        for name, key in zip(("_qkey", "_ekey", "_bkey"), st[:3]):
            if key is not None:
                setattr(self, name, key)
        self._col_rng.set_state(st[3])

    def _propagate(self, leaf_f, leaf_i, stale, box_lo, box_hi, npath,
                   node_host, a: int, child_left: bool, feat: int, thr: int,
                   cat: bool, lout, rout) -> bool:
        """The intermediate method's propagation after a split
        (fused_learner.py:1383-1476; reference: monotone_constraints.hpp
        GoUpToFindLeavesToUpdate / GoDownToFindLeavesToUpdate): walk up
        from the split leaf's parent node; at each monotone numerical
        ancestor, tighten the bounds of the leaves of the opposite subtree
        that stay contiguous to the split leaf with the new children's
        outputs, and mark them stale. The walk's control (the ancestors,
        their split fields, the crossings) runs on the host, which has
        read every split; its [L]-vector updates run on the device, with
        no host read. Returns whether any bound could have moved."""
        cfg = self.config
        big = 1 << 30
        splittable = leaf_f[:, LF_GAIN] > K_MIN_SCORE
        if cfg.max_depth > 0:
            splittable &= leaf_i[:, LI_DEPTH] < cfg.max_depth
        sf_lo, sf_hi = box_lo[:, feat], box_hi[:, feat]
        keep = None
        crossed = set()
        marked = False
        while a >= 0:
            parent, side, g, t_a, cat_a = node_host[a]
            if not cat_a and (g, child_left) not in crossed:
                m_g = int(self.mono_np[g])
                if m_g != 0:
                    opp = npath[:, a] & (box_lo[:, g] > t_a if child_left
                                         else box_hi[:, g] <= t_a + 1)
                    if cat:
                        lo_v = torch.minimum(lout, rout)
                        hi_v = torch.maximum(lout, rout)
                    else:
                        # which child output bounds a leaf: it keeps a side
                        # unless its own range on the split feature moved
                        # past the new threshold relative to the subtree's
                        # extrema
                        alo = torch.where(opp, sf_lo, big).min()
                        ahi = torch.where(opp, sf_hi, -big).max()
                        use_l = (sf_lo <= thr) | (sf_lo == alo)
                        use_r = (sf_hi > thr + 1) | (sf_hi == ahi)
                        both = use_l & use_r
                        lo_v = torch.where(both, torch.minimum(lout, rout),
                                           torch.where(use_r, rout, lout))
                        hi_v = torch.where(both, torch.maximum(lout, rout),
                                           torch.where(use_r, rout, lout))
                    cand = opp & splittable
                    if keep is not None:
                        cand &= keep
                    if (not child_left) if m_g > 0 else child_left:
                        cur = leaf_f[:, LF_MAX]
                        new = torch.where(cand, torch.minimum(cur, lo_v), cur)
                        stale |= new < cur
                        leaf_f[:, LF_MAX] = new
                    else:
                        cur = leaf_f[:, LF_MIN]
                        new = torch.where(cand, torch.maximum(cur, hi_v), cur)
                        stale |= new > cur
                        leaf_f[:, LF_MIN] = new
                    marked = True
                # the crossing prunes, for higher ancestors, the leaves past
                # this threshold in the crossing's direction
                crossed.add((g, child_left))
                kp = (box_lo[:, g] <= t_a if child_left
                      else box_hi[:, g] > t_a + 1)
                keep = kp if keep is None else keep & kp
            a, child_left = parent, side
        return marked

    def _rescan(self, todo, leaf_f, leaf_i, leaf_bits, hist, scan, depths,
                xkeys, bkeys, paths) -> None:
        """Re-scan the stale leaves ``todo`` against their new bounds, in
        one batched scan: the JAX program re-scans them one a trip, each
        trip reading and writing only its own leaf."""
        idx = self._upload(np.asarray(todo, dtype=np.int64))
        lfr = leaf_f[idx]
        bs = scan(hist[idx], lfr[:, :4], depths, xkeys, bkeys, paths,
                  lfr[:, LF_MIN], lfr[:, LF_MAX])
        leaf_f[idx, LF_GAIN:LF_MIN] = torch.stack(
            [bs.gain, bs.left_g, bs.left_h, bs.left_c, bs.left_output,
             bs.right_output], 1)
        leaf_i[idx, LI_FEAT:] = torch.stack(
            [bs.feature, bs.threshold, bs.default_left.long(),
             bs.is_categorical.long()], 1)
        leaf_bits[idx] = bs.cat_bitset

    def _renew_leaves(self, grad, hess, perm, leaf_f, leaf_i, node_f,
                      num_leaves: int, leaf_value) -> torch.Tensor:
        """``quant_train_renew_leaf`` (the JAX learner,
        fused_learner.py:1551-1565;
        reference: GradientDiscretizer::RenewIntGradTreeOutput): each live
        leaf's output refit from its full-precision grad/hess sums. Each
        leaf is summed over its contiguous slice of the final permutation,
        one torch reduction per leaf, so reruns on the card are
        bit-identical (a float ``index_add_`` there takes atomics in no
        fixed order). Costs one host read of the leaves' slices."""
        L = self.config.num_leaves
        spans = leaf_i[:num_leaves, [LI_BEGIN, LI_COUNT]].tolist()
        gh = torch.stack([grad, hess], dim=1)[perm.long()]      # [N, 2]
        sums = torch.zeros((L, 2), dtype=torch.float32, device=gh.device)
        sums[:num_leaves] = torch.stack(
            [gh[b:b + c].double().sum(dim=0) for b, c in spans]).float()
        NODES = max(L - 1, 1)
        parent_out = node_f[torch.clamp(leaf_i[:, LI_PARENT], 0, NODES - 1),
                            1]
        renewed = calculate_leaf_output(sums[:, 0], sums[:, 1], self.params,
                                        leaf_f[:, LF_C], parent_out)
        active = torch.arange(L, device=gh.device) < num_leaves
        return torch.where(active, renewed, leaf_value)

    # ------------------------------------------------------------------
    def materialize_batch(self, recs: List[DeviceTree]) -> List[Tree]:
        """Host Trees from many DeviceTrees with one transfer per field."""
        if not recs:
            return []
        fields = [k for k in DeviceTree._fields
                  if k not in ("row_leaf", "num_leaves", "max_depth")]
        host = {k: torch.stack([getattr(r, k) for r in recs]).cpu().numpy()
                for k in fields}
        return [self._tree_from_host({k: v[i] for k, v in host.items()},
                                     r.num_leaves)
                for i, r in enumerate(recs)]

    def materialize(self, rec: DeviceTree) -> Tree:
        return self.materialize_batch([rec])[0]

    def _tree_from_host(self, h, num_leaves: int) -> Tree:
        """The host Tree of one tree's fetched tables (the JAX package's
        ``_tree_from_host``, field for field)."""
        L = num_leaves
        tree = Tree(max_leaves=self.config.num_leaves)
        tree.num_leaves = max(L, 1)
        mt_codes = {"None": 0, "Zero": 1, "NaN": 2}
        for k in range(max(L - 1, 0)):
            fi = int(h["node_feature"][k])
            j = self.dataset.used_features[fi]
            mapper = self.dataset.mappers[j]
            thr_bin = int(h["node_threshold"][k])
            is_cat = bool(h["node_is_cat"][k])
            bits = np.asarray(h["node_cat_bits"][k]).astype(np.uint32)
            tree.split_feature.append(j)
            tree.split_feature_inner.append(fi)
            tree.threshold_bin.append(thr_bin)
            tree.threshold_real.append(mapper.bin_to_value(thr_bin))
            tree.default_left.append(bool(h["node_default_left"][k]))
            tree.missing_type.append(mt_codes[mapper.missing_type])
            tree.left_child.append(int(h["node_left"][k]))
            tree.right_child.append(int(h["node_right"][k]))
            tree.split_gain.append(float(h["node_gain"][k]))
            tree.is_categorical.append(is_cat)
            tree.cat_bitset.append(bits)
            tree.cat_bitset_real.append(
                self._cat_bitset_real(fi, bits) if is_cat
                else np.zeros(8, np.uint32))
            tree.internal_value.append(float(h["node_value"][k]))
            tree.internal_weight.append(float(h["node_weight"][k]))
            tree.internal_count.append(int(h["node_count"][k]))
        Lb = tree.max_leaves
        tree.leaf_value[:Lb] = h["leaf_value"][:Lb]
        tree.leaf_weight[:Lb] = h["leaf_weight"][:Lb]
        tree.leaf_count[:Lb] = h["leaf_count"][:Lb].astype(np.int64)
        tree.leaf_depth[:Lb] = h["leaf_depth"][:Lb]
        tree.leaf_parent[:Lb] = h["leaf_parent_node"][:Lb]
        return tree
