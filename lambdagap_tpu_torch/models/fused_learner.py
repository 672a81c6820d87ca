"""Device-resident leaf-wise tree learner.

The port of ``lambdagap_tpu/models/fused_learner.py``. The JAX learner
compiles one whole tree into one XLA program (a ``fori_loop`` over splits
with masked no-op steps and no host sync). PyTorch runs eagerly, so the
port keeps the algorithm and the device residency, not the loop form:

* The binned matrix (row-major ``[N, C]`` for the histogram kernel and a
  column-major copy for the partition), grad/hess, the leaf permutation,
  the per-leaf and per-node tables and the per-leaf histograms
  ``[L, C, B, 3]`` f32 all live on the device.
* Each split step reads back ONE record of at most 64 bytes — the chosen
  leaf, whether its stored best gain is > 0, its begin, count, split
  feature, depth and parent pointer — and the loop stops at the first step
  where no leaf can split. The masked JAX loop leaves its state unchanged
  from that step on, so the tree is the same. ``host_syncs`` counts the
  reads of the last tree.
* The split leaf is the first argmax of the stored best gains; the smaller
  child's histogram comes from the CUDA kernel (``ops/hist_cuda``), the
  larger child's is the parent's minus it; both children's best splits are
  scanned in one batched call; leaf and node ids are assigned as the JAX
  state updates assign them; ``row_leaf`` comes from the final
  permutation.
* The partition is a stable partition of the chosen leaf's slice in plain
  torch ops (left rows first, each side in slice order).

Options the JAX program has and this learner does not (quantized
gradients, bagging/GOSS masks, extra_trees, by-node sampling, forced splits,
monotone and interaction constraints, EFB bundles, the sorted layout,
streaming) are refused where the booster is built (``models/gbdt.py``).
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..config import Config
from ..data.bundling import build_bundle
from ..data.dataset import BinnedDataset
from ..ops.hist_cuda import hist_rows
from ..ops.histogram import subtract_histogram
from ..ops.partition import decision_go_left, split_partition
from ..ops.split import CAT_WORDS, K_MIN_SCORE, best_split, \
    calculate_leaf_output
from .learner import SerialTreeLearner
from .tree import Tree

# leaf_f columns
LF_G, LF_H, LF_C, LF_OUT, LF_GAIN, LF_LG, LF_LH, LF_LC, LF_LOUT, LF_ROUT = \
    range(10)
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


class _PhaseTimer:
    """Device-stream time of named phases within one tree, from CUDA events
    around each phase (launch gaps inside a phase count). Off unless
    ``FusedTreeLearner.time_phases`` is set; the CPU has no events."""

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


class FusedTreeLearner(SerialTreeLearner):
    """Leaf-wise learner whose state stays on the device."""

    def __init__(self, dataset: BinnedDataset, config: Config,
                 device: torch.device) -> None:
        super().__init__(dataset, config, device)
        if config.enable_bundle and build_bundle(
                dataset.binned, self.meta_host["num_bins"],
                self.meta_host["default_bins"],
                config.max_conflict_rate) is not None:
            raise NotImplementedError(
                "EFB formed a feature bundle on this dataset; training over "
                "bundled columns is not ported to lambdagap_tpu_torch yet "
                "(ROADMAP.md, port slice 3) — pass enable_bundle=false")
        self.x_rows = torch.from_numpy(
            np.ascontiguousarray(dataset.binned)).to(device)
        # column-major copy for the partition's feature-column reads (the
        # JAX package's x_cols); u16 widens to int32 (torch indexes no u16
        # everywhere)
        cols = self.x_rows.T.contiguous()
        self.x_cols = cols if cols.dtype == torch.uint8 else cols.int()
        self.host_syncs = 0
        self.hist_builds = 0
        self.time_phases = False
        self.phase_ms: Dict[str, float] = {}

    def resident_bytes(self) -> int:
        """Device bytes this learner keeps for the run (the binned matrix
        in both layouts; per-tree state is counted by the caller)."""
        return (self.x_rows.numel() * self.x_rows.element_size()
                + self.x_cols.numel() * self.x_cols.element_size())

    # ------------------------------------------------------------------
    def train_device(self, grad: torch.Tensor,
                     hess: torch.Tensor) -> DeviceTree:
        """Grow one tree on the device from f32 grad/hess [N]."""
        cfg = self.config
        dev = self.device
        N, F, B, L = self.num_data, self.num_features, self.B, cfg.num_leaves
        NODES = max(L - 1, 1)
        p = self.params
        meta = self.meta_host
        timer = _PhaseTimer(self.time_phases and dev.type == "cuda")
        fmask = self._feature_mask()
        grad = grad.contiguous()
        hess = hess.contiguous()
        scan_args = (self.num_bins_arr, self.default_bins_arr,
                     self.missing_types_arr, self.is_categorical_arr, fmask,
                     p, self.has_categorical, cfg.max_depth)

        perm = torch.arange(N, dtype=torch.int32, device=dev)
        hist = torch.zeros((L, F, B, 3), dtype=torch.float32, device=dev)
        with timer.phase("histogram"):
            hist[0] = hist_rows(self.x_rows, grad, hess, None, N, B)
        self.hist_builds = 1
        totals = hist[0, 0].sum(dim=0)
        root_out = calculate_leaf_output(totals[0], totals[1], p, totals[2],
                                         0.0)
        with timer.phase("split_scan"):
            b0 = best_split(hist[0], totals[0], totals[1], totals[2],
                            root_out, 0, *scan_args)

        leaf_f = torch.zeros((L, 10), dtype=torch.float32, device=dev)
        leaf_f[:, LF_GAIN] = K_MIN_SCORE
        leaf_f[0] = torch.stack([totals[0], totals[1], totals[2], root_out,
                                 b0.gain, b0.left_g, b0.left_h, b0.left_c,
                                 b0.left_output, b0.right_output])
        leaf_i = torch.zeros((L, 9), dtype=torch.int64, device=dev)
        leaf_i[:, LI_PARENT] = -1
        leaf_i[0, LI_COUNT] = N
        leaf_i[0, LI_FEAT:] = torch.stack([
            b0.feature, b0.threshold, b0.default_left.long(),
            b0.is_categorical.long()])
        leaf_bits = torch.zeros((L, CAT_WORDS), dtype=torch.int64,
                                device=dev)
        leaf_bits[0] = b0.cat_bitset
        node_f = torch.zeros((NODES, 4), dtype=torch.float32, device=dev)
        node_i = torch.zeros((NODES, 6), dtype=torch.int64, device=dev)
        node_i[:, 4:6] = ~0
        node_bits = torch.zeros((NODES, CAT_WORDS), dtype=torch.int64,
                                device=dev)

        rec_cols = torch.tensor([LI_BEGIN, LI_COUNT, LI_FEAT, LI_DEPTH,
                                 LI_PARENT, LI_IS_LEFT], device=dev)
        num_leaves = 1
        max_depth = 0
        syncs = 0
        for _ in range(NODES if L > 1 else 0):
            # -- the one host read of the step ---------------------------
            leaf_t = torch.argmax(leaf_f[:, LF_GAIN])
            li = leaf_i[leaf_t]
            rec = torch.cat([(leaf_f[leaf_t, LF_GAIN] > 0.0).long()[None],
                             leaf_t[None], li.index_select(0, rec_cols)])
            ok, leaf, begin, count, feat, depth, pnode, was_left = \
                rec.tolist()
            syncs += 1
            if not ok:
                break
            new_leaf = num_leaves
            nidx = new_leaf - 1
            lf = leaf_f[leaf].clone()

            # -- stable partition of the leaf's slice --------------------
            with timer.phase("partition"):
                rows = perm[begin:begin + count]
                cv = self.x_cols[feat][rows.long()]
                gl = decision_go_left(
                    cv, li[LI_THR], li[LI_DL] == 1,
                    int(meta["default_bins"][feat]),
                    int(meta["missing_types"][feat]),
                    int(meta["num_bins"][feat]),
                    bool(meta["is_categorical"][feat]), leaf_bits[leaf])
                left_count = split_partition(perm, begin, count, gl)
            right_count = count - left_count

            # -- node bookkeeping ----------------------------------------
            if pnode >= 0:
                node_i[pnode, 4 if was_left else 5] = nidx
            node_f[nidx] = torch.stack([lf[LF_GAIN], lf[LF_OUT], lf[LF_H],
                                        lf[LF_C]])
            node_i[nidx, :4] = li[LI_FEAT:]
            node_i[nidx, 4] = ~leaf
            node_i[nidx, 5] = ~new_leaf
            node_bits[nidx] = leaf_bits[leaf]

            # -- children histograms: smaller built, larger subtracted ---
            with timer.phase("histogram"):
                small_is_left = left_count <= right_count
                small_count = torch.where(small_is_left, left_count,
                                          right_count).to(torch.int32)
                off = torch.where(small_is_left, 0, left_count)
                pos = torch.clamp(torch.arange(count, device=dev) + off,
                                  max=count - 1)
                small_rows = perm[begin:begin + count][pos]
                hist_small = hist_rows(self.x_rows, grad, hess, small_rows,
                                       small_count.reshape(1), B)
                hist_large = subtract_histogram(hist[leaf], hist_small)
                hist_left = torch.where(small_is_left, hist_small,
                                        hist_large)
                hist_right = torch.where(small_is_left, hist_large,
                                         hist_small)
                hist[leaf] = hist_left
                hist[new_leaf] = hist_right
            self.hist_builds += 1

            # -- both children's best splits in one batched scan ---------
            lg, lh, lc = lf[LF_LG], lf[LF_LH], lf[LF_LC]
            sums = torch.stack([
                torch.stack([lg, lh, lc, lf[LF_LOUT]]),
                torch.stack([lf[LF_G] - lg, lf[LF_H] - lh, lf[LF_C] - lc,
                             lf[LF_ROUT]])])                  # [2, 4]
            with timer.phase("split_scan"):
                bs = best_split(torch.stack([hist_left, hist_right]),
                                sums[:, 0], sums[:, 1], sums[:, 2],
                                sums[:, 3], depth + 1, *scan_args)
            rows_f = torch.cat(
                [sums, torch.stack([bs.gain, bs.left_g, bs.left_h, bs.left_c,
                                    bs.left_output, bs.right_output], 1)], 1)
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
            for side, row in ((0, leaf), (1, new_leaf)):
                leaf_f[row] = rows_f[side]
                leaf_i[row] = rows_i[side]
                leaf_bits[row] = bs.cat_bitset[side]
            num_leaves += 1
            max_depth = max(max_depth, depth + 1)
        self.host_syncs = syncs
        self.phase_ms = timer.totals_ms()

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
