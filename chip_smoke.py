#!/usr/bin/env python3
"""Drive the PyTorch port's training, serving and predict paths on one
CUDA card and check them.

    python3 chip_smoke.py [--seed N] [--rows N]
                          [--only kernels|rank|objectives|predict|shap|options|serial|layout|registry|stream|api|linear]

Run from the root of a checkout. Phases, each fatal on failure:

1. the card (name and power limit, as nvidia-smi reports them) and the
   torch / CUDA / nvcc versions;
2. build every kernel of every path from ``lambdagap_tpu_torch/csrc/``
   (traverse.cu, hist.cu, hist_q.cu, treeshap.cu: one nvcc per source, all
   started together) into the git-ignored build dir, printing each kernel's
   registers, shared memory and spills; then the histogram kernels'
   atomics in SASS (``cuobjdump -sass``): every shared-memory add must be
   native, none a compare-and-swap loop;
3. build a HIGGS-width forest from ``--seed`` (binary, 28 features, 500
   trees of 255 leaves, thresholds on a 254-boundary grid per feature,
   NaN- and zero-missing nodes) and round-trip it through the port's text
   writer and parser;
4. the traversal kernel (K3) against its plain PyTorch version on the
   card, on that forest at 1, 8, 64, 601 and 4096 rows (NaN and zero rows
   mixed in), on a 70-category forest with hostile values and on two
   16,384-leaf trees: the node carries must be ``torch.equal``; the
   accumulation kernel against the plain leaf gather + forest-order loop
   on that forest and on a 3-class one, at 1, 97 and 4096 rows, early stop
   off and on: ``torch.equal``; the fused kernel (one launch: K3's walk,
   the leaf values, the accumulation) against its plain version and
   against K3 + A on every one of those forests and batches (the HIGGS and
   3-class forests also at 8, 64 and 601 rows, early stop off and on, row
   0 alone against row 0 in each batch): ``torch.equal``, its counters
   zero after every launch; then the three kernels' device times
   (CUDA events, median of 30, L2 warm and flushed) and bounds, the
   parent's two-launch dispatch (K3 + A) beside the fused kernel, and
   ``CompiledForest.predict``'s host wall, at 1, 64, 256, 1024 and 4096
   rows;
5. the serving path: ``Booster(model_str=...).as_server(raw_score=True)``
   on the card answers requests of 1..4096 rows from 4 threads, each
   answer ``array_equal`` to the port's scan oracle on the card; the launch
   counts are zeroed just before and read just after, and every compiled
   dispatch (a ``CompiledForest.predict`` call) made exactly one fused
   launch, with no launch of K3 or the accumulation alone (so in every
   served phase below);
T18. the multi-model registry on phase 3's forest as ``default``, a
   300-tree 3-class forest at HIGGS width, the 70-category forest (hostile
   rows) and a 200 x 63 regression forest at MSLR-WEB30K's 136 columns,
   each answer ``array_equal`` to its model's scan oracle on the card: (a)
   240 requests of 1-4096 rows from 4 threads, each to a named model, one
   fused launch per dispatch; (b) ``serve_hbm_budget_mb`` from the
   entries' own bytes so that any two fit, 8 round-robin requests:
   evictions and readmissions, generations kept, resident bytes within the
   budget (the members' artifacts admitted from (a), no second compile);
   (c) on (a)'s server, 6 swaps of default between the forest and its
   first 400 trees while 4 threads submit, each answer its generation's
   oracle, none failed; (d) the delta swap from the 400-tree base back to
   the forest (the frame's bytes beside the full text's), two stale deltas
   ``SwapFailed`` at an unchanged generation, then ``serve_swap_breaker=2``
   rejects the next swap (``SwapRejected``) and serving goes on; (e)
   ``serve_pack_models``: (a)'s burst through the fused kernel's packed
   mode, fused launches == packed dispatches and no per-model dispatch;
   the packed launch at 4,096 mixed rows ``torch.equal`` to its plain
   version, to a rerun and to each member's own launch on its rows, timed
   beside the sum of those solo launches, with its bound (the workspace
   left out, as in ``fused_bound``); then a swap of the packed default to
   its 400-tree base, after which the next mixed requests equal their
   generations' oracles (``--only registry`` runs phases 1-3 and T18);
T2. the f32 histogram kernel (K1) against its plain version on the card at
   seven shapes (the HIGGS root, a leaf read at an offset inside its
   parent's slice with junk around it, u16 bins with a ragged count, count
   0, the root with a bagging mask, a skewed root with 90% of the rows in
   one bin, extreme gradients from 1e-30 to 1e3 at a leaf one row past
   three blocks' row budget): every channel ``torch.equal`` (both sum the
   same fixed-point integers), a rerun ``torch.equal``; then the kernel's,
   the plain version's and ``index_add_``'s times and the bound at the
   root, the leaf, the skewed and the masked root;
T2q. the int8 histogram kernel (K2) against its plain version at six
   shapes (the masked HIGGS root, the leaf at an offset, u16 bins with a
   ragged count, count 0, a saturated root with every row in bin 0 at
   g_q = -127 and h_q = 127, the skewed root): ``torch.equal``, reruns
   ``torch.equal``; the same times at the root, the leaf and the skewed
   root;
T3. the training path: ``lgt.train`` on the card, binary, HIGGS width (28
   features, ``num_leaves=255``, ``max_bin=255``), ``--rows`` seeded
   synthetic rows (10,500,000, HIGGS's count, by default) plus a 500,000-row
   validation set, 5 rounds with ``early_stopping(5)``; the launch counts
   are zeroed just before and read just after, and the K1 launches must
   equal the leaf histograms the learner built; one more tree with CUDA
   events around its phases, and one under ``torch.profiler`` for K1's
   kernel-only device time summed over its launches;
T6. T3's configuration and Datasets with ``use_quantized_grad`` (4
   levels, stochastic rounding, ``quant_train_renew_leaf``) and bagging
   0.8/1, 4 rounds: the K2 launches equal the leaf histograms built, no K1 launch,
   the validation logloss falls; one tree's phases and K2's kernel-only
   time, the threefry draw's time, peak memory; the model served back
   against the scan oracle;
T4. the example shape (16,000 x 20, 63 leaves, 10 rounds, validation set,
   early stopping) trained on the card and on the CPU, f32, quantized (16
   levels, renew), GOSS and bagging 0.7/1: predictions on the training
   rows within rtol 1e-4 / atol 1e-5, ``best_iteration`` equal; the
   quantized validation AUC within 0.02 of the f32 one;
T5. the T3 model through ``model_to_string`` -> ``Booster(model_str=)`` ->
   ``as_server(raw_score=True)``: a burst, each answer ``array_equal`` to
   the scan oracle on the card, one fused launch per dispatch;
T7. EFB: 200,000 rows of 8 dense features and 4 groups of 6 mutually
   exclusive sparse columns (bundles form, fewer columns than features),
   f32 and quantized, 4 rounds, on the card and on the CPU at T4's bar, K1
   and K2 launched;
T8. ranking at MSLR-WEB30K width: seeded synthetic query sets of Fold 1's
   shape (18,919 queries, ~2.27M documents x 136 features, query lengths
   1..1,251 with one of exactly 1,251, relevance 0-4 skewed toward 0) plus
   2,000 validation queries; ``lgt.train`` with ``lambdarank`` (target
   ndcg, ``eval_at=[10]``, 255 leaves, 255 bins, ``min_data_in_leaf=50``),
   3 rounds with ``early_stopping(5)``, then 2 rounds of
   lambdagap-x-plus-plus and 2 of ``rank_xendcg`` with by-query bagging on
   the same Dataset; the counts zeroed just before each run and read just
   after (K1 launches == leaf histograms), every gradient finite, the
   validation NDCG@10 rising over the ndcg run; wall per round, the lambda
   pass's device time, lattice size and peak memory, K1's kernel-only
   time per tree;
T2 at 136 features: K1 against its plain version (``torch.equal``) on the
   T8 matrix with T8's lambdas at the root, at a T8 leaf read at an offset,
   and at the 1,251-document query with lambdas taken without
   ``lambdarank_norm``; times and bound at the root and the leaf;
T9. 200 queries x 25 documents x 20 features, 63 leaves, 6 rounds on the
   card and on the CPU: ndcg, lambdagap-s, lambdagap-x-plus-plus,
   rank_xendcg, positions with by-query bagging, predictions on the
   training rows within rtol 1e-4 / atol 1e-5;
T10. the T8 ranker served back (T5's checks);
T11. multiclass at UCI Covertype's width: seeded synthetic rows of its
   shape (``covtype_like``: 464,809 training and 116,203 validation rows,
   10 integer-valued continuous features in its ranges, 4 wilderness and 40
   soil one-hot columns that EFB bundles, 7 classes at its shares), 255
   leaves, 255 bins: T11a softmax (``num_class=7``) 2 rounds with
   ``early_stopping(5)`` and multi_logloss / multi_error / auc_mu on the
   validation set, T11b one-vs-all 2 rounds, T11c softmax on 4-level
   quantized gradients with bagging 0.8/1, 2 rounds, all on one pair of
   Datasets; counts zeroed just before each run and read just after (K1,
   or K2 for T11c, launches == the leaves of the trained trees, one
   histogram each; the other kernel unlaunched); per round, from a
   callback, the wall, the trees' host wall (the booster's ``tree_ms``),
   the gradient pass's device time and the metrics' host time (each a
   repeat at the round's end); multi_logloss falls and multi_error ends
   below the majority class's share;
T2 at T11's width: K1 against its plain version (``torch.equal``, rerun
   bit-identical) at the root of T11's bundled matrix with round 1's
   softmax gradients of one class; its times and bound; K2 against its
   plain version at T11c's shapes, the root and a leaf at an offset in
   its parent's slice, with round 1's bagged 4-level levels of class 0;
T11-serve. T11a's 7-class model served on the card, early stop off and on
   (a margin that stops some rows): each [rows, 7] answer ``array_equal``
   to the scan oracle, converted outputs its softmax at rtol 1e-6, one
   fused launch per dispatch;
T12. 16,000 x 20 with a 12-category column, 31 leaves, 2 rounds with a
   validation set and early stopping, on the card and on the CPU:
   multiclass, multiclassova, multiclass + GOSS, regression_l1 (also with
   bagging 0.7/1), huber, fair, poisson, quantile, mape, gamma, tweedie,
   cross_entropy and cross_entropy_lambda with trial counts in (0.2, 1];
   training-row predictions within rtol 1e-4 / atol 1e-5, best_iteration
   equal;
T13. regression at YearPredictionMSD's width (``msd_like``: 463,715 +
   51,630 rows x 90 features, integer years 1922-2011 skewed toward the
   2000s), 255 leaves, 2 rounds each of regression_l1 and quantile (the
   leaf-renew path: the renew pass's host ms per tree, the booster's
   ``renew_ms``) and huber; two leaves of each renewed run's last tree
   against numpy's percentile of their residuals at the scores before
   that tree; K1 against its plain version on the 90-feature matrix with
   round 1's L1 gradients, at the root and at a leaf at an offset;
T14. the predict API on phase 3's forest, phase 5's rows and T3's and
   T11a's boosters: ``predict_engine=tensor`` predicts the 20,000 rows and
   serves phase 5's 240 requests ``array_equal`` to the scan oracle (its
   4,096-row host wall beside the compiled engine's); ``pred_leaf`` under
   ``compiled`` on 4,096 rows, the counts zeroed just before and read just
   after: K3 alone launched once and nothing else, the ``[4096, 500]``
   leaves ``array_equal`` to the
   tensor and scan engines'; ``pred_contrib`` through ``Booster.predict``
   on the forest (4,096 rows), T3 (4,096 validation rows) and T11a (2,048
   rows x 7 classes), the count of kernel S zeroed just before and read
   just after, T3's and T11a's rows summing to their raw scores at rtol
   1e-5 / atol 1e-6 (per class); kernel S against its plain version on the
   forest at 1, 256 and 4,096 rows, rtol 1e-9 / atol 1e-12, reruns and
   row 0 bit-identical in every batch, its device time, the plain
   version's and the float64 operation bound, the CUDA launches a call
   makes, and the path build's host time, warp groups, packing efficiency
   and long paths (``--only shap`` runs phases 1-3 and these checks
   alone); refit of T3's model on its 500,000 validation rows:
   ``decay_rate=1.0`` leaves every leaf as it was, 0.9 every leaf finite;
T15. the tree options on T3's Datasets at HIGGS width, 2 rounds each
   (the counts zeroed just before each run and read just after): (a)
   extra_trees, (b) ``feature_fraction_bynode=0.5``, (c) monotone +1/-1
   on four features, basic, ``monotone_penalty=1``, (d) the same,
   intermediate, (e) four interaction groups of seven features, (f)
   ``feature_contri`` halving eight features, (g) a three-level forced
   tree from a temporary JSON, (h) 16-level quantized gradients, bagging
   0.7/1, (d) and (b) on K2: K1 (K2 for (h)) launches == the histograms
   built, validation logloss falls, predictions monotone along a 64-point
   sweep of each constrained feature on 1,000 rows, every root-to-leaf
   path inside one group, the first four nodes the JSON's features and
   bins, reruns of (a) and (h) bit-identical, the model served back ==
   the scan oracle; the round walls, host syncs per tree and one tree's
   device-stream phases (histogram, split scan, partition, the monotone
   propagation and re-scans as ``constraints``);
T15b. (a)-(h) at 16,000 x 20, 31 leaves, 8 rounds, on the card and on
   the CPU: training-row predictions within rtol 1e-4 / atol 1e-5,
   best_iteration equal; the non-finite guard on the card: a NaN label
   raises ``NonFiniteError`` under ``raise``, ``skip_tree`` keeps the
   finite round of a poisson run whose exp overflows (card == CPU),
   ``clip`` trains NaN labels to a finite model (``--only options`` runs
   phases 1-2, T3, T15 and T15b);
T16. the host-driven serial learner (``tpu_fused_learner=0``) on T3's
   Datasets at HIGGS width, 2 rounds of each of (s) no option, (c) CEGB
   (split penalty 0.1, a coupled cost on 8 features; its trees are
   stumps), (r) the same with a split penalty of 0.001, (l) lazy CEGB
   with bagging 0.8/1 and (v) advanced monotone on T15's four features,
   the counts zeroed just before each run and read just after: K1
   launches == the histograms built (the root's and each split's smaller
   child's, none after a tree's last split), validation logloss falls,
   (s)'s validation predictions within rtol 1e-4 / atol 1e-5 of T3's
   fused model at 2 rounds, (c) and (r) on fewer distinct features than
   (s) and none of the coupled 8, (r)'s trees more than 2 leaves and
   fewer than 255 while (s) splits on a coupled feature, (v) monotone
   along every sweep, reruns of (l) and (v) bit-identical,
   the served model == the scan oracle; per variant the round walls, the
   host syncs of a tree and one more tree's phases (its advanced bounds and
   re-scans as ``constraints``);
T16b. (s), (c), (r), (l), (v), 3-class softmax and regression_l1 on the
   serial learner at 16,000 x 20, 31 leaves, 8 rounds, on the card and
   on the CPU: training-row predictions within rtol 1e-4 / atol 1e-5,
   best_iteration equal, the card's leaves a tree (``--only serial`` runs phases 1-2, T3, T16 and
   T16b);
T17. tree_layout=sorted against gather (T3, T6 and T8 already train
   sorted: ``auto`` resolves to it at 2^20 rows and more, which those
   phases check): on T3's Datasets (a) f32 fused, (b) quantized 4 levels +
   bagging 0.7/1 (K2), (c) ``tpu_fused_learner=0``, 1 round each, and on
   T8's Dataset (d) lambdarank ndcg, 1 round, each under explicit gather
   and sorted: the model text byte-equal but for the ``[tree_layout: ...]``
   line, the histogram kernel's launches == the histograms built and,
   under sorted, every one a window launch (no row list); per variant and
   layout the median round wall and one more tree's ``layout_apply``,
   ``partition`` and ``histogram`` device-stream ms. K1 and K2 in window
   mode at T3's 41,176-row leaf (a right child at its offset in its
   parent's window of leaf-ordered copies, the next leaf's rows past it):
   ``torch.equal`` to their plain versions, to a rerun and to the same
   leaf gathered through the permutation; timed beside the gathered leaf,
   the plain version and ``index_add_`` over the contiguous window
   (``--only layout`` runs phases 1-2, T3, T8's data and T17);
T19. out of core: (a) T3's training set re-sharded into host
   shards of 2^20 rows; fused gather, fused sorted and serial, 1 round
   each, and GOSS (learning rate 1.0, so round 2 samples) with
   ``stream_goss_compact`` on and off, 2 rounds each, streamed
   (``data_residency`` auto over the ShardedBinnedDataset) and resident
   (the GOSS runs share one resident
   twin): each streamed model text byte-equal up to ``end of trees`` to
   its resident twin, every streamed histogram K1's accumulate mode (one
   finish a histogram, at least one window launch each) and no resident
   K1 launch, no device matrix; the rings' ``h2d_prefetch`` /
   ``chunk_wait`` totals, windows, bytes and host reads a tree; K1's
   accumulate mode over T3's root in 11 windows ``torch.equal`` to its
   plain version and to one resident launch, timed beside both,
   ``index_add_`` and the root's bound; (b) ``predict_stream`` of T3's
   500,000 validation rows at 65,536 and 4,096-row windows and ring
   depths 1, 2 and 4 ``array_equal`` to ``Booster.predict`` (one fused
   launch a window), from an ``np.memmap`` into an ``np.memmap`` ``out``
   (converted), and from a ShardedBinnedDataset on T3's validation bins;
   rows/s and ``h2d_prefetch`` / ``chunk_wait`` / ``d2h_scores`` totals;
   (c) ``pred_contrib`` of 4,096 rows in windows of 1,024, one S call a
   window, ``array_equal`` to ``predict(pred_contrib=True)``
   (``--only stream`` runs phases 1-2, T3 and T19);
T20. the training API on T3's Datasets (no second binning), the K1 and K2
   counts zeroed just before each run and read just after: K1 launches ==
   the histograms built and no K2 launch, in every variant: (a)
   ``objective=none`` with a numpy binary-logloss fobj through
   ``Booster.update``, 2 rounds: the feval validation logloss falls and
   equals the built-in binary_logloss of the same scores at rtol 1e-6; (b)
   T3's model continued 2 rounds with ``init_model``: the replayed
   training and validation scores within rtol 1e-6 / atol 1e-6 of T3's
   own, 7 trees, validation logloss below T3's, a late ``add_valid``
   replaying to the same validation scores, the replay's wall; (c) DART
   (drop_rate 0.5, skip_drop 0) and (d) RF (bagging 0.5/1), 3 rounds
   each: ``predict(raw_score=True)`` on the validation rows == the
   booster's own validation scores at rtol 1e-5 / atol 1e-6, the served
   model == the scan oracle with one fused launch a dispatch; (e) ``cv``
   with nfold=3, 2 rounds, on T3's first 2^20 rows under
   ``free_raw_data=False``: the mean history == the mean of the
   CVBooster's folds' own evaluations, the folds' binning seconds; (f)
   ``reset_parameter(learning_rate=[0.1, 0.05])``, 2 rounds: the model
   text's shrinkage lines follow it; each variant's median round beside
   T3's;
T20b. fobj, init_model (5 + 5 rounds), DART, RF and reset_parameter at
   16,000 x 20, 31 leaves, 10 rounds, on the card and on the CPU:
   training-row predictions within rtol 1e-4 / atol 1e-5, best_iteration
   equal (``--only api`` runs phases 1-2, T3, T20 and T20b);
T21. piece-wise linear leaves (``linear_tree``, ``linear_lambda=1e-3``)
   at HIGGS width: T3's rows regenerated with NaN in column 0 every 13th
   row and column 2 every 29th, binned on T3's bins (``reference=``), the
   raw matrices kept; T3's parameters, the K1 and K2 counts zeroed just
   before each run and read just after (K1 launches == the histograms
   built, no K2): (a) the fused learner, 3 rounds: every tree linear, its
   coefficients finite, the validation logloss falling every round (beside
   T3's at the same rounds), a rerun's model text byte-equal, the linear
   fit's host wall a tree; (b) the serial learner, 3 rounds, and the
   moments of (a)'s first tree and row -> leaf map through the serial
   booster's fit ``torch.equal`` to (a)'s; (c) ``predict(raw_score=True)``
   on the validation rows == the booster's validation scores at rtol 1e-5
   / atol 1e-6, 240 served requests (NaN rows among them) ``array_equal``
   to the scan oracle with one fused launch a dispatch, and a packed
   server of (a)'s model and T3's constant one answering each model's
   oracle in one packed launch a bucket; (d) phase 3's forest with linear
   payloads (``synth.linearize``) through the fused kernel's linear mode
   at 1, 256 and 4,096 rows: ``torch.equal`` to its plain version and to
   a rerun, timed beside the constant mode on the same forest, with its
   bound and its plain version's time; (e) ``pred_contrib`` of 4,096
   validation rows summing to the raw scores at rtol 1e-5 / atol 1e-6,
   ``predict_stream`` from an ``np.memmap`` ``array_equal`` to
   ``predict``; (f) (a) continued one round with ``init_model``: the
   replayed training and validation scores within rtol 1e-6 / atol 1e-6
   of (a)'s, 4 trees;
T21b. linear regression and binary on the fused learner and linear
   regression on the serial learner at 16,000 x 20 with NaN cells, 31
   leaves, 10 rounds, on the card and on the CPU: training-row predictions
   within rtol 1e-4 / atol 1e-5, best_iteration equal (``--only linear``
   runs phases 1-2, T3, T21 and T21b);
6. the kernels line (one JSON object, thirteen entries; each entry's
   ``max_abs_err`` the largest of its kernel's comparisons, T13's K1 in
   ``hist_rows@covtype`` and T11c's K2 in ``hist_rows_q``; the fused
   kernel's launches phase 5's, its packed mode's
   (``predict_forest@packed``) T18 (e)'s burst's, K3's phase 5's and T14's
   pred_leaf, the accumulation's phase 5's, none; ``hist_rows@sorted`` and
   ``hist_rows_q@sorted`` the window launches of T17's sorted runs,
   ``hist_rows@stream`` the accumulate-mode launches of T19 (a)'s streamed
   runs, ``predict_forest@linear`` the fused launches of T21 (c)'s served
   burst, its times T21 (d)'s at 4,096 rows) and, last, the device line.

The card-vs-CPU phases (T4, T7, T9, T12, T15b, T16b, T20b, T21b) train
their CPU sides in ``CPU_WORKERS`` spawned worker processes beside the
card's runs; each phase stops its processes when it ends.

Needs one card; exits non-zero, printing no result, when there is none.
Imports nothing of JAX nor of the JAX package.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import statistics
import subprocess
import sys
import threading
import time
from typing import Optional

import numpy as np

F = 28              # HIGGS features
T = 500             # boosting rounds (binary: one tree each)
LEAVES = 255        # num_leaves
GRID = 254          # thresholds per feature: max_bin=255 binning
SIZES = (1, 7, 64, 512, 601, 4096)   # request rows, cycled
REQUESTS = 240
H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12      # f32 outside the tensor cores
# 32-bit integer adds outside the tensor cores: 64 INT32 lanes per SM, half
# the f32 lanes, and no fused multiply-add to count twice — a quarter of
# the f32 rate
H100_INT32_OPS_PER_S = H100_F32_OPS_PER_S / 4
# float64 outside the tensor cores (H100 SXM data sheet: 34 TFLOP/s; the
# FP64 tensor cores' 67 serve matrix products only)
H100_F64_OPS_PER_S = 34e12
SHAP_ROWS = 4096                # T14: kernel S's batch on the main path
SHAP_TIMED_ROWS = (1, 256, SHAP_ROWS)   # T14: S against plain, timed
HIGGS_ROWS = 10_500_000         # HIGGS's training rows (bench.py)
VALID_ROWS = 500_000
MAX_BIN = 255
ROUNDS = 5                      # T3 (cut from 10: the script's time)
QUANT_ROUNDS = 4                # T6 (cut from 10, from 6 for T20: the script's time)
EFB_ROUNDS = 4                  # T7 (cut from 10, from 6 for T20: the script's time)
MSLR_F = 136                    # MSLR-WEB30K features
MSLR_QUERIES = 18_919           # MSLR-WEB30K Fold 1's training queries
MSLR_VALID_QUERIES = 2_000
MSLR_MAX_DOCS = 1_251           # its longest query
RANK_ROUNDS = 3                 # T8 (cut from 10: the script's time)
RANK_CPU_ROUNDS = 6             # T9 (cut from 20, from 12 for T20: the script's time)
RANK_SHORT_ROUNDS = 2           # T8's x++ and xendcg runs (cut from 3 for T21)
LAYOUT_ROUNDS = 1               # T17 (a)-(c) (cut from 3 for T19, from 2 for T21)
STREAM_ROUNDS = 1               # T19 (a) (cut from 2 for T21)
STREAM_GOSS_ROUNDS = 2          # T19 (a)'s GOSS runs: round 2 samples
CARD_CPU_ROUNDS = 10            # T4 (cut from 30 for T19, from 20 for T20: the script's time)
OBJ_CPU_ROUNDS = 2              # T12 (cut from 10 for T19, from 6 for T20, from 3 for T21: the script's time)
STREAM_SHARD_ROWS = 1 << 20     # T19: host shards of 2^20 rows
STREAM_WINDOWS = (65_536, 4_096)   # T19 (b): predict_stream window rows
STREAM_DEPTHS = (1, 2, 4)       # T19 (b): ring depths
STREAM_CONTRIB_ROWS = 4096      # T19 (c)
LAYOUT_RANK_ROUNDS = 1          # T17 (d) (cut from 2 for T21)
API_CV_ROWS = 1 << 20           # T20 (e): cv on T3's first 2^20 rows
API_CPU_ROUNDS = 10             # T20b
LINEAR_ROUNDS = 3               # T21 (a)-(b)
LINEAR_CPU_ROUNDS = 10          # T21b
LINEAR_TIMED_ROWS = (1, 256, 4096)   # T21 (d): the linear mode timed
# UCI Covertype: 581,012 rows split 80/20, 54 features (10 continuous, 4
# wilderness and 40 soil one-hot columns), 7 cover types with these shares
COV_TRAIN, COV_VALID = 464_809, 116_203
COV_SHARES = (0.3646, 0.4876, 0.0615, 0.0047, 0.0163, 0.0299, 0.0353)
COV_ROUNDS = 2                  # T11a (cut from 6: the script's time)
COV_SHORT_ROUNDS = 2
# YearPredictionMSD: 463,715 training and 51,630 test rows, 90 features
MSD_TRAIN, MSD_VALID, MSD_F = 463_715, 51_630, 90
MSD_ROUNDS = 2                  # T13 (cut from 3 for T19)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# ---------------------------------------------------------------------------
# measurement helpers
# ---------------------------------------------------------------------------
def cuda_ms(fn, reps: int = 30, warm: int = 3) -> float:
    """Median device time of ``fn`` over ``reps`` runs: CUDA events around
    each run, all enqueued behind a device-side sleep long enough to cover
    the host's enqueueing, so the host's launch overhead never shows as
    device time (a run that synchronizes inside waits the sleep out and
    then counts its own host gaps)."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    # ~2 GHz SM clock: sleep for twice the enqueue time, at most 1 s
    torch.cuda._sleep(int(min(1.0, 2 * host_s * reps + 1e-3) * 2e9))
    for a, b in events:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


def wall_ms(fn, reps: int = 10, warm: int = 2) -> float:
    """Median host wall of ``fn`` ended by a device synchronize."""
    import torch
    for _ in range(warm):
        fn()
        torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def profiled_kernel_ms(run, names) -> tuple:
    """(device ms, launches) of the kernels whose names contain one of
    ``names``, summed over one call of ``run``, from torch.profiler's CUDA
    activity (CUPTI): the kernels' own time, no launch gaps."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    us, calls = 0.0, 0
    for e in prof.key_averages():
        if any(n in e.key for n in names):
            us += getattr(e, "device_time_total", 0.0)
            calls += e.count
    return us / 1e3, calls


def steps_taken(artifact, carry: np.ndarray) -> int:
    """Decision steps this carry needed: for each (row, group) the depth
    of the leaf it reached in the group's pruned structure."""
    b = artifact.buffers
    lo = np.asarray(b["block_node_lo"])
    glo = np.asarray(b["block_group_lo"])
    left, right = np.asarray(b["node_left"]), np.asarray(b["node_right"])
    root = np.asarray(b["root"])
    G = root.shape[0]
    L = int(np.asarray(b["leaf_value"]).shape[1])
    depth_of = np.zeros((G, L), np.int64)
    for blk in range(len(lo) - 1):
        for g in range(int(glo[blk]), int(glo[blk + 1])):
            stack = [(int(root[g]), 0)]
            while stack:
                n, d = stack.pop()
                if n < 0:
                    depth_of[g, ~n] = d
                    continue
                k = int(lo[blk]) + n
                stack.append((int(left[k]), d + 1))
                stack.append((int(right[k]), d + 1))
    leaf = ~carry.astype(np.int64)
    return int(depth_of[np.arange(G)[None, :], leaf].sum())


def kernel_bound(x, tables, out_shape, steps: int):
    import torch
    nbytes = x.numel() * 4 + out_shape[0] * out_shape[1] * 4
    nbytes += sum(int(a.nbytes) for a in tables
                  if isinstance(a, torch.Tensor))
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = steps / H100_F32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes)


def burst(server, data: np.ndarray, plan, clients: int = 4):
    """Submit every (offset, rows) request of ``plan`` from ``clients``
    threads at once; returns (answers in plan order, seconds)."""
    answers = [None] * len(plan)
    errors = []

    def client(tid: int) -> None:
        futs = [(i, server.submit(data[plan[i][0]:plan[i][0] + plan[i][1]]))
                for i in range(tid, len(plan), clients)]
        for i, f in futs:
            try:
                answers[i] = f.result(timeout=300).values
            except Exception as e:  # noqa: BLE001 — reported, fails below
                errors.append(f"request {i}: {e!r}")
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(k,))
               for k in range(clients)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(600)
    seconds = time.perf_counter() - t0
    check(not any(th.is_alive() for th in threads), "serve clients hung")
    check(not errors, "; ".join(errors[:3]))
    return answers, seconds


def check_answers(answers, plan, oracle) -> None:
    """Each answer ``array_equal`` to its rows of the oracle ([N] or
    [N, K])."""
    for i, (lo, n) in enumerate(plan):
        want = oracle[lo:lo + n]
        check(answers[i].shape == want.shape and
              np.array_equal(answers[i], want),
              f"request {i} ({n} rows) != scan oracle")


def higgs_like(seed: int, n: int, f: int = F):
    """Seeded synthetic rows of HIGGS's shape: ``f`` f32 features (some
    heavy-tailed and non-negative, like its momenta) and a binary label
    from a nonlinear score plus noise."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, f), dtype=np.float32)
    X[:, 5::4] = np.abs(X[:, 5::4]) ** 1.5
    z = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2] - 0.3 * X[:, 3] ** 2
         + 0.4 * np.sin(2.0 * X[:, 4]) + 0.2 * X[:, 5] - 0.2 * X[:, 9]
         + 0.7 * rng.standard_normal(n, dtype=np.float32))
    return X, (z > 0.0).astype(np.float32)


def fused_bound(x, tables, T: int, L: int, K: int, steps: int):
    """The fused kernel's bound: the rows, the artifact's node tables, the
    leaf table, the CSR of each group's trees, the tree classes and the
    scores, each once (not the carry nor the workspace, which stay on the
    chip's side of the bound); one f32 operation per decision step and per
    (row, tree) add."""
    import torch
    R = x.shape[0]
    G = int(tables.group_root.shape[0])
    nbytes = x.numel() * 4 + sum(int(a.nbytes) for a in
                                 tables.artifact_tables()
                                 if isinstance(a, torch.Tensor))
    nbytes += T * L * 4 + (G + 1) * 4 + T * 4 + T * 4 + K * R * 4
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = (steps + R * T) / H100_F32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes)


class Dispatches:
    """Within the block: counts the compiled engine's dispatches (calls of
    ``CompiledForest.predict``, from any thread) and zeroes the three
    launch counters on entry; reads them on exit (``fused``, ``k3``,
    ``acc``)."""

    def __enter__(self):
        from lambdagap_tpu_torch.infer import engine as eng
        self.eng, self.calls, self.lock = eng, 0, threading.Lock()
        self.orig = orig = eng.CompiledForest.predict

        def counted(cf, x):
            with self.lock:
                self.calls += 1
            return orig(cf, x)
        eng.CompiledForest.predict = counted
        for c in (eng.PREDICT_LAUNCHES, eng.TRAVERSE_LAUNCHES,
                  eng.ACCUMULATE_LAUNCHES):
            c.reset()
        return self

    def __exit__(self, *exc):
        eng = self.eng
        eng.CompiledForest.predict = self.orig
        self.fused = eng.PREDICT_LAUNCHES.launches
        self.k3 = eng.TRAVERSE_LAUNCHES.launches
        self.acc = eng.ACCUMULATE_LAUNCHES.launches
        return False

    def check(self, tag: str) -> None:
        """One fused launch per dispatch, and neither K3 alone (it serves
        pred_leaf only) nor the accumulation alone."""
        check(self.calls > 0 and self.fused == self.calls,
              f"{tag}: {self.fused} fused launches for {self.calls} "
              "compiled dispatches")
        check(self.k3 == 0, f"{tag}: {self.k3} K3-alone launches")
        check(self.acc == 0, f"{tag}: {self.acc} accumulation-alone "
              "launches on the serve path")

    def line(self) -> str:
        return (f"{self.calls} dispatches, {self.fused} fused launches, "
                f"K3 alone {self.k3}, accumulation alone {self.acc}")


def acc_bound(R: int, G: int, T: int, L: int, K: int):
    """The accumulation's bound: the carry read once, the leaf table and
    the two [T] maps read once, the scores written once; one add per (row,
    tree)."""
    nbytes = R * G * 4 + T * L * 4 + 2 * T * 4 + K * R * 4
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = R * T / H100_F32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes)


# ---------------------------------------------------------------------------
# 4: the serving kernels (K3, the accumulation) against their plain versions
# ---------------------------------------------------------------------------
def serve_kernels_phase(seed: int, rng, dev, smi: str, art, cf):
    """K3, the accumulation kernel and the fused kernel against their plain
    versions on the card, ``torch.equal``: the HIGGS-width forest, a
    70-category forest with hostile values, two 16,384-leaf trees, a
    3-class forest with early stop off and on. Then the kernels' device
    times (L2 warm and flushed) and bounds, K3 + A's two launches beside
    the fused kernel, and the dispatch's host wall at 1, 64, 256, 1,024
    and 4,096 rows. Returns K3's, A's and the fused kernel's numbers."""
    import torch
    import lambdagap_tpu_torch as lgt
    from lambdagap_tpu_torch.convert import booster_from_numpy
    from lambdagap_tpu_torch.infer import CompiledForest, compile_forest
    from lambdagap_tpu_torch.infer import engine as eng
    from lambdagap_tpu_torch.models import synth
    tables = cf.tables

    def forest(trees, feats, objective="binary sigmoid:1"):
        text = booster_from_numpy(synth.header(feats, objective), trees,
                                  {"device_type": "cpu"}).model_to_string()
        gb = lgt.Booster(model_str=text,
                         params={"device_type": "cpu"})._booster
        return CompiledForest(compile_forest(gb), dev)

    err = {"k3": 0, "acc": 0.0}   # largest |kernel - plain| of any check

    def against_plain(tag, x, t):
        ref = eng._traverse_all_reference(x, t)
        got = eng.traverse_forest(x, t)
        torch.cuda.synchronize()
        check(got.shape == ref.shape, f"K3 carry shape {got.shape}")
        if ref.numel():
            err["k3"] = max(err["k3"], int(
                (got.long() - ref.long()).abs().max()))
        check(torch.equal(got, ref),
              f"K3 != plain traversal on the {tag} forest at {x.shape[0]} "
              f"rows ({int((got != ref).sum())} entries differ)")
        check(bool((ref < 0).all()), f"non-leaf carry at {x.shape[0]} rows")
        return ref

    t0 = time.perf_counter()
    for n in (1, 8, 64, 601, 4096):
        against_plain("HIGGS", torch.from_numpy(
            synth.random_rows(rng, n, F)).to(dev), tables)
    print(f"K3 == plain at 1, 8, 64, 601, 4096 rows x "
          f"{tables.group_root.shape[0]} groups ({len(tables.depths)} node "
          f"blocks, {tables.rec.shape[0]} records)")
    cfeats = 6
    ccf = forest(synth.categorical_trees(seed + 1, num_features=cfeats),
                 cfeats)
    check(ccf.artifact.meta["cat_words"] >= 3,
          "70 categories need 3 bitset words")
    for n in (8, 601, 4096):
        against_plain("categorical", torch.from_numpy(
            synth.hostile_rows(rng, n, cfeats)).to(dev), ccf.tables)
    print("K3 == plain on the 70-category forest with hostile values")
    big = forest(synth.random_trees(seed + 2, 2, 16384, F), F)
    for n in (1, 64, 4096):
        against_plain("16,384-leaf", torch.from_numpy(
            synth.random_rows(rng, n, F)).to(dev), big.tables)
    print(f"K3 == plain on 2 trees of 16,384 leaves "
          f"({big.tables.group_node_lo.tolist()} records, "
          f"{big.tables.group_steps.tolist()} levels)")

    # the accumulation: 1 class (the HIGGS forest) and 3 (interleaved
    # trees), early stop off and on, carries from K3 (group-major view)
    cf3 = forest(synth.random_trees(seed + 3, 300, LEAVES, F, GRID), F,
                 "multiclass num_class:3")
    check(cf3.num_class == 3 and
          cf3._tree_class[:6].tolist() == [0, 1, 2, 0, 1, 2],
          "the 3-class forest interleaves its trees by class")
    for name, f in (("binary", cf), ("3-class", cf3)):
        K = f.num_class
        for n in (1, 97, 4096):
            x = torch.from_numpy(synth.random_rows(rng, n, F)).to(dev)
            carry = eng.traverse_forest(x, f.tables)
            vals = eng._leaf_values(carry, f._group_of_tree, f._leaf_value)
            outs = []
            for freq, margin in ((0, 0.0), (3 * K, 0.5)):
                ref = eng._accumulate(vals, f._tree_class.tolist(), K, freq,
                                      margin)
                got = eng.accumulate_forest(carry, f._group_of_tree,
                                            f._leaf_value, f._tree_class, K,
                                            freq, margin)
                torch.cuda.synchronize()
                check(got.shape == ref.shape, f"scores shape {got.shape}")
                err["acc"] = max(err["acc"],
                                 float((got - ref).abs().max()))
                check(torch.equal(got, ref),
                      f"accumulation kernel != plain on the {name} forest at "
                      f"{n} rows, early stop {freq} ({int((got != ref).sum())}"
                      " scores differ)")
                outs.append(got)
            stopped = int((outs[0] != outs[1]).any(0).sum())
            if n == 4096:
                check(stopped > 0, f"early stop never stopped a row of the "
                      f"{name} forest")
        print(f"accumulation == plain on the {name} forest ({K} class(es), "
              f"{f.num_trees} trees) at 1, 97, 4096 rows, early stop off and "
              f"on (freq {3 * K}, margin 0.5: {stopped} of 4096 rows "
              "stopped)")

    # the fused kernel: every forest and batch K3 and A were held on, early
    # stop off and on, against its plain version and against K3 + A
    err["fused"] = 0.0

    def fused_against_plain(tag, f, x, freq=0, margin=0.0):
        t = f.tables
        ref = eng._predict_forest_reference(
            x, t, t.group_tree_lo, t.group_tree, f._leaf_value,
            f._tree_class, f.num_class, freq, margin)
        got = eng.predict_forest(x, t, t.group_tree_lo, t.group_tree,
                                 f._leaf_value, f._tree_class, f.num_class,
                                 freq, margin)
        two = eng.accumulate_forest(eng.traverse_forest(x, t),
                                    f._group_of_tree, f._leaf_value,
                                    f._tree_class, f.num_class, freq, margin)
        torch.cuda.synchronize()
        check(got.shape == ref.shape, f"fused scores shape {got.shape}")
        if ref.numel():
            err["fused"] = max(err["fused"], float((got - ref).abs().max()))
        check(torch.equal(got, ref) and torch.equal(got, two),
              f"fused kernel != plain (or K3 + A) on the {tag} forest at "
              f"{x.shape[0]} rows, early stop {freq} "
              f"({int((got != ref).sum())} scores differ)")
        stream = torch.cuda.current_stream(dev).cuda_stream
        check(int(eng._counters[(dev.index, stream)].abs().sum()) == 0,
              "fused kernel left a counter nonzero")
        return got

    frng = np.random.RandomState(seed + 9)   # phase 5's rows stay as they were
    for name, f in (("HIGGS", cf), ("3-class", cf3)):
        K = f.num_class
        for n in (1, 8, 64, 97, 601, 4096):
            x = torch.from_numpy(synth.random_rows(frng, n, F)).to(dev)
            off = fused_against_plain(name, f, x)
            on = fused_against_plain(name, f, x, 3 * K, 0.5)
            if n == 4096:
                check(not torch.equal(off, on), f"early stop never stopped "
                      f"a row of the {name} forest (fused)")
            check(torch.equal(fused_against_plain(name, f, x[:1]),
                              off[:, :1]),
                  f"fused: row 0 alone != row 0 in {n} rows ({name})")
    for n in (8, 601, 4096):
        fused_against_plain("categorical", ccf, torch.from_numpy(
            synth.hostile_rows(frng, n, cfeats)).to(dev))
    for n in (1, 64, 4096):
        fused_against_plain("16,384-leaf", big, torch.from_numpy(
            synth.random_rows(frng, n, F)).to(dev))
    print(f"fused kernel == plain == K3 + A on the HIGGS and 3-class forests "
          f"at 1, 8, 64, 97, 601, 4096 rows (early stop off and on; row 0 "
          f"alone == row 0 in each batch), on the 70-category forest at 8, "
          f"601, 4096 and the 16,384-leaf trees at 1, 64, 4096; counters "
          f"zero after every launch")
    print(f"launches in the comparisons: K3 {eng.TRAVERSE_LAUNCHES.launches},"
          f" accumulation {eng.ACCUMULATE_LAUNCHES.launches}, fused "
          f"{eng.PREDICT_LAUNCHES.launches} (not counted below) "
          f"({time.perf_counter() - t0:.1f} s)")

    # times: K3, the accumulation, the dispatch
    x4k = torch.from_numpy(synth.random_rows(rng, 4096, F)).to(dev)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    fill_ms = cuda_ms(lambda: flush.fill_(1))

    def warm_cold(fn):
        def cold():
            flush.fill_(1)                # evict L2 (50 MB) first
            fn()
        return cuda_ms(fn), cuda_ms(cold) - fill_ms

    one = torch.zeros(1, device=dev)
    print(f"launch floor (one 1-element add, same timing): "
          f"{cuda_ms(lambda: one.add_(1)):.4f} ms [{smi}]")
    T, L = cf._leaf_value.shape
    G = int(tables.group_root.shape[0])
    k3, acc, fused = {}, {}, {}
    for n in (1, 64, 256, 1024, 4096):
        xn = x4k[:n].contiguous()
        carry = eng.traverse_forest(xn, tables)
        steps = steps_taken(art, carry.cpu().numpy())
        bound_ms, bound_by, nbytes = kernel_bound(
            xn, tables.artifact_tables(), carry.shape, steps)
        k_ms, k_cold = warm_cold(lambda: eng.traverse_forest(xn, tables))
        print(f"K3 @{n} rows x {G} groups: {k_ms:.4f} ms (L2 warm) "
              f"{k_cold:.4f} ms (L2 flushed); bound {bound_ms:.4f} ms "
              f"({bound_by}: {nbytes / 1e6:.2f} MB, {steps} decision steps) "
              f"[{smi}]")
        k3[n] = {"ms": k_ms, "cold_ms": k_cold, "bound_ms": bound_ms,
                 "bound_by": bound_by}
        a_ms, a_cold = warm_cold(lambda: eng._accumulate_forest(
            carry, cf._group_of_tree, cf._leaf_value, cf._tree_class, 1, 0,
            0.0))
        a_bound, a_by, a_bytes = acc_bound(n, G, T, L, 1)
        print(f"accumulation @{n} rows x {T} trees: {a_ms:.4f} ms (L2 warm)"
              f" {a_cold:.4f} ms (L2 flushed); bound {a_bound:.4f} ms "
              f"({a_by}: {a_bytes / 1e6:.2f} MB) [{smi}]")
        acc[n] = {"ms": a_ms, "cold_ms": a_cold, "bound_ms": a_bound,
                  "bound_by": a_by}
        # the fused kernel, and the parent's two launches in the same call
        f_ms, f_cold = warm_cold(lambda: cf.predict(xn))
        two_ms, two_cold = warm_cold(lambda: eng._accumulate_forest(
            eng.traverse_forest(xn, tables), cf._group_of_tree,
            cf._leaf_value, cf._tree_class, 1, 0, 0.0))
        f_bound, f_by, f_bytes = fused_bound(xn, tables, T, L, 1, steps)
        print(f"fused kernel @{n} rows x {G} groups x {T} trees: {f_ms:.4f} "
              f"ms (L2 warm) {f_cold:.4f} ms (L2 flushed); K3 + A, two "
              f"launches: {two_ms:.4f} / {two_cold:.4f} ms; bound "
              f"{f_bound:.4f} ms ({f_by}: {f_bytes / 1e6:.2f} MB, {steps} "
              f"steps + {n * T} adds) [{smi}]")
        fused[n] = {"ms": f_ms, "cold_ms": f_cold, "bound_ms": f_bound,
                    "bound_by": f_by, "two_launch_ms": two_ms}
        print(f"CompiledForest.predict @{n} rows: "
              f"{wall_ms(lambda: cf.predict(xn)):.3f} ms (host wall incl. "
              f"sync; one launch) [{smi}]")
    carry = eng.traverse_forest(x4k, tables)
    k3[4096]["plain_ms"] = cuda_ms(
        lambda: eng._traverse_all_reference(x4k, tables), reps=20)
    tc = cf._tree_class.tolist()

    def plain_acc(c):
        return eng._accumulate(
            eng._leaf_values(c, cf._group_of_tree, cf._leaf_value), tc, 1, 0,
            0.0)
    acc[4096]["plain_ms"] = cuda_ms(lambda: plain_acc(carry), reps=10)
    loop_ms = wall_ms(lambda: plain_acc(carry))
    loop1_ms = wall_ms(lambda: plain_acc(carry[:1]))
    print(f"plain versions @4096 rows: traversal {k3[4096]['plain_ms']:.3f} "
          f"ms, gather + forest-order loop {acc[4096]['plain_ms']:.3f} ms "
          f"(device); the loop's host wall {loop_ms:.3f} ms @4096 rows, "
          f"{loop1_ms:.3f} ms @1 row (incl. sync) [{smi}]")
    t = cf.tables
    fused[4096]["plain_ms"] = cuda_ms(
        lambda: eng._predict_forest_reference(
            x4k, t, t.group_tree_lo, t.group_tree, cf._leaf_value,
            cf._tree_class, 1, 0, 0.0), reps=10)
    print(f"fused kernel's plain version @4096 rows: "
          f"{fused[4096]['plain_ms']:.3f} ms (device) [{smi}]")
    k3[4096]["max_abs_err"] = err["k3"]
    acc[4096]["max_abs_err"] = err["acc"]
    fused[4096]["max_abs_err"] = err["fused"]
    return k3, acc, fused


# ---------------------------------------------------------------------------
# T2: the histogram kernels against their plain versions
# ---------------------------------------------------------------------------
def hist_bound(bins, rows, count: int, num_bins: int, mask=None,
               chan_bytes: int = 8, int_ops: int = 5):
    """Least time for hist_rows (chan_bytes 8: f32 grad and hess; int_ops
    5: four 32-bit integer adds of the split fixed-point words and one
    count increment per (row, feature)) or hist_rows_q (2: int8 levels;
    2: two 32-bit adds of the packed words): each live row's bins and
    channels (and its row id when
    there is a row list, its mask byte when there is a mask) read once,
    the [F, B, 3] result written once; the integer adds at the card's
    32-bit integer rate outside the tensor cores. Bound by bytes at every
    shape here."""
    F_ = bins.shape[1]
    nbytes = (count * (F_ * bins.element_size() + chan_bytes
                       + (4 if rows is not None else 0)
                       + (1 if mask is not None else 0))
              + F_ * num_bins * 3 * 4)
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = count * F_ * int_ops / H100_INT32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes)


def index_add_call(bins, grad, hess, rows, count: int, num_bins: int,
                   mask=None, offset: int = 0):
    """One ``index_add_`` that computes the same histogram from the
    gathered [count * F, 3] channels — f32 for K1, int64 for K2's int8
    levels; a masked-out row's channels are zero (timed only; the port
    never calls it)."""
    import torch
    dev = bins.device
    r = (torch.arange(count, device=dev) if rows is None
         else rows[offset:offset + count].long())
    b = (bins.int() if bins.dtype == torch.uint16 else bins)[r].long()
    F_ = bins.shape[1]
    idx = (b + torch.arange(F_, device=dev) * num_bins).reshape(-1)
    dtype = torch.float32 if grad.dtype == torch.float32 else torch.int64
    live = (torch.ones(count, dtype=dtype, device=dev) if mask is None
            else mask[r].to(dtype))
    ch = torch.stack([grad[r].to(dtype) * live, hess[r].to(dtype) * live,
                      live], 1)
    vals = ch[:, None, :].expand(count, F_, 3).reshape(-1, 3).contiguous()
    out = torch.zeros((F_ * num_bins, 3), dtype=dtype, device=dev)
    return lambda: out.zero_().index_add_(0, idx, vals)


def hist_inputs(dev, gen):
    """The HIGGS-width bins and the shapes both histogram phases share:
    the root's bins, a skewed copy (90% of the rows in bin 0 of every
    feature), a leaf of N/255 rows at an offset inside its parent's slice
    with junk everywhere else in the slice (the kernel must never read
    through a position outside [offset, offset + count)), and u16 bins."""
    import torch
    N = HIGGS_ROWS
    bins = torch.randint(0, MAX_BIN, (N, F), generator=gen, device=dev,
                         dtype=torch.uint8)
    skewed = bins.clone()
    skewed[torch.rand(N, generator=gen, device=dev) < 0.9] = 0
    leaf = N // 255
    off = leaf + 3                      # the right child of a split
    parent = torch.randperm(N, generator=gen, device=dev)[:off + leaf].int()
    parent[:off] = 2 ** 31 - 1
    n16 = 100_003
    bins16 = torch.randint(0, 1024, (n16, 8), generator=gen, device=dev,
                           dtype=torch.int32).to(torch.uint16)
    rows16 = torch.randperm(n16, generator=gen, device=dev)[:90_000].int()
    return bins, skewed, leaf, off, parent, bins16, rows16


def one(dev, v: int):
    """A one-element int32 on the device: the launch reads it there."""
    import torch
    return torch.tensor([v], dtype=torch.int32, device=dev)


def time_hist(tag: str, name: str, kernel, plain, args, count: int,
              offset: int, smi: str, chan_bytes: int, int_ops: int):
    """The kernel's, the plain version's and index_add_'s times at one
    shape, and the bound; printed, returned as a dict."""
    import torch
    k_ms = cuda_ms(lambda: kernel(*args))
    p_ms = cuda_ms(lambda: plain(*args), reps=3, warm=1)
    bins, a1, a2, rows, _, nb, mask = args[:7]
    lib = index_add_call(bins, a1, a2, rows, count, nb, mask, offset)
    l_ms = cuda_ms(lib, reps=5, warm=1)
    del lib
    torch.cuda.empty_cache()
    bound, by, nbytes = hist_bound(bins, rows, count, nb, mask, chan_bytes,
                                   int_ops)
    print(f"{tag} [{name}]: kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms, "
          f"index_add_ {l_ms:.4f} ms, bound {bound:.4f} ms ({by}: "
          f"{nbytes / 1e6:.1f} MB); kernel {'beats' if k_ms < l_ms else
          'loses to'} index_add_ ({l_ms / k_ms:.2f}x) [{smi}]")
    return {"ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
            "bound_ms": bound, "bound_by": by}


def hist_phase(dev, seed: int, smi: str) -> dict:
    """T2: K1 against its plain version at seven shapes, every channel
    ``torch.equal`` (the same fixed-point integers), reruns ``torch.equal``;
    times at the root, the leaf, the skewed root and the masked root."""
    import torch
    from lambdagap_tpu_torch.ops import hist_cuda as hc
    gen = torch.Generator(device=dev).manual_seed(seed)
    N = HIGGS_ROWS
    bins, skewed, leaf, off, parent, bins16, rows16 = hist_inputs(dev, gen)
    grad = torch.randn(N, generator=gen, device=dev)
    hess = torch.rand(N, generator=gen, device=dev) * 0.25
    bag = torch.rand(N, generator=gen, device=dev) < 0.8
    g16 = torch.randn(bins16.shape[0], generator=gen, device=dev)
    h16 = torch.rand(bins16.shape[0], generator=gen, device=dev)
    # extreme gradients: magnitudes 1e-30 to 1e3, both signs
    sign = torch.randint(0, 2, (N,), generator=gen, device=dev) * 2 - 1
    gx = 10.0 ** (torch.rand(N, generator=gen, device=dev) * 33 - 30) * sign
    hx = 10.0 ** (torch.rand(N, generator=gen, device=dev) * 33 - 30)
    budget = 3 * hc._MIN_BLOCK_ROWS + 1
    # the fixed-point exponents, once per gradient set (the learner: once
    # per tree), so a timed launch is the launch alone
    k, k16, kx = (hc.hist_scale(grad, hess), hc.hist_scale(g16, h16),
                  hc.hist_scale(gx, hx))

    cases = [
        ("a: HIGGS root, 28 u8 features, all rows",
         (bins, grad, hess, None, N, 256, None, None, k), N, 0),
        ("b: a leaf, N/255 rows at an offset in its parent's slice, junk "
         "around it", (bins, grad, hess, parent, one(dev, leaf), 256, None,
                       one(dev, off), k), leaf, off),
        ("c: u16 bins, 1024 bins x 8 features, ragged count",
         (bins16, g16, h16, rows16, 77_777, 1024, None, None, k16), 77_777,
         0),
        ("d: count = 0", (bins, grad, hess, parent, one(dev, 0), 256, None,
                          one(dev, off), k), 0, off),
        ("e: HIGGS root with a bagging mask (fraction 0.8)",
         (bins, grad, hess, None, N, 256, bag, None, k), int(bag.sum()), 0),
        ("f: skewed root, 90% of the rows in bin 0 of every feature",
         (skewed, grad, hess, None, N, 256, None, None, k), N, 0),
        (f"g: extreme gradients (1e-30 to 1e3), a leaf of {budget} rows "
         "(one past three blocks' row budget)",
         (bins, gx, hx, parent, one(dev, budget), 256, bag, one(dev, off),
          kx), budget, off),
    ]
    max_err = 0.0
    timed = {}
    for name, args, live, offset in cases:
        got = hc.hist_rows(*args)
        again = hc.hist_rows(*args)
        ref = hc._hist_reference(*args)
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"K1 rerun not bit-identical ({name})")
        check(torch.equal(got, ref),
              f"K1 != plain ({name}): {int((got != ref).sum())} entries "
              "differ")
        counted = int(got[..., 2].double().sum())
        check(name[0] == "g" or counted == live * args[0].shape[1],
              f"K1 counted rows wrongly ({name})")
        max_err = max(max_err, float((got - ref).abs().max()))
        print(f"K1 == plain [{name}]: torch.equal on every channel, rerun "
              "bit-identical")
        if name[0] in "abef":
            rows, mask = args[3], args[6]
            count = live if name[0] != "e" else N
            timed[name[0]] = time_hist("K1", name, hc.hist_rows,
                                       hc._hist_reference, args, count,
                                       offset, smi, 8, 5)
    print(f"K1 launches in the comparisons: {hc.HIST_LAUNCHES.launches} "
          "(not counted below)")
    del bins, skewed, grad, hess, parent, bag, gx, hx
    torch.cuda.empty_cache()
    return {**timed["a"], "max_abs_err": max_err, "leaf": timed["b"],
            "skewed": timed["f"], "masked": timed["e"]}


def hist_q_phase(dev, seed: int, smi: str) -> dict:
    """T2q: K2 against its plain version at six shapes, all torch.equal
    (integer sums), reruns torch.equal; times at the root, the leaf and the
    skewed root."""
    import torch
    from lambdagap_tpu_torch.ops import hist_cuda as hc
    gen = torch.Generator(device=dev).manual_seed(seed)
    N = HIGGS_ROWS
    bins, skewed, leaf, off, parent, bins16, rows16 = hist_inputs(dev, gen)
    # num_grad_quant_bins=4 levels: g in [-2, 2], h in [0, 4]
    gq = torch.randint(-2, 3, (N,), generator=gen, device=dev,
                       dtype=torch.int8)
    hq = torch.randint(0, 5, (N,), generator=gen, device=dev,
                       dtype=torch.int8)
    bag = torch.rand(N, generator=gen, device=dev) < 0.8
    n16 = bins16.shape[0]
    gq16 = torch.randint(-63, 64, (n16,), generator=gen, device=dev,
                         dtype=torch.int8)
    hq16 = torch.randint(0, 127, (n16,), generator=gen, device=dev,
                         dtype=torch.int8)
    bag16 = torch.rand(n16, generator=gen, device=dev) < 0.7
    # saturated: every row in bin 0 at the extreme levels, no mask, so each
    # block's packed fields reach their flush budget
    zeros = torch.zeros_like(bins)
    g_sat = torch.full((N,), -127, dtype=torch.int8, device=dev)
    h_sat = torch.full((N,), 127, dtype=torch.int8, device=dev)

    cases = [
        ("a: HIGGS root, 28 u8 features, bagging mask 0.8",
         (bins, gq, hq, None, N, 256, bag), None, N, 0),
        ("b: a leaf, N/255 rows at an offset in its parent's slice, junk "
         "around it", (bins, gq, hq, parent, one(dev, leaf), 256, bag,
                       one(dev, off)), None, leaf, off),
        ("c: u16 bins, 1024 bins x 8 features, ragged count, mask 0.7",
         (bins16, gq16, hq16, rows16, 77_777, 1024, bag16), None, 77_777, 0),
        ("d: count = 0", (bins, gq, hq, parent, one(dev, 0), 256, bag,
                          one(dev, off)), None, 0, off),
        ("e: saturated, every row in bin 0 with g_q = -127, h_q = 127",
         (zeros, g_sat, h_sat, None, N, 256, None), None, N, 0),
        ("f: skewed root, 90% of the rows in bin 0, mask 0.8",
         (skewed, gq, hq, None, N, 256, bag), None, N, 0),
    ]
    max_err = 0
    for name, args, _, count, offset in cases:
        got = hc.hist_rows_q(*args)
        again = hc.hist_rows_q(*args)
        ref = hc._hist_q_reference(*args)
        torch.cuda.synchronize()
        max_err = max(max_err, int((got.long() - ref.long()).abs().max()))
        check(got.dtype == torch.int32 and torch.equal(got, ref),
              f"K2 != plain ({name}): "
              f"{int((got != ref).sum())} entries differ")
        check(torch.equal(got, again), f"K2 rerun not bit-identical ({name})")
        rows, mask = args[3], args[6]
        r = (torch.arange(count, device=dev) if rows is None
             else rows[offset:offset + count].long())
        live = count if mask is None else int(mask[r].sum())
        check(int(got[..., 2].long().sum()) == live * args[0].shape[1],
              f"K2 counted rows wrongly ({name})")
        if name[0] == "e":
            check(int(got[0, 0, 0]) == -127 * N and
                  int(got[0, 0, 1]) == 127 * N,
                  f"K2 saturated sums {got[0, 0].tolist()}")
        print(f"K2 == plain [{name}]: torch.equal, rerun bit-identical, "
              f"{live} in-bag rows")
    timed = {}
    for key in "abf":
        name, args, _, count, offset = cases["abcdef".index(key)]
        timed[key] = time_hist("K2", name, hc.hist_rows_q,
                               hc._hist_q_reference, args, count, offset,
                               smi, 2, 2)
    print(f"K2 launches in the comparisons: {hc.HIST_Q_LAUNCHES.launches} "
          "(not counted below)")
    del bins, skewed, gq, hq, parent, bag, zeros, g_sat, h_sat
    torch.cuda.empty_cache()
    return {**timed["a"], "max_abs_err": max_err, "leaf": timed["b"],
            "skewed": timed["f"]}


def sass_phase() -> None:
    """The histogram kernels' atomics as compiled: every shared-memory add
    native (ATOMS.ADD / ATOMS.POPC.INC), none a compare-and-swap loop; the
    64-bit adds into K1's workspace global reductions (REDG...ADD.64)."""
    from lambdagap_tpu_torch.ops import hist_cuda
    from lambdagap_tpu_torch.utils import cuda_build
    for source in (hist_cuda.HIST_SOURCE, hist_cuda.HIST_Q_SOURCE):
        ops = cuda_build.sass_atomics(source)
        print(f"SASS atomics of {source}: "
              + ", ".join(f"{k} x{v}" for k, v in sorted(ops.items())))
        check(not any("CAS" in k for k in ops),
              f"{source}: an atomic compiled to a compare-and-swap loop")
        check(any(k.startswith("ATOMS.ADD") for k in ops),
              f"{source}: no native shared-memory add")


# ---------------------------------------------------------------------------
# T3-T5: training on the card, card against CPU, serving what was trained
# ---------------------------------------------------------------------------
def train_phase(args, smi: str):
    import torch
    import lambdagap_tpu_torch as lgt
    from lambdagap_tpu_torch.infer import TRAVERSE_LAUNCHES
    from lambdagap_tpu_torch.ops.hist_cuda import (HIST_LAUNCHES,
                                                   HIST_Q_LAUNCHES)
    t0 = time.perf_counter()
    Xtr, ytr = higgs_like(args.seed + 100, args.rows)
    Xva, yva = higgs_like(args.seed + 101, VALID_ROWS)
    gen_s = time.perf_counter() - t0
    params = {"objective": "binary", "metric": ["auc", "binary_logloss"],
              "num_leaves": LEAVES, "max_bin": MAX_BIN, "learning_rate": 0.1,
              "verbose": -1}
    cfg = lgt.Config.from_params(params)
    t0 = time.perf_counter()
    tr = lgt.Dataset(Xtr, label=ytr)
    va = lgt.Dataset(Xva, label=yva, reference=tr)
    tr.construct(cfg)
    va.construct(cfg)
    build_s = time.perf_counter() - t0
    # T20 (e) cross-validates the first 2^20 raw rows
    head = (Xtr[:API_CV_ROWS].copy(), ytr[:API_CV_ROWS].copy())
    del Xtr
    print(f"T3 data: {args.rows} x {F} train + {VALID_ROWS} valid rows made "
          f"in {gen_s:.1f} s; Dataset construction (binning) {build_s:.1f} s")

    rounds = []

    def per_round(env) -> None:
        lr = env.model._booster.learner
        rounds.append((time.perf_counter(), lr.hist_builds, lr.host_syncs))

    ev = {}
    torch.cuda.reset_peak_memory_stats()
    HIST_LAUNCHES.reset()
    HIST_Q_LAUNCHES.reset()
    TRAVERSE_LAUNCHES.reset()
    t_train = time.perf_counter()
    bst = lgt.train(params, tr, ROUNDS, valid_sets=[va],
                    callbacks=[per_round, lgt.early_stopping(5, verbose=False),
                               lgt.record_evaluation(ev)])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t_train
    launches = HIST_LAUNCHES.launches
    gb = bst._booster
    check(gb.learner.x_rows.device.type == "cuda"
          and gb.scores.device.type == "cuda", "learner tensors not on cuda")
    built = sum(r[1] for r in rounds)
    check(launches > 0, "the training path never launched the K1 kernel")
    check(HIST_Q_LAUNCHES.launches == 0, "the f32 path launched K2")
    check(launches == built, f"K1 launches {launches} != leaf histograms "
          f"built {built}")
    want = "sorted" if args.rows >= 1 << 20 else "gather"
    check(gb.learner.layout == want, f"T3: tree_layout=auto resolved to "
          f"{gb.learner.layout} at {args.rows} rows, not {want}")
    ll = ev["valid_0"]["binary_logloss"]
    auc = ev["valid_0"]["auc"]
    check(ll[-1] < ll[0], f"valid logloss did not fall: {ll[0]} -> {ll[-1]}")
    check(np.isfinite(auc[-1]) and auc[-1] > 0.5, f"valid AUC {auc[-1]}")
    walls = np.diff([t_train] + [r[0] for r in rounds]) * 1e3
    peak = torch.cuda.max_memory_allocated()
    resident = torch.cuda.memory_allocated()
    print(f"T3 train: {len(rounds)} rounds in {train_s:.2f} s; wall per "
          f"round (ms, incl. eval) {', '.join(f'{w:.0f}' for w in walls)}; "
          f"median {statistics.median(walls):.1f} ms, median of rounds 2.. "
          f"{statistics.median(walls[1:]):.1f} ms [{smi}]")
    print(f"T3 trees: leaf histograms {[r[1] for r in rounds]}, host syncs "
          f"per tree {[r[2] for r in rounds]}; K1 launches {launches} == "
          f"histograms built; valid logloss {ll[0]:.5f} -> {ll[-1]:.5f}, AUC "
          f"{auc[0]:.5f} -> {auc[-1]:.5f}")
    print(f"T3 device memory: {resident / 1e9:.3f} GB allocated after "
          f"training (binned matrix {gb.learner.resident_bytes() / 1e9:.3f} "
          f"GB of it), peak {peak / 1e9:.3f} GB [{smi}]")
    # one more tree with CUDA events around its phases (after the counts
    # were read; the main path's launches are above)
    lr = gb.learner
    lr.time_phases = True
    grad, hess = gb.boosting()
    t1 = time.perf_counter()
    lr.train_device(grad[0], hess[0])
    torch.cuda.synchronize()
    tree_ms = (time.perf_counter() - t1) * 1e3
    lr.time_phases = False
    ph = lr.phase_ms
    print(f"T3 one tree (tree_layout={lr.layout}): {tree_ms:.1f} ms host "
          f"wall; device-stream time between CUDA events: layout_apply "
          f"{ph.get('layout_apply', 0):.1f} ms, histogram "
          f"{ph.get('histogram', 0):.1f} ms, split scan "
          f"{ph.get('split_scan', 0):.1f} ms, partition "
          f"{ph.get('partition', 0):.1f} ms; {lr.host_syncs} host syncs "
          f"[{smi}]")
    k_ms, k_calls = profiled_kernel_ms(
        lambda: lr.train_device(grad[0], hess[0]),
        ("hist_kernel", "hist_finish_kernel"))
    print(f"T3 K1 kernel-only device time per tree: {k_ms:.3f} ms over "
          f"{k_calls} kernel launches ({lr.hist_builds} histograms, each the "
          f"main kernel and its f32 pass; torch.profiler), "
          f"{100 * k_ms / tree_ms:.1f}% of the tree's host wall [{smi}]")
    return {"bst": bst, "Xva": Xva, "launches": launches,
            "train": tr, "valid": va, "params": params, "auc": auc[-1],
            "logloss": ll[-1], "ll": ll, "median_ms": statistics.median(walls),
            "head": head}


def quant_phase(t3: dict, smi: str):
    """T6: T3's configuration with quantized gradients (K2) and bagging, on
    T3's constructed Datasets; the launch counts zeroed just before the
    run and read just after."""
    import torch
    import lambdagap_tpu_torch as lgt
    from lambdagap_tpu_torch.ops import hist_cuda as hc
    from lambdagap_tpu_torch.utils import prng
    params = {**t3["params"], "use_quantized_grad": True,
              "num_grad_quant_bins": 4, "stochastic_rounding": True,
              "quant_train_renew_leaf": True, "bagging_fraction": 0.8,
              "bagging_freq": 1}
    rounds = []

    def per_round(env) -> None:
        lr = env.model._booster.learner
        rounds.append((time.perf_counter(), lr.hist_builds, lr.host_syncs))

    ev = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hc.HIST_LAUNCHES.reset()
    hc.HIST_Q_LAUNCHES.reset()
    t_train = time.perf_counter()
    bst = lgt.train(params, t3["train"], QUANT_ROUNDS,
                    valid_sets=[t3["valid"]],
                    callbacks=[per_round, lgt.early_stopping(5, verbose=False),
                               lgt.record_evaluation(ev)])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t_train
    k2, k1 = hc.HIST_Q_LAUNCHES.launches, hc.HIST_LAUNCHES.launches
    gb = bst._booster
    built = sum(r[1] for r in rounds)
    check(gb.learner.quant and gb.scores.device.type == "cuda",
          "T6 did not train quantized on the card")
    check(k2 > 0 and k2 == built, f"K2 launches {k2} != leaf histograms "
          f"built {built}")
    check(k1 == 0, f"the quantized path launched K1 {k1} times")
    check(gb.learner.layout == t3["bst"]._booster.learner.layout,
          f"T6: tree_layout=auto resolved to {gb.learner.layout}, T3 to "
          f"{t3['bst']._booster.learner.layout} on the same Datasets")
    ll = ev["valid_0"]["binary_logloss"]
    auc = ev["valid_0"]["auc"]
    check(ll[-1] < ll[0], f"T6 valid logloss did not fall: {ll[0]} -> "
          f"{ll[-1]}")
    check(np.isfinite(auc[-1]) and auc[-1] > 0.5, f"T6 valid AUC {auc[-1]}")
    walls = np.diff([t_train] + [r[0] for r in rounds]) * 1e3
    peak = torch.cuda.max_memory_allocated()
    print(f"T6 train (quantized, 4 levels, stochastic rounding, renew, "
          f"bagging 0.8/1): {len(rounds)} rounds in {train_s:.2f} s; wall "
          f"per round (ms, incl. eval) {', '.join(f'{w:.0f}' for w in walls)}"
          f"; median {statistics.median(walls):.1f} ms, median of rounds "
          f"2.. {statistics.median(walls[1:]):.1f} ms [{smi}]")
    print(f"T6 trees: leaf histograms {[r[1] for r in rounds]}, host syncs "
          f"per tree {[r[2] for r in rounds]}; K2 launches {k2} == "
          f"histograms built, K1 launches {k1}; valid logloss {ll[0]:.5f} -> "
          f"{ll[-1]:.5f}, AUC {auc[0]:.5f} -> {auc[-1]:.5f} (T3 f32 "
          f"{t3['auc']:.5f}, gap {auc[-1] - t3['auc']:+.5f}); peak device "
          f"memory {peak / 1e9:.3f} GB [{smi}]")
    # one more tree with CUDA events around its phases (after the counts
    # were read; the main path's launches are above)
    lr = gb.learner
    lr.time_phases = True
    grad, hess = gb.boosting()
    grad, hess, mask = gb.sample_strategy.sample(gb.iter_, grad, hess)
    t1 = time.perf_counter()
    lr.train_device(grad[0], hess[0], mask)
    torch.cuda.synchronize()
    tree_ms = (time.perf_counter() - t1) * 1e3
    lr.time_phases = False
    ph = lr.phase_ms
    key = prng.PRNGKey(7)
    draw_ms = cuda_ms(lambda: prng.uniform(key, lr.num_data, grad.device),
                      reps=10, warm=1)
    print(f"T6 one tree (tree_layout={lr.layout}): {tree_ms:.1f} ms host "
          f"wall; device-stream time between CUDA events: quantize "
          f"{ph.get('quantize', 0):.1f} ms, layout_apply "
          f"{ph.get('layout_apply', 0):.1f} ms, "
          f"histogram {ph.get('histogram', 0):.1f} ms, split scan "
          f"{ph.get('split_scan', 0):.1f} ms, partition "
          f"{ph.get('partition', 0):.1f} ms, renew {ph.get('renew', 0):.1f} "
          f"ms; {lr.host_syncs} host syncs; one threefry draw of "
          f"{lr.num_data} uniforms {draw_ms:.2f} ms, two per tree "
          f"(stochastic rounding) and one per round (bagging) [{smi}]")
    k_ms, k_calls = profiled_kernel_ms(
        lambda: lr.train_device(grad[0], hess[0], mask), ("hist_q_kernel",))
    print(f"T6 K2 kernel-only device time per tree: {k_ms:.3f} ms over "
          f"{k_calls} launches ({lr.hist_builds} histograms; "
          f"torch.profiler), {100 * k_ms / tree_ms:.1f}% of the tree's host "
          f"wall [{smi}]")
    return bst, k2


CPU_WORKERS = 4     # the CPU sides' worker processes (8 cores: the card's
                    # runs keep the main process's core)


def _cpu_worker_init() -> None:
    import torch
    torch.set_num_threads(1)


def _cpu_train(params: dict, rounds: int, train_kw: dict,
               valid_kw: Optional[dict], metric: Optional[str]) -> dict:
    """One CPU training, in a worker process: ``lgt.Dataset(**train_kw)``
    (with a validation set ``valid_kw`` and early stopping when given)
    trained with ``device_type=cpu``. Returns its predictions on the
    training rows (converted and raw), best_iteration, the validation
    ``metric`` and its seconds."""
    import lambdagap_tpu_torch as lgt
    tr = lgt.Dataset(**train_kw)
    kw = {}
    if valid_kw is not None:
        kw = {"valid_sets": [lgt.Dataset(reference=tr, **valid_kw)],
              "callbacks": [lgt.early_stopping(5, verbose=False)]}
    t0 = time.perf_counter()
    bst = lgt.train({**params, "device_type": "cpu"}, tr, rounds, **kw)
    secs = time.perf_counter() - t0
    X = train_kw["data"]
    return {"pred": bst.predict(X), "raw": bst.predict(X, raw_score=True),
            "best": bst.best_iteration, "secs": secs,
            "score": (bst.best_score["valid_0"][metric] if valid_kw
                      and metric else None)}


class CpuSide:
    """The CPU side of a card-vs-CPU phase: ``CPU_WORKERS`` spawned worker
    processes (one torch thread each) train the phase's CPU runs while the
    main process trains the card's, one after another. Leaving the block
    shuts the pool down and stops its processes."""

    def __enter__(self) -> "CpuSide":
        import concurrent.futures
        import multiprocessing
        self.pool = concurrent.futures.ProcessPoolExecutor(
            CPU_WORKERS, mp_context=multiprocessing.get_context("spawn"),
            initializer=_cpu_worker_init)
        return self

    def submit(self, params: dict, rounds: int, train_kw: dict,
               valid_kw: Optional[dict] = None, metric: Optional[str] = None):
        return self.pool.submit(_cpu_train, params, rounds, train_kw,
                                valid_kw, metric)

    def __exit__(self, *exc) -> None:
        self.pool.shutdown(wait=True, cancel_futures=True)


def card_vs_cpu(cpu: CpuSide, params: dict, Xt, yt, Xv, yv, rounds: int,
                metric: str = "auc"):
    """The same run on the card and on the CPU: the CPU side is submitted
    to ``cpu`` now; the returned function trains the card's side, waits
    for the CPU's and compares them. It returns {device: (training-row
    predictions, best_iteration, validation ``metric`` (AUC), seconds,
    booster (the card's; None for the CPU))}."""
    import lambdagap_tpu_torch as lgt
    fut = cpu.submit(params, rounds, {"data": Xt, "label": yt},
                     {"data": Xv, "label": yv}, metric)

    def finish() -> dict:
        tr = lgt.Dataset(Xt, label=yt)
        va = lgt.Dataset(Xv, label=yv, reference=tr)
        t0 = time.perf_counter()
        bst = lgt.train(params, tr, rounds, valid_sets=[va],
                        callbacks=[lgt.early_stopping(5, verbose=False)])
        out = {"cuda": (bst.predict(Xt), bst.best_iteration,
                        bst.best_score["valid_0"][metric],
                        time.perf_counter() - t0, bst)}
        r = fut.result()
        out["cpu"] = (r["pred"], r["best"], r["score"], r["secs"], None)
        (pc, bc, _, _, _), (pp, bp, _, _, _) = out["cuda"], out["cpu"]
        # training rows: the card's histograms equal the CPU's (exact
        # sums), and a tie that one breaks across bins holding no training
        # row routes no training row differently
        check(np.allclose(pc, pp, rtol=1e-4, atol=1e-5),
              f"card != CPU predictions (max |diff| "
              f"{np.abs(pc - pp).max()}; {params})")
        check(bc == bp, f"best_iteration card {bc} != CPU {bp} ({params})")
        return out

    return finish


def card_vs_cpu_phase() -> None:
    """T4: the example shape, f32 / quantized / GOSS / bagging, each on the
    card and on the CPU."""
    rng = np.random.RandomState(0)
    X = rng.randn(20_000, 20)
    y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + 0.3 * rng.randn(20_000) > 0
         ).astype(np.float64)
    base = {"objective": "binary", "metric": ["auc", "binary_logloss"],
            "num_leaves": 63, "learning_rate": 0.1, "verbose": -1}
    variants = [
        ("f32", {}),
        ("quantized (16 levels, renew)", {
            "use_quantized_grad": True, "num_grad_quant_bins": 16,
            "quant_train_renew_leaf": True}),
        ("GOSS", {"data_sample_strategy": "goss"}),
        ("bagging 0.7/1", {"bagging_fraction": 0.7, "bagging_freq": 1}),
    ]
    aucs = {}
    with CpuSide() as cpu:
        runs = [(name, card_vs_cpu(cpu, {**base, **extra}, X[:16_000],
                                   y[:16_000], X[16_000:], y[16_000:],
                                   CARD_CPU_ROUNDS))
                for name, extra in variants]
        outs = [(name, finish()) for name, finish in runs]
    for name, out in outs:
        (pc, bc, ac, sc, _), (pp, _, _, sp, _) = out["cuda"], out["cpu"]
        aucs[name] = ac
        print(f"T4 card == CPU [{name}]: predictions max |diff| "
              f"{np.abs(pc - pp).max():.3g}, best_iteration {bc}, valid AUC "
              f"{ac:.5f}; train {sc:.1f} s on the card, {sp:.1f} s on the "
              "CPU")
    gap = aucs["quantized (16 levels, renew)"] - aucs["f32"]
    check(abs(gap) <= 0.02, f"quantized AUC {gap:+.4f} from f32's (> 0.02)")
    print(f"T4 quantized valid AUC within 0.02 of f32's ({gap:+.5f})")


def efb_phase(smi: str) -> None:
    """T7: a bundle-forming table (8 dense features + 4 groups of 6
    mutually exclusive sparse columns) trained f32 and quantized, on the
    card and on the CPU."""
    from lambdagap_tpu_torch.ops import hist_cuda as hc
    rng = np.random.RandomState(3)
    n = 200_000
    dense = rng.randn(n, 8)
    groups = []
    for _ in range(4):
        which = rng.randint(0, 7, n)          # 6: none of the group
        g = np.zeros((n, 6))
        on = which < 6
        g[np.nonzero(on)[0], which[on]] = rng.randint(1, 9, on.sum())
        groups.append(g)
    X = np.concatenate([dense] + groups, axis=1)
    score = (dense[:, 0] + 0.5 * dense[:, 1] * dense[:, 2]
             + sum(0.15 * g[:, k] * (k - 2.5) for g in groups
                   for k in range(6)) + 0.5 * rng.randn(n))
    y = (score > 0).astype(np.float64)
    base = {"objective": "binary", "metric": ["auc"], "num_leaves": 15,
            "learning_rate": 0.1, "verbose": -1}
    with CpuSide() as cpu:
        runs = [(name, card_vs_cpu(cpu, {**base, **extra}, X[:180_000],
                                   y[:180_000], X[180_000:], y[180_000:],
                                   EFB_ROUNDS))
                for name, extra in (("f32", {}), ("quantized", {
                    "use_quantized_grad": True, "num_grad_quant_bins": 16}))]
        for name, finish in runs:
            k1, k2 = hc.HIST_LAUNCHES.launches, hc.HIST_Q_LAUNCHES.launches
            out = finish()
            lr = out["cuda"][4]._booster.learner
            check(lr.bundle is not None, "T7: no EFB bundle formed")
            C, F_ = lr.x_rows.shape[1], lr.num_features
            check(C < F_, f"T7: {C} bundled columns for {F_} features")
            used = (hc.HIST_LAUNCHES.launches - k1 if name == "f32"
                    else hc.HIST_Q_LAUNCHES.launches - k2)
            check(used > 0, f"T7 [{name}] launched no histogram kernel")
            (pc, bc, ac, sc, _), (pp, _, _, sp, _) = out["cuda"], out["cpu"]
            print(f"T7 EFB [{name}]: {F_} features in {C} bundled columns; "
                  f"{'K1' if name == 'f32' else 'K2'} launches {used}; card "
                  f"== CPU predictions max |diff| "
                  f"{np.abs(pc - pp).max():.3g}, best_iteration {bc}, valid "
                  f"AUC {ac:.5f}; train {sc:.1f} s on the card, {sp:.1f} s "
                  f"on the CPU [{smi}]")


def serve_trained_phase(bst, Xva, dev, smi: str, tag: str = "T5") -> None:
    import lambdagap_tpu_torch as lgt
    import torch
    from lambdagap_tpu_torch.ops.predict import (forest_to_arrays,
                                                 predict_forest)
    text = bst.model_to_string()
    srv_bst = lgt.Booster(model_str=text)
    gb = srv_bst._booster
    data = np.ascontiguousarray(Xva[:20_000])
    plan = [((i * 977) % (len(data) - SIZES[i % len(SIZES)]),
             SIZES[i % len(SIZES)]) for i in range(REQUESTS)]
    with Dispatches() as d:
        with srv_bst.as_server(raw_score=True, workers=1) as server:
            answers, secs = burst(server, data, plan)
    d.check(f"{tag} serve path")
    forest, depth = forest_to_arrays(gb.models, device=dev)
    oracle = predict_forest(torch.from_numpy(data).to(dev), forest,
                            [0] * len(gb.models), 1, depth)[0].cpu().numpy()
    if gb.average_output:                   # RF: the mean of the trees
        oracle = oracle / np.float32(len(gb.models))
    check_answers(answers, plan, oracle)
    print(f"{tag} served the trained model ({len(gb.models)} trees, "
          f"{len(text) / 1e6:.2f} MB of text): {REQUESTS} requests in "
          f"{secs:.2f} s, each == scan oracle; {d.line()} [{smi}]")


# ---------------------------------------------------------------------------
# T8-T10: ranking at MSLR-WEB30K width, card against CPU, serving the ranker
# ---------------------------------------------------------------------------
def mslr_like(seed: int, n_train: int, n_valid: int):
    """Seeded query sets of MSLR-WEB30K Fold 1's shape: 136 f32 features,
    query lengths 1..1,251 (lognormal, mean ~120; exactly one training
    query of 1,251 documents), relevance 0-4 skewed toward 0 from one
    sparse latent over all queries (bench.py's MSLR-shaped synthetic).
    Returns (X, y, sizes) of the ``n_train`` training queries and of the
    ``n_valid`` validation queries after them."""
    rng = np.random.default_rng(seed)
    nq = n_train + n_valid
    sizes = np.clip(np.round(rng.lognormal(np.log(93.0), 0.72, nq)),
                    1, MSLR_MAX_DOCS - 1).astype(np.int64)
    sizes[int(rng.integers(n_train))] = MSLR_MAX_DOCS
    n = int(sizes.sum())
    X = rng.standard_normal((n, MSLR_F), dtype=np.float32)
    w = (rng.standard_normal(MSLR_F).astype(np.float32)
         * (rng.random(MSLR_F) < 0.2))
    latent = X @ w * 0.6 + rng.standard_normal(n, dtype=np.float32)
    y = np.clip(np.floor(latent - latent.mean() + 0.8), 0, 4).astype(
        np.float32)
    cut = int(sizes[:n_train].sum())
    return ((X[:cut], y[:cut], sizes[:n_train]),
            (X[cut:], y[cut:], sizes[n_train:]))


def mslr_data(args) -> dict:
    """T8's constructed MSLR-width Datasets (training and validation) and
    its parameters; the data lines printed."""
    import lambdagap_tpu_torch as lgt
    t0 = time.perf_counter()
    (Xtr, ytr, str_), (Xva, yva, sva) = mslr_like(
        args.seed + 200, MSLR_QUERIES, MSLR_VALID_QUERIES)
    gen_s = time.perf_counter() - t0
    params = {"objective": "lambdarank", "lambdarank_target": "ndcg",
              "metric": "ndcg", "eval_at": [10], "num_leaves": LEAVES,
              "max_bin": MAX_BIN, "learning_rate": 0.1,
              "min_data_in_leaf": 50, "verbose": -1}
    cfg = lgt.Config.from_params(params)
    t0 = time.perf_counter()
    tr = lgt.Dataset(Xtr, label=ytr, group=str_)
    va = lgt.Dataset(Xva, label=yva, group=sva, reference=tr)
    tr.construct(cfg)
    va.construct(cfg)
    build_s = time.perf_counter() - t0
    del Xtr
    shares = np.bincount(ytr.astype(int), minlength=5) / len(ytr)
    print(f"T8 data: {MSLR_QUERIES} queries, {int(str_.sum())} documents x "
          f"{MSLR_F} features (query lengths {int(str_.min())}..."
          f"{int(str_.max())}, mean {str_.mean():.1f}; relevance 0-4 shares "
          f"{np.round(shares, 3).tolist()}) + {MSLR_VALID_QUERIES} "
          f"validation queries ({int(sva.sum())} documents) made in {gen_s:.1f} s; Dataset construction "
          f"(binning) {build_s:.1f} s")
    print(f"T8 cuts: synthetic rows of MSLR-WEB30K Fold 1's shape (not the "
          f"data); {RANK_ROUNDS} / {RANK_SHORT_ROUNDS} / {RANK_SHORT_ROUNDS} "
          f"rounds (the reference trains 500); {MSLR_VALID_QUERIES} "
          "validation queries")
    return {"train": tr, "valid": va, "params": params, "cfg": cfg,
            "Xva": Xva}


def rank_train_phase(args, smi: str, data: dict) -> dict:
    """T8: lambdarank (target ndcg) at MSLR-WEB30K width, then 2 rounds of
    lambdagap-x-plus-plus and 2 of rank_xendcg with by-query bagging on the
    same constructed Dataset (``data``, :func:`mslr_data`); counts zeroed
    just before each run."""
    import torch
    import lambdagap_tpu_torch as lgt
    from lambdagap_tpu_torch.objectives import rank as prank
    from lambdagap_tpu_torch.ops.hist_cuda import (HIST_LAUNCHES,
                                                   HIST_Q_LAUNCHES)
    tr, va, params, cfg = (data[k] for k in ("train", "valid", "params",
                                             "cfg"))

    # every gradient the runs take is checked finite, on the device
    finite = []
    plain = prank.RankingBase.get_gradients_fast

    def checked(self, scores):
        g, h = plain(self, scores)
        finite.append(torch.isfinite(g).all() & torch.isfinite(h).all())
        return g, h

    out = {}
    prank.RankingBase.get_gradients_fast = checked
    try:
        for tag, extra, rounds in (
                ("ndcg", {}, RANK_ROUNDS),
                ("lambdagap-x-plus-plus", {
                    "lambdarank_target": "lambdagap-x-plus-plus",
                    "lambdagap_weight": 0.5}, RANK_SHORT_ROUNDS),
                ("rank_xendcg + by-query bagging 0.8/1", {
                    "objective": "rank_xendcg", "bagging_by_query": True,
                    "bagging_fraction": 0.8, "bagging_freq": 1},
                 RANK_SHORT_ROUNDS)):
            rounds_at = []

            def per_round(env) -> None:
                lr = env.model._booster.learner
                rounds_at.append((time.perf_counter(), lr.hist_builds))

            ev = {}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            HIST_LAUNCHES.reset()
            HIST_Q_LAUNCHES.reset()
            t_train = time.perf_counter()
            bst = lgt.train({**params, **extra}, tr, rounds, valid_sets=[va],
                            callbacks=[per_round,
                                       lgt.early_stopping(5, verbose=False),
                                       lgt.record_evaluation(ev)])
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t_train
            launches = HIST_LAUNCHES.launches
            gb = bst._booster
            built = sum(r[1] for r in rounds_at)
            check(gb.learner.x_rows.device.type == "cuda"
                  and gb.scores.device.type == "cuda",
                  f"T8 [{tag}] learner tensors not on cuda")
            check(launches > 0 and launches == built,
                  f"T8 [{tag}] K1 launches {launches} != leaf histograms "
                  f"built {built}")
            check(HIST_Q_LAUNCHES.launches == 0, f"T8 [{tag}] launched K2")
            check(gb.learner.layout == "sorted", f"T8 [{tag}]: "
                  f"tree_layout=auto resolved to {gb.learner.layout} at "
                  f"{gb.num_data} rows")
            check(bool(torch.stack(finite).all()),
                  f"T8 [{tag}] a gradient was not finite")
            finite.clear()
            check(bool(torch.isfinite(gb.scores).all()),
                  f"T8 [{tag}] non-finite training scores")
            nd = ev["valid_0"]["ndcg@10"]
            walls = np.diff([t_train] + [r[0] for r in rounds_at]) * 1e3
            peak = torch.cuda.max_memory_allocated()
            print(f"T8 train [{tag}]: {len(rounds_at)} rounds in "
                  f"{train_s:.2f} s; wall per round (ms, incl. eval) "
                  f"{', '.join(f'{w:.0f}' for w in walls)}; median of rounds "
                  f"2.. {statistics.median(walls[1:]):.1f} ms; K1 launches "
                  f"{launches} == histograms built; peak device memory "
                  f"{peak / 1e9:.3f} GB [{smi}]")
            print(f"T8 valid NDCG@10 by round [{tag}]: "
                  f"{[round(v, 5) for v in nd]}")
            out[tag] = {"bst": bst, "ndcg": nd, "launches": launches,
                        "walls": walls}
    finally:
        prank.RankingBase.get_gradients_fast = plain
    nd = out["ndcg"]["ndcg"]
    check(len(nd) >= 2 and nd[-1] > nd[0],
          f"T8 valid NDCG@10 did not rise: {nd[0]} -> {nd[-1]}")
    print(f"T8 valid NDCG@10 rose over the ndcg run: {nd[0]:.5f} -> "
          f"{nd[-1]:.5f}")

    # the lambda pass alone, at the final scores of each run: device time
    # (CUDA events), the lattice it forms, its own peak memory
    for tag, res in out.items():
        gb = res["bst"]._booster
        obj = gb.objective
        if obj.name == "rank_xendcg":
            key = obj.key          # a timing run must not move the sampler
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        g, h = obj.get_gradients_fast(gb.scores)
        torch.cuda.synchronize()
        lam_peak = torch.cuda.max_memory_allocated() - base
        del g, h
        g_ms = cuda_ms(lambda: obj.get_gradients_fast(gb.scores), reps=5,
                       warm=1)
        if obj.name == "rank_xendcg":
            obj.key = key
        dense = sum(len(q) * L * L for L, q, _ in obj.bucketing.buckets)
        print(f"T8 lambda pass [{tag}]: {g_ms:.2f} ms device time a round "
              f"(CUDA events); lattice {dense} pair entries a round (sum of "
              f"nq x L^2, bench.py's count), {obj.pair_entries} formed "
              f"({dense / (g_ms / 1e3) / 1e9:.2f} G pairs/s by bench.py's "
              f"count); {100 * g_ms / statistics.median(res['walls'][1:]):.1f}"
              f"% of a round's wall; its own peak {lam_peak / 1e9:.3f} GB "
              f"above {base / 1e9:.3f} GB resident; buckets "
              f"{[(L, len(q)) for L, q, _ in obj.bucketing.buckets]} [{smi}]")
        res["grad_ms"] = g_ms

    # one more tree of the ndcg run with events around its phases, one
    # under torch.profiler for K1's kernel-only time (after the counts were
    # read; the runs' launches are above)
    gb = out["ndcg"]["bst"]._booster
    lr = gb.learner
    grad, hess = gb.boosting()
    lr.time_phases = True
    t1 = time.perf_counter()
    rec = lr.train_device(grad[0], hess[0])
    torch.cuda.synchronize()
    tree_ms = (time.perf_counter() - t1) * 1e3
    lr.time_phases = False
    ph = lr.phase_ms
    t1 = time.perf_counter()
    gb.eval_valid()
    eval_ms = (time.perf_counter() - t1) * 1e3
    print(f"T8 one tree: {tree_ms:.1f} ms host wall; device-stream time "
          f"between CUDA events: histogram {ph.get('histogram', 0):.1f} ms, "
          f"split scan {ph.get('split_scan', 0):.1f} ms, partition "
          f"{ph.get('partition', 0):.1f} ms; {lr.host_syncs} host syncs; "
          f"lambda pass {out['ndcg']['grad_ms']:.1f} ms a round; validation "
          f"NDCG@10 (host numpy, {MSLR_VALID_QUERIES} queries) {eval_ms:.1f}"
          f" ms a round [{smi}]")
    k_ms, k_calls = profiled_kernel_ms(
        lambda: lr.train_device(grad[0], hess[0]),
        ("hist_kernel", "hist_finish_kernel"))
    print(f"T8 K1 kernel-only device time per tree at {MSLR_F} features: "
          f"{k_ms:.3f} ms over {k_calls} kernel launches ({lr.hist_builds} "
          f"histograms; torch.profiler), {100 * k_ms / tree_ms:.1f}% of the "
          f"tree's host wall [{smi}]")
    qb = tr.construct(cfg).metadata.query_boundaries
    q_long = int(np.argmax(np.diff(qb)))
    return {"out": out, "Xva": data["Xva"], "grad": grad[0],
            "hess": hess[0], "row_leaf": rec.row_leaf, "x_rows": lr.x_rows,
            "long_rows": (int(qb[q_long]), int(qb[q_long + 1])),
            "train": tr, "cfg": cfg, "params": params, "k1_tree_ms": k_ms,
            "k1_launches_tree": lr.hist_builds}


def hist_mslr_phase(dev, t8: dict, smi: str) -> dict:
    """T2 at 136 features: K1 against its plain version, ``torch.equal``,
    on the T8 matrix with the T8 ranker's gradients — at the root, at the
    largest leaf of one more T8 tree (read at an offset in a slice with
    junk around it), and at the 1,251-document query's rows with gradients
    taken without ``lambdarank_norm`` (the widest fixed-point range);
    times at the root and the leaf."""
    import torch
    from lambdagap_tpu_torch.objectives import rank as prank
    from lambdagap_tpu_torch.ops import hist_cuda as hc
    bins, grad, hess = t8["x_rows"], t8["grad"], t8["hess"]
    N = bins.shape[0]
    row_leaf = t8["row_leaf"]
    big = int(torch.bincount(row_leaf).argmax())
    leaf_rows = torch.nonzero(row_leaf == big).flatten().int()
    leaf = int(leaf_rows.numel())
    off = 5
    slice_ = torch.full((leaf + 2 * off,), 2 ** 31 - 1, dtype=torch.int32,
                        device=dev)
    slice_[off:off + leaf] = leaf_rows
    lo, hi = t8["long_rows"]
    # the same scores' gradients without lambdarank_norm
    cfg = t8["cfg"]
    cfg_nn = copy.copy(cfg)
    cfg_nn.lambdarank_norm = False
    obj = prank.LambdarankNDCG(cfg_nn)
    ds = t8["train"].construct(cfg)
    obj.init(ds.metadata, N, dev)
    gnn, hnn = obj.get_gradients_fast(
        t8["out"]["ndcg"]["bst"]._booster.scores)
    gnn, hnn = gnn[0].contiguous(), hnn[0].contiguous()
    long_rows = torch.arange(lo, hi, dtype=torch.int32, device=dev)
    k, knn = hc.hist_scale(grad, hess), hc.hist_scale(gnn, hnn)
    nb = 256
    cases = [
        ("a: T8 root, 136 u8 features, all rows", (bins, grad, hess, None, N,
                                                   nb, None, None, k), N, 0),
        (f"b: a T8 leaf of {leaf} rows at an offset in a slice, junk around",
         (bins, grad, hess, slice_, one(dev, leaf), nb, None, one(dev, off),
          k), leaf, off),
        (f"c: the {hi - lo}-document query, lambdas without "
         "lambdarank_norm", (bins, gnn, hnn, long_rows, hi - lo, nb, None,
                             None, knn), hi - lo, 0),
        ("d: T8 root, lambdas without lambdarank_norm",
         (bins, gnn, hnn, None, N, nb, None, None, knn), N, 0),
    ]
    max_err = 0.0
    timed = {}
    for name, cargs, live, offset in cases:
        got = hc.hist_rows(*cargs)
        again = hc.hist_rows(*cargs)
        ref = hc._hist_reference(*cargs)
        torch.cuda.synchronize()
        check(torch.equal(got, again),
              f"K1 rerun not bit-identical at 136 features ({name})")
        check(torch.equal(got, ref),
              f"K1 != plain at 136 features ({name}): "
              f"{int((got != ref).sum())} entries differ")
        check(int(got[..., 2].double().sum()) == live * bins.shape[1],
              f"K1 counted rows wrongly at 136 features ({name})")
        max_err = max(max_err, float((got - ref).abs().max()))
        print(f"K1 == plain at 136 features [{name}]: torch.equal on every "
              "channel, rerun bit-identical")
        if name[0] in "ab":
            timed[name[0]] = time_hist("K1@136", name, hc.hist_rows,
                                       hc._hist_reference, cargs, live,
                                       offset, smi, 8, 5)
    _, f_tile = hc._grid(hc.HIST_SOURCE, hc._kernel_lib(hc.HIST_SOURCE, dev),
                         dev, bins, N, nb)
    print(f"K1 grid at 136 features: feature tiles of {f_tile} at the root "
          f"({-(-bins.shape[1] // f_tile)} tiles)")
    check(f_tile < bins.shape[1], "K1 ran one feature tile at 136 features")
    del gnn, hnn, obj
    torch.cuda.empty_cache()
    return {**timed["a"], "max_abs_err": max_err, "leaf": timed["b"]}


def rank_card_vs_cpu_phase(smi: str) -> None:
    """T9: 200 queries x 25 documents x 20 features, 63 leaves, 6 rounds,
    trained on the card and on the CPU: ndcg, lambdagap-s,
    lambdagap-x-plus-plus, rank_xendcg, and positions with by-query
    bagging; predictions on the training rows within rtol 1e-4 / atol
    1e-5."""
    import lambdagap_tpu_torch as lgt
    rng = np.random.RandomState(4)
    nq, docs = 200, 25
    X = rng.randn(nq * docs, 20)
    util = 2.0 * X[:, 0] + X[:, 1] + 0.5 * rng.randn(nq * docs)
    y = np.zeros(nq * docs)
    for q in range(nq):
        u = util[q * docs:(q + 1) * docs]
        ranks = np.argsort(np.argsort(-u))
        y[q * docs:(q + 1) * docs] = np.select(
            [ranks < 2, ranks < 5, ranks < 10], [3, 2, 1], 0)
    group = np.full(nq, docs)
    pos = np.tile(np.arange(docs), nq)
    base = {"objective": "lambdarank", "num_leaves": 63, "verbose": -1,
            "learning_rate": 0.1}
    runs = (("ndcg", {}, None),
            ("lambdagap-s", {"lambdarank_target": "lambdagap-s"}, None),
            ("lambdagap-x-plus-plus", {
                "lambdarank_target": "lambdagap-x-plus-plus",
                "lambdagap_weight": 0.5}, None),
            ("rank_xendcg", {"objective": "rank_xendcg"}, None),
            ("position + by-query bagging 0.7/1", {
                "bagging_by_query": True, "bagging_fraction": 0.7,
                "bagging_freq": 1}, pos))
    with CpuSide() as cpu:
        futs = [cpu.submit({**base, **extra}, RANK_CPU_ROUNDS, {
            "data": X, "label": y, "group": group, "position": position})
            for _, extra, position in runs]
        outs = []
        for (name, extra, position), fut in zip(runs, futs):
            t0 = time.perf_counter()
            bst = lgt.train({**base, **extra},
                            lgt.Dataset(X, label=y, group=group,
                                        position=position), RANK_CPU_ROUNDS)
            secs = {"cuda": time.perf_counter() - t0}
            preds = {"cuda": bst.predict(X)}
            r = fut.result()
            preds["cpu"], secs["cpu"] = r["pred"], r["secs"]
            outs.append((name, preds, secs))
    for name, preds, secs in outs:
        diff = float(np.abs(preds["cuda"] - preds["cpu"]).max())
        check(np.allclose(preds["cuda"], preds["cpu"], rtol=1e-4, atol=1e-5),
              f"T9 card != CPU [{name}]: max |diff| {diff}")
        print(f"T9 card == CPU [{name}]: predictions on the training rows "
              f"max |diff| {diff:.3g}; train {secs['cuda']:.1f} s on the "
              f"card, {secs['cpu']:.1f} s on the CPU [{smi}]")


def rank_phases(args, dev, smi: str):
    """T8, T2 at 136 features, T9 and T10, each timed. Returns (T8's
    results, K1's numbers at 136 features)."""
    t0 = time.perf_counter()
    t8 = rank_train_phase(args, smi, mslr_data(args))
    print(f"T8: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    k1m = hist_mslr_phase(dev, t8, smi)
    del t8["grad"], t8["hess"], t8["row_leaf"], t8["x_rows"]
    print(f"T2 at 136 features: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rank_card_vs_cpu_phase(smi)
    print(f"T9: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    serve_trained_phase(t8["out"]["ndcg"]["bst"], t8["Xva"], dev, smi,
                        tag="T10")
    print(f"T10: {time.perf_counter() - t0:.1f} s")
    return t8, k1m


# ---------------------------------------------------------------------------
# T11-T13: multiclass at Covertype width, the other objectives card against
# CPU, regression with leaf renew at YearPredictionMSD width
# ---------------------------------------------------------------------------
def covtype_like(seed: int, n: int):
    """Seeded rows of UCI Covertype's shape (Blackard & Dean): 10
    integer-valued continuous features in its ranges (elevation
    1,859-3,858 m, aspect 0-360, slope 0-66, the hydrology, road and fire
    distances, three hillshades 0-254 from aspect and slope), then 4
    one-hot wilderness and 40 one-hot soil columns; 7 cover types, each
    row's the argmax of a per-class linear score of the features plus
    Gumbel noise, the class offsets fitted so the classes take Covertype's
    shares (``COV_SHARES``)."""
    rng = np.random.default_rng(seed)

    def clip_round(v, lo, hi):
        return np.clip(np.round(v), lo, hi)

    elev = clip_round(rng.normal(2960, 280, n), 1859, 3858)
    aspect = rng.integers(0, 361, n).astype(np.float64)
    slope = clip_round(rng.gamma(3.0, 4.7, n), 0, 66)
    a, sl = np.deg2rad(aspect), np.deg2rad(slope)

    def shade(azimuth: float, altitude: float):
        az, alt = np.deg2rad(azimuth), np.deg2rad(altitude)
        v = 254 * (np.sin(alt) * np.cos(sl)
                   + np.cos(alt) * np.sin(sl) * np.cos(az - a))
        return clip_round(v + rng.normal(0, 6, n), 0, 254)

    cont = np.stack([
        elev, aspect, slope,
        clip_round(rng.exponential(270, n), 0, 1397),       # hydrology, h
        clip_round(rng.normal(46, 58, n), -173, 601),       # hydrology, v
        clip_round(rng.exponential(2350, n), 0, 7117),      # roadways
        shade(100, 45), shade(180, 65), shade(260, 40),     # 9am, noon, 3pm
        clip_round(rng.exponential(1980, n), 0, 7173),      # fire points
    ], axis=1)
    wild = rng.choice(4, n, p=[0.45, 0.05, 0.44, 0.06])
    band = (elev - 1859) / 2000 * 39
    soil = np.clip(np.round(band + rng.normal(0, 4, n)), 0, 39).astype(int)
    X = np.zeros((n, 54), np.float32)
    X[:, :10] = cont
    X[np.arange(n), 10 + wild] = 1
    X[np.arange(n), 14 + soil] = 1
    z = (cont - cont.mean(0)) / cont.std(0)
    W = rng.normal(0, 0.5, (10, 7))
    W[0] = [1.6, 0.4, -2.2, -3.0, 0.2, -1.8, 3.0]           # elevation
    score = (z @ W + rng.normal(0, 0.8, (4, 7))[wild]
             + rng.normal(0, 0.5, (40, 7))[soil]
             + rng.gumbel(0, 1.0, (n, 7)))
    offset = np.zeros(7)
    target = np.asarray(COV_SHARES) / np.sum(COV_SHARES)
    for _ in range(40):
        y = np.argmax(score + offset, axis=1)
        share = np.bincount(y, minlength=7) / n
        offset += 0.8 * np.log(target / np.maximum(share, 1e-6))
    y = np.argmax(score + offset, axis=1)
    return X, y.astype(np.float32)


def msd_like(seed: int, n: int):
    """Seeded rows of YearPredictionMSD's shape: 90 continuous features (12
    timbre means, 78 timbre covariances, at their scales) and an integer
    release year in 1922-2011 skewed toward the 2000s (2011 minus a gamma
    draw, shifted by a sparse latent of the features)."""
    rng = np.random.default_rng(seed)
    scale = np.concatenate([np.full(12, 20.0), np.full(78, 60.0)])
    X = (rng.standard_normal((n, MSD_F), dtype=np.float32)
         * scale.astype(np.float32))
    w = rng.standard_normal(MSD_F) * (rng.random(MSD_F) < 0.2) / scale
    latent = X @ w.astype(np.float32)
    year = 2011 - rng.gamma(1.3, 8.0, n) + 2.5 * latent / latent.std()
    return X, np.clip(np.round(year), 1922, 2011).astype(np.float32)


class _RoundProbe:
    """A training callback. Each round: the wall since the last round's
    end, the host wall of each of its trees and renew passes (the
    booster's ``tree_ms`` / ``renew_ms``), the K1 and K2 launches; then,
    outside the next round's wall, the gradient pass's device time (CUDA
    events) and the validation metrics' host time, each a repeat of the
    round's own pass at the round's end scores. ``keep_scores`` keeps the
    last two rounds' class-0 training scores on the host."""

    def __init__(self, keep_scores: bool = False) -> None:
        self.rounds = []
        self.scores = []
        self.keep_scores = keep_scores
        self.t_last = 0.0

    def start(self) -> None:
        self.t_last = time.perf_counter()

    def __call__(self, env) -> None:
        import torch
        from lambdagap_tpu_torch.ops import hist_cuda as hc
        wall = (time.perf_counter() - self.t_last) * 1e3
        gb = env.model._booster
        r = {"wall": wall, "trees": list(gb.tree_ms),
             "renew": list(gb.renew_ms), "k1": hc.HIST_LAUNCHES.launches,
             "k2": hc.HIST_Q_LAUNCHES.launches}
        t0 = time.perf_counter()
        env.model.eval_valid()
        r["eval"] = (time.perf_counter() - t0) * 1e3
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        gb.objective.get_gradients_fast(gb.scores)
        ev[1].record()
        torch.cuda.synchronize()
        r["grad"] = ev[0].elapsed_time(ev[1])
        self.rounds.append(r)
        if self.keep_scores:
            self.scores = self.scores[-1:] + [
                gb.scores[0].cpu().numpy().copy()]
        self.t_last = time.perf_counter()


def leaves_built(bst) -> int:
    """The leaf histograms a run built: one for every leaf of every tree
    (the root's, then the smaller child's at each split), from the model
    text."""
    return sum(int(ln.split("=", 1)[1])
               for ln in bst.model_to_string().splitlines()
               if ln.startswith("num_leaves="))


def serial_built(bst) -> int:
    """The leaf histograms the serial learner built: the root's and the
    smaller child's at each split but a tree's last when that split filled
    the tree (``num_leaves`` leaves: no child is scanned after it)."""
    L = bst._booster.config.num_leaves
    return sum(t.num_leaves - (t.num_leaves == L)
               for t in bst._booster.host_models)


def probed_train(params: dict, tr, va, rounds: int, tag: str, smi: str,
                 keep_scores: bool = False):
    """Train with the launch counts zeroed just before and read just
    after, under a :class:`_RoundProbe`; checks K1 (or, quantized, K2)
    launches == the leaf histograms built (by the fused learner's rule, or
    the serial learner's: :func:`serial_built`), the other kernel
    unlaunched, and prints each round's numbers. Returns (booster,
    evaluation history, probe, launches)."""
    import torch
    import lambdagap_tpu_torch as lgt
    from lambdagap_tpu_torch.ops import hist_cuda as hc
    ev = {}
    probe = _RoundProbe(keep_scores)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hc.HIST_LAUNCHES.reset()
    hc.HIST_Q_LAUNCHES.reset()
    t0 = time.perf_counter()
    probe.start()
    bst = lgt.train(params, tr, rounds, valid_sets=[va],
                    callbacks=[probe, lgt.early_stopping(5, verbose=False),
                               lgt.record_evaluation(ev)])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    k1, k2 = hc.HIST_LAUNCHES.launches, hc.HIST_Q_LAUNCHES.launches
    gb = bst._booster
    quant = bool(params.get("use_quantized_grad")) and not gb.serial
    built = serial_built(bst) if gb.serial else leaves_built(bst)
    used, other = (k2, k1) if quant else (k1, k2)
    check(gb.scores.device.type == "cuda" and gb.learner.x_rows.is_cuda,
          f"{tag}: did not train on the card")
    check(used > 0 and used == built, f"{tag}: {'K2' if quant else 'K1'} "
          f"launches {used} != leaf histograms built {built}")
    check(other == 0, f"{tag}: launched {'K1' if quant else 'K2'} {other} "
          "times")
    check(bool(torch.isfinite(gb.scores).all()),
          f"{tag}: non-finite training scores")
    key = "k2" if quant else "k1"
    before = 0
    for i, r in enumerate(probe.rounds):
        renew = (f", renew {sum(r['renew']):.1f} ms" if r["renew"] else "")
        print(f"{tag} round {i + 1}: wall {r['wall']:.1f} ms; "
              f"{len(r['trees'])} tree(s) {sum(r['trees']):.1f} ms host wall "
              f"({', '.join(f'{w:.0f}' for w in r['trees'])}), "
              f"{r[key] - before} histograms; gradient pass "
              f"{r['grad']:.3f} ms device; validation metrics "
              f"{r['eval']:.1f} ms host{renew} [{smi}]")
        before = r[key]
    peak = torch.cuda.max_memory_allocated()
    print(f"{tag}: {len(probe.rounds)} rounds in {train_s:.2f} s; "
          f"{'K2' if quant else 'K1'} launches {used} == leaf histograms "
          f"built; peak device memory {peak / 1e9:.3f} GB; validation "
          + "; ".join(f"{m} {v[0]:.5f} -> {v[-1]:.5f}"
                      for m, v in ev["valid_0"].items()) + f" [{smi}]")
    return bst, ev["valid_0"], probe, used


def partition_leaf(bins, col: int):
    """A leaf laid out as the learner lays one out: the rows stably
    partitioned on one column's median bin, the right child read at its
    offset in that slice. Returns (positions, offset, count)."""
    import torch
    b = bins[:, col].int()
    left = b <= b.median()
    perm = torch.cat([torch.nonzero(left).flatten(),
                      torch.nonzero(~left).flatten()]).int()
    off = int(left.sum())
    return perm, off, len(perm) - off


def held_to_plain(what: str, kernel, plain, args, live: int) -> float:
    """One histogram kernel against its plain version: ``torch.equal`` on
    every channel, a rerun ``torch.equal``, ``live`` rows counted in every
    column. Returns the max |difference| (0)."""
    import torch
    got = kernel(*args)
    again = kernel(*args)
    ref = plain(*args)
    torch.cuda.synchronize()
    check(torch.equal(got, again), f"{what}: rerun not bit-identical")
    check(torch.equal(got, ref), f"{what} != plain: "
          f"{int((got != ref).sum())} entries differ")
    check(int(got[..., 2].double().sum()) == live * args[0].shape[1],
          f"{what}: counted rows wrongly")
    print(f"{what} == plain: torch.equal on every channel, rerun "
          f"bit-identical, {live} rows")
    return float((got.double() - ref.double()).abs().max())


def covtype_data(args, smi: str):
    import lambdagap_tpu_torch as lgt
    t0 = time.perf_counter()
    X, y = covtype_like(args.seed + 300, COV_TRAIN + COV_VALID)
    gen_s = time.perf_counter() - t0
    params = {"objective": "multiclass", "num_class": 7,
              "metric": ["multi_logloss", "multi_error", "auc_mu"],
              "num_leaves": LEAVES, "max_bin": MAX_BIN, "learning_rate": 0.1,
              "verbose": -1}
    cfg = lgt.Config.from_params(params)
    t0 = time.perf_counter()
    tr = lgt.Dataset(X[:COV_TRAIN], label=y[:COV_TRAIN])
    va = lgt.Dataset(X[COV_TRAIN:], label=y[COV_TRAIN:], reference=tr)
    ds = tr.construct(cfg)
    va.construct(cfg)
    bun = ds.ensure_bundle(cfg)
    build_s = time.perf_counter() - t0
    check(bun is not None and bun.num_cols < X.shape[1],
          "T11: EFB formed no bundle of the one-hot columns")
    sizes = sorted((len(m) for m in bun.members if len(m) > 1), reverse=True)
    shares = np.bincount(y.astype(int), minlength=7) / len(y)
    print(f"T11 data: {COV_TRAIN} + {COV_VALID} rows x {X.shape[1]} "
          f"features (Covertype's shape), class shares "
          f"{np.round(100 * shares, 2).tolist()} % made in {gen_s:.1f} s; "
          f"Dataset construction (binning, EFB) {build_s:.1f} s [{smi}]")
    print(f"T11 EFB: {len(ds.used_features)} used features in "
          f"{bun.num_cols} bundled columns; bundles of {sizes} features (the "
          "rest single)")
    print(f"T11 cuts: synthetic rows of Covertype's shape (not the data); "
          f"{COV_ROUNDS} / {COV_SHORT_ROUNDS} / {COV_SHORT_ROUNDS} rounds "
          "(the reference runs hundreds); features, classes, one-hot "
          "structure, leaves and bins uncut")
    return params, tr, va, X[COV_TRAIN:], shares


def covtype_phase(args, dev, smi: str) -> dict:
    """T11a-c: 7-class softmax (2 rounds, early stopping, multi_logloss,
    multi_error, auc_mu), one-vs-all (2 rounds) and quantized + bagged
    softmax (2 rounds) on one pair of Covertype-width Datasets."""
    import torch
    params, tr, va, Xva, shares = covtype_data(args, smi)
    bst, hist, probe, k1 = probed_train(params, tr, va, COV_ROUNDS, "T11a",
                                        smi)
    ll, err = hist["multi_logloss"], hist["multi_error"]
    majority = 1.0 - float(shares.max())
    check(ll[-1] < ll[0], f"T11a valid multi_logloss did not fall: {ll}")
    check(err[-1] < majority, f"T11a valid multi_error {err[-1]} not below "
          f"the majority class's {majority}")
    check(0.5 < hist["auc_mu"][-1] <= 1.0, f"T11a auc_mu {hist['auc_mu']}")
    gb = bst._booster
    walls = [w for r in probe.rounds for w in r["trees"]]
    prev = probe.rounds[-2]["k1"] if len(probe.rounds) > 1 else 0
    per_tree = (probe.rounds[-1]["k1"] - prev) / 7
    print(f"T11a: {len(walls)} trees, {np.mean(walls):.1f} ms host wall a "
          f"tree, {per_tree:.1f} histograms a tree in the last round; "
          f"multi_error {err[-1]:.5f} < {majority:.5f} (majority class) "
          f"[{smi}]")
    # round 1's softmax gradients, for T2 at this width
    obj = gb.objective
    init = torch.tensor([obj.boost_from_score(k) for k in range(7)],
                        dtype=torch.float32, device=dev)
    s0 = torch.zeros((7, gb.num_data), dtype=torch.float32, device=dev)
    s0 += init[:, None]
    g1, h1 = obj.get_gradients_fast(s0)
    out = {"bst": bst, "Xva": Xva, "launches": k1,
           "grad": g1[1].contiguous(), "hess": h1[1].contiguous(),
           "x_rows": gb.learner.x_rows, "Bb": gb.learner.Bb,
           "hist_builds_tree": per_tree}
    _, hist_b, _, _ = probed_train({**params, "objective": "multiclassova"},
                                   tr, va, COV_SHORT_ROUNDS, "T11b", smi)
    check(all(np.isfinite(v).all() for v in hist_b.values()),
          "T11b: non-finite validation metrics")
    qparams = {**params, "use_quantized_grad": True,
               "num_grad_quant_bins": 4, "bagging_fraction": 0.8,
               "bagging_freq": 1}
    bst_c, hist_c, _, k2 = probed_train(qparams, tr, va, COV_SHORT_ROUNDS,
                                        "T11c", smi)
    check(bst_c._booster.learner.quant, "T11c did not train quantized")
    check(hist_c["multi_logloss"][-1] < hist_c["multi_logloss"][0],
          "T11c valid multi_logloss did not fall")
    out["k2_launches"] = k2
    out["q"] = round_one_levels(bst_c._booster, g1, h1)
    del s0, g1, h1
    return out


def round_one_levels(gb, grad, hess):
    """What K2 saw in T11c's first tree: round 1's softmax gradients (at
    the init scores) bagged by round 1's mask and quantized to class 0's
    levels with that tree's key. Returns (g_q, h_q, mask)."""
    from lambdagap_tpu_torch.models.sample_strategy import \
        create_sample_strategy
    from lambdagap_tpu_torch.ops.hist_cuda import quantize_gradients
    from lambdagap_tpu_torch.utils import prng
    cfg = gb.config
    strat = create_sample_strategy(cfg, gb.num_data,
                                   label=gb.train_set.metadata.label)
    g, h, mask = strat.sample(0, grad, hess)
    key = prng.split(prng.PRNGKey(cfg.data_random_seed + 7919))[1]
    gq, hq, _, _ = quantize_gradients(g[0], h[0], key,
                                      cfg.num_grad_quant_bins,
                                      cfg.stochastic_rounding)
    return gq, hq, mask


def hist_covtype_phase(dev, t11: dict, smi: str) -> dict:
    """T2 at T11's width: K1 against its plain version at the root of the
    bundled Covertype matrix with round 1's softmax gradients of one
    class, ``torch.equal`` on every channel and on a rerun; its time, the
    plain version's, ``index_add_``'s and the bound. Then K2 against its
    plain version at T11c's shapes: the root and a leaf at an offset, with
    round 1's bagged 4-level levels. Returns (K1's numbers, K2's max
    |difference|)."""
    from lambdagap_tpu_torch.ops import hist_cuda as hc
    bins, grad, hess, nb = t11["x_rows"], t11["grad"], t11["hess"], t11["Bb"]
    N, C = bins.shape
    args = (bins, grad, hess, None, N, nb, None, None,
            hc.hist_scale(grad, hess))
    err = held_to_plain(f"K1 at T11 width [{N} rows x {C} bundled columns, "
                        f"{nb} bins, round 1's class-1 softmax gradients]",
                        hc.hist_rows, hc._hist_reference, args, N)
    timed = time_hist("K1@covtype", "T11 root, bundled columns", hc.hist_rows,
                      hc._hist_reference, args, N, 0, smi, 8, 5)
    print(f"K1@covtype launches: {t11['hist_builds_tree']:.1f} a tree, "
          f"{7 * t11['hist_builds_tree']:.0f} a 7-class round [{smi}]")
    gq, hq, mask = t11["q"]
    perm, off, count = partition_leaf(bins, 0)
    err_q = max(
        held_to_plain(f"K2 at T11c's root [{N} rows x {C} bundled columns, "
                      "round 1's bagged 4-level class-0 levels]",
                      hc.hist_rows_q, hc._hist_q_reference,
                      (bins, gq, hq, None, N, nb, mask), int(mask.sum())),
        held_to_plain(f"K2 at a T11c leaf [{count} rows at offset {off}]",
                      hc.hist_rows_q, hc._hist_q_reference,
                      (bins, gq, hq, perm, one(dev, count), nb, mask,
                       one(dev, off)), int(mask[perm[off:].long()].sum())))
    return {**timed, "max_abs_err": err}, err_q


def covtype_serve_phase(t11: dict, dev, smi: str) -> None:
    """T11-serve: T11a's model text served on the card, early stop off and
    then on: each answer ``array_equal`` to the scan oracle, converted
    outputs the oracle's softmax at rtol 1e-6, K3 launches == accumulation
    launches."""
    import torch
    import lambdagap_tpu_torch as lgt
    from lambdagap_tpu_torch.ops.predict import (forest_to_arrays,
                                                 predict_forest)
    text = t11["bst"].model_to_string()
    data = np.ascontiguousarray(t11["Xva"][:20_000])
    plan = [((i * 977) % (len(data) - SIZES[i % len(SIZES)]),
             SIZES[i % len(SIZES)]) for i in range(REQUESTS)]
    base = lgt.Booster(model_str=text)
    gb = base._booster
    K = gb.num_tree_per_iteration
    check(K == 7, f"T11-serve: {K} trees a round")
    forest, depth = forest_to_arrays(gb.models, device=dev)
    tc = [i % K for i in range(len(gb.models))]
    x = torch.from_numpy(data).to(dev)
    oracle = predict_forest(x, forest, tc, K, depth).T.cpu().numpy()
    top2 = np.sort(oracle, axis=1)[:, -2:]
    margin = float(np.median(top2[:, 1] - top2[:, 0])) / 2
    for name, extra in (("early stop off", {}), (
            f"early stop on (freq 1 round, margin {margin:.4f})",
            {"pred_early_stop": True, "pred_early_stop_freq": 1,
             "pred_early_stop_margin": margin})):
        bst = lgt.Booster(model_str=text, params=extra)
        want = oracle if not extra else predict_forest(
            x, forest, tc, K, depth, early_stop_freq=K,
            early_stop_margin=margin).T.cpu().numpy()
        with Dispatches() as d:
            with bst.as_server(raw_score=True, workers=1) as server:
                answers, secs = burst(server, data, plan)
        d.check(f"T11-serve [{name}]")
        check_answers(answers, plan, want)
        conv = bst.predict(data[:4096])
        z = want[:4096].astype(np.float64)
        e = np.exp(z - z.max(axis=1, keepdims=True))
        check(np.allclose(conv, e / e.sum(axis=1, keepdims=True), rtol=1e-6,
                          atol=1e-7),
              f"T11-serve [{name}]: converted != the oracle's softmax")
        stopped = int((want != oracle).any(axis=1).sum())
        if extra:
            check(0 < stopped < len(data), f"T11-serve: early stop stopped "
                  f"{stopped} of {len(data)} rows")
        print(f"T11-serve [{name}]: {len(gb.models)} trees (7 classes), "
              f"{REQUESTS} requests in {secs:.2f} s, each == scan oracle "
              f"([rows, 7] raw scores), converted == its softmax at rtol "
              f"1e-6; {d.line()}; {stopped} of {len(data)} rows stopped "
              f"early [{smi}]")


def objectives_card_vs_cpu_phase(smi: str) -> None:
    """T12: 16,000 rows x 20 features, one 12-category column, 31 leaves,
    2 rounds with a validation set and early stopping, every objective
    this slice adds, each on the card and on the CPU: training-row
    predictions within rtol 1e-4 / atol 1e-5, the same best_iteration."""
    import lambdagap_tpu_torch as lgt
    rng = np.random.RandomState(6)
    n = 20_000
    X = rng.randn(n, 20)
    X[:, 0] = rng.randint(0, 12, n)
    z = (X[:, 1] + 0.5 * X[:, 2] * X[:, 3] + np.sin(2 * X[:, 4])
         + (X[:, 0] % 4) * 0.4 + 0.3 * rng.randn(n))
    cls = np.digitize(z, np.quantile(z, [0.25, 0.5, 0.75])).astype(float)
    prob = 1.0 / (1.0 + np.exp(-z))
    pos = np.exp(0.4 * z)
    # Bernoulli trial counts in (0.2, 1]: cross_entropy_lambda's hessian (the
    # JAX package's) turns negative above one trial (ROADMAP.md Queue 3)
    trials = 1.0 - 0.8 * rng.rand(n)
    configs = [
        ("multiclass (4 classes)", {"objective": "multiclass",
                                    "num_class": 4}, cls, None),
        ("multiclassova", {"objective": "multiclassova", "num_class": 4},
         cls, None),
        ("multiclass + GOSS", {"objective": "multiclass", "num_class": 4,
                               "data_sample_strategy": "goss",
                               "learning_rate": 0.3}, cls, None),
        ("regression_l1", {"objective": "regression_l1"}, 10 * z + 50, None),
        ("regression_l1 + bagging 0.7/1",
         {"objective": "regression_l1", "bagging_fraction": 0.7,
          "bagging_freq": 1}, 10 * z + 50, None),
        ("huber", {"objective": "huber"}, z, None),
        ("fair", {"objective": "fair"}, z, None),
        ("poisson", {"objective": "poisson"},
         rng.poisson(pos).astype(float), None),
        ("quantile (alpha 0.9)", {"objective": "quantile", "alpha": 0.9},
         z, None),
        ("mape", {"objective": "mape"}, 10 * z + 50, None),
        ("gamma", {"objective": "gamma"}, pos * rng.gamma(2.0, 0.5, n), None),
        ("tweedie", {"objective": "tweedie"},
         rng.poisson(pos) * rng.gamma(2.0, 0.5, n), None),
        ("cross_entropy", {"objective": "cross_entropy"}, prob, None),
        ("cross_entropy_lambda + trial counts",
         {"objective": "cross_entropy_lambda"}, prob, trials),
    ]
    base = {"num_leaves": 31, "learning_rate": 0.1, "verbose": -1}
    tr_rows = slice(0, 16_000)
    va_rows = slice(16_000, n)
    def sets(y, wt):
        return ({"data": X[tr_rows], "label": y[tr_rows],
                 "weight": None if wt is None else wt[tr_rows],
                 "categorical_feature": [0]},
                {"data": X[va_rows], "label": y[va_rows],
                 "weight": None if wt is None else wt[va_rows]})

    with CpuSide() as cpu:
        futs = [cpu.submit({**base, **extra}, OBJ_CPU_ROUNDS, *sets(y, wt))
                for _, extra, y, wt in configs]
        outs = []
        for (name, extra, y, wt), fut in zip(configs, futs):
            train_kw, valid_kw = sets(y, wt)
            tr = lgt.Dataset(**train_kw)
            va = lgt.Dataset(reference=tr, **valid_kw)
            t0 = time.perf_counter()
            bst = lgt.train({**base, **extra}, tr, OBJ_CPU_ROUNDS,
                            valid_sets=[va],
                            callbacks=[lgt.early_stopping(5, verbose=False)])
            secs = {"cuda": time.perf_counter() - t0}
            preds = {"cuda": bst.predict(X[tr_rows])}
            raw = {"cuda": bst.predict(X[tr_rows], raw_score=True)}
            best = {"cuda": bst.best_iteration}
            r = fut.result()
            preds["cpu"], raw["cpu"] = r["pred"], r["raw"]
            best["cpu"], secs["cpu"] = r["best"], r["secs"]
            outs.append((name, preds, raw, best, secs))
    for name, preds, raw, best, secs in outs:
        diff = float(np.abs(preds["cuda"] - preds["cpu"]).max())
        raw_diff = float(np.abs(raw["cuda"] - raw["cpu"]).max())
        for a, b, d, what in ((preds, preds, diff, "predictions"),
                              (raw, raw, raw_diff, "raw scores")):
            check(np.allclose(a["cuda"], b["cpu"], rtol=1e-4, atol=1e-5),
                  f"T12 card != CPU [{name}]: {what} max |diff| {d}")
        check(best["cuda"] == best["cpu"], f"T12 best_iteration card "
              f"{best['cuda']} != CPU {best['cpu']} [{name}]")
        print(f"T12 card == CPU [{name}]: on the training rows max |diff| "
              f"{diff:.3g} (converted), {raw_diff:.3g} (raw), best_iteration"
              f" {best['cuda']}; train {secs['cuda']:.1f} s on the card, "
              f"{secs['cpu']:.1f} s on the CPU [{smi}]")


def leaf_of_rows(tree, X: np.ndarray) -> np.ndarray:
    """Each row's leaf in a host tree of numerical splits without missing
    values, by its raw-value thresholds (x <= threshold goes left)."""
    node = np.zeros(len(X), np.int64)
    if tree.num_leaves == 1:
        return node
    feat, thr = np.asarray(tree.split_feature), np.asarray(tree.threshold_real)
    left, right = np.asarray(tree.left_child), np.asarray(tree.right_child)
    live = np.arange(len(X))
    while live.size:
        nd = node[live]
        nxt = np.where(X[live, feat[nd]] <= thr[nd], left[nd], right[nd])
        node[live] = nxt
        live = live[nxt >= 0]
    return ~node


def msd_phase(args, dev, smi: str) -> float:
    """T13: regression_l1 and quantile (alpha 0.9), both on the renew
    path, and huber, 2 rounds each at YearPredictionMSD width with 255
    leaves; the renew pass's host ms per tree; two leaves of each renewed
    run's last tree against numpy's percentile of their residuals; K1
    against its plain version on the 90-feature matrix with round 1's L1
    gradients, at the root and at a leaf at an offset. Returns K1's max
    |difference|."""
    import torch
    import lambdagap_tpu_torch as lgt
    from lambdagap_tpu_torch.ops import hist_cuda as hc
    t0 = time.perf_counter()
    X, y = msd_like(args.seed + 400, MSD_TRAIN + MSD_VALID)
    base = {"num_leaves": LEAVES, "max_bin": MAX_BIN, "learning_rate": 0.1,
            "verbose": -1, "objective": "regression_l1"}
    cfg = lgt.Config.from_params(base)
    tr = lgt.Dataset(X[:MSD_TRAIN], label=y[:MSD_TRAIN])
    va = lgt.Dataset(X[MSD_TRAIN:], label=y[MSD_TRAIN:], reference=tr)
    tr.construct(cfg)
    va.construct(cfg)
    label = y[:MSD_TRAIN]
    print(f"T13 data: {MSD_TRAIN} + {MSD_VALID} rows x {MSD_F} features "
          f"(YearPredictionMSD's shape), years {int(y.min())}-{int(y.max())},"
          f" median {np.median(y):.0f}; made and binned in "
          f"{time.perf_counter() - t0:.1f} s [{smi}]")
    err = 0.0
    for name, extra, q in (("regression_l1", {}, 0.5),
                           ("quantile", {"objective": "quantile",
                                         "alpha": 0.9}, 0.9),
                           ("huber", {"objective": "huber"}, None)):
        params = {**base, **extra}
        bst, hist, probe, _ = probed_train(params, tr, va, MSD_ROUNDS,
                                           f"T13 [{name}]", smi,
                                           keep_scores=q is not None)
        (metric, values), = hist.items()
        check(values[-1] < values[0], f"T13 [{name}] valid {metric} did not "
              f"fall: {values}")
        gb = bst._booster
        if q is None:
            continue
        renew = [m for r in probe.rounds for m in r["renew"]]
        trees = [w for r in probe.rounds for w in r["trees"]]
        check(len(renew) == len(trees) == MSD_ROUNDS,
              f"T13 [{name}]: {len(renew)} renew passes for {len(trees)} "
              "trees")
        print(f"T13 [{name}] renew pass (row_leaf read + per-leaf weighted "
              f"percentiles, host): {', '.join(f'{m:.1f}' for m in renew)} "
              f"ms a tree [{smi}]")
        # the run's last tree: two leaves against numpy's percentile of the
        # residuals at the scores before that tree
        tree = gb.models[-1]
        check(not any(tree.is_categorical), "T13: a categorical split")
        score = probe.scores[0]
        leaf_of = leaf_of_rows(tree, X[:MSD_TRAIN])
        counts = np.bincount(leaf_of, minlength=tree.num_leaves)
        rate = base["learning_rate"]
        for leaf in (int(np.argmax(counts)), int(np.argmin(
                np.where(counts > 0, counts, counts.max() + 1)))):
            rows = np.nonzero(leaf_of == leaf)[0]
            resid = (label[rows] - score[rows]).astype(np.float64)
            want = float(np.percentile(resid, 100 * q)) * rate
            got = float(tree.leaf_value[leaf])
            check(abs(got - want) <= (1e-5 + 1e-6 * abs(want)) * rate,
                  f"T13 [{name}] leaf {leaf}: renewed {got} != numpy "
                  f"percentile x {rate} {want}")
            print(f"T13 [{name}] last tree, leaf {leaf} ({len(rows)} rows): "
                  f"renewed {got:.7f} == numpy percentile x {rate} "
                  f"{want:.7f}")
        if name != "regression_l1":
            continue
        # K1 at this width: round 1's L1 gradients (at the init score)
        lr = gb.learner
        s0 = torch.full((1, gb.num_data), gb.objective.boost_from_score(0),
                        dtype=torch.float32, device=dev)
        g, h = (a[0].contiguous() for a in gb.objective.get_gradients_fast(s0))
        k = hc.hist_scale(g, h)
        bins, nb = lr.x_rows, lr.Bb
        N, C = bins.shape
        perm, off, count = partition_leaf(bins, 0)
        err = max(
            held_to_plain(f"K1 at T13's root [{N} rows x {C} columns, {nb} "
                          "bins, round 1's L1 gradients]", hc.hist_rows,
                          hc._hist_reference,
                          (bins, g, h, None, N, nb, None, None, k), N),
            held_to_plain(f"K1 at a T13 leaf [{count} rows at offset "
                          f"{off}]", hc.hist_rows, hc._hist_reference,
                          (bins, g, h, perm, one(dev, count), nb, None,
                           one(dev, off), k), count))
        del s0, g, h, perm
        torch.cuda.empty_cache()
    return err


def objective_phases(args, dev, smi: str):
    """T11a-c, T2 at T11's width, T11-serve, T12 and T13, each timed.
    Returns (T11's results, K1's numbers at T11's width with T13's
    comparisons folded into its max |difference|, K2's max |difference| at
    T11c's shapes)."""
    t0 = time.perf_counter()
    t11 = covtype_phase(args, dev, smi)
    print(f"T11: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    k1c, k2c_err = hist_covtype_phase(dev, t11, smi)
    del t11["grad"], t11["hess"], t11["x_rows"], t11["q"]
    print(f"T2 at T11 width: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    covtype_serve_phase(t11, dev, smi)
    print(f"T11-serve: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    objectives_card_vs_cpu_phase(smi)
    print(f"T12: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    k1m_err = msd_phase(args, dev, smi)
    print(f"T13: {time.perf_counter() - t0:.1f} s")
    k1c["max_abs_err"] = max(k1c["max_abs_err"], k1m_err)
    return t11, k1c, k2c_err


# ---------------------------------------------------------------------------
# T14: the predict API — the tensor engine, pred_leaf on K3, pred_contrib on
# kernel S, refit
# ---------------------------------------------------------------------------
def shap_bound(paths, rows: int, x_bytes: int, phi_bytes: int):
    """Kernel S's bound: the rows, the path tables and phi moved once;
    per (row, path) of e merged elements and d edges, 7 e(e+1)/2 float64
    operations to extend, 4 e^2 for the unwound sums (their cheaper
    branch; a division counted as one operation), 4 e for the
    contributions and 6 d for the decisions."""
    e = np.diff(np.asarray(paths.path_elem_lo)).astype(np.float64)
    d = np.diff(np.asarray(paths.path_edge_lo)).astype(np.float64)
    ops = rows * float((3.5 * e * (e + 1) + 4 * e * e + 4 * e + 6 * d).sum())
    nbytes = x_bytes + phi_bytes + sum(
        int(np.asarray(a).nbytes) for a in paths[:15])
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_F64_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", ops, nbytes)


def leaves_of(booster) -> np.ndarray:
    return np.concatenate([t.leaf_value[:t.num_leaves]
                           for t in booster._booster.host_models])


def predict_phase(dev, smi: str, text: str, trees, data, plan, oracle,
                  t3: dict, t11: dict) -> dict:
    """T14 on phase 3's forest (its text and trees), phase 5's rows, plan
    and scan oracle, and T3's and T11a's trained boosters. Returns K3's
    pred_leaf launches and kernel S's entry of the kernels line."""
    import torch
    import lambdagap_tpu_torch as lgt
    from lambdagap_tpu_torch.models import shap

    # -- the tensor engine: predict and serve == the scan oracle ------------
    t0 = time.perf_counter()
    bt = lgt.Booster(model_str=text, params={"predict_engine": "tensor"})
    check(np.array_equal(bt.predict(data, raw_score=True), oracle),
          "T14: the tensor engine's 20,000-row predict != scan oracle")
    # the server: one tile of all the trees, one worker (every dispatch is
    # some thousands of small torch ops, which four workers only contend
    # for under the interpreter lock)
    one_tile = lgt.Booster(model_str=text, params={
        "predict_engine": "tensor", "predict_tree_tile": T})
    with one_tile.as_server(raw_score=True, workers=1) as srv:
        check(srv.cache.engine == "tensor", "T14: server not on the tensor "
              "engine")
        answers, secs = burst(srv, data, plan)
    check_answers(answers, plan, oracle)
    bc = lgt.Booster(model_str=text)
    x4k = data[:SHAP_ROWS]
    wall_t = wall_ms(lambda: bt.predict(x4k, raw_score=True), reps=5)
    with Dispatches() as d:
        wall_c = wall_ms(lambda: bc.predict(x4k, raw_score=True), reps=5)
    d.check("T14 compiled predict")
    print(f"T14 tensor engine: {len(data)} rows (tiles of 64 trees) and "
          f"{len(plan)} requests served by one worker ({secs:.2f} s, one "
          f"tile of {T} trees) == scan oracle; host wall of a "
          f"{SHAP_ROWS}-row predict {wall_t:.2f} ms (compiled engine "
          f"{wall_c:.3f} ms: {d.line()}) ({time.perf_counter() - t0:.1f} "
          f"s) [{smi}]")

    # -- pred_leaf under compiled: K3's carry (counts zeroed just before) ----
    t0 = time.perf_counter()
    with Dispatches() as d:
        leaves = bc.predict(x4k, pred_leaf=True)
    leaf_launches = d.k3
    check(leaf_launches == 1 and d.fused == 0 and d.acc == 0,
          f"T14: pred_leaf made {d.line()}")
    check(leaves.shape == (SHAP_ROWS, T), f"T14: pred_leaf {leaves.shape}")
    check(np.array_equal(leaves, bt.predict(x4k, pred_leaf=True)),
          "T14: pred_leaf (K3) != the tensor engine's")
    bs = lgt.Booster(model_str=text, params={"predict_engine": "scan"})
    check(np.array_equal(leaves, bs.predict(x4k, pred_leaf=True)),
          "T14: pred_leaf (K3) != the scan engine's")
    print(f"T14 pred_leaf: [{SHAP_ROWS}, {T}] leaves from {leaf_launches} "
          f"K3 launch(es) == tensor and scan engines "
          f"({time.perf_counter() - t0:.1f} s) [{smi}]")

    # -- pred_contrib: the main path through Booster.predict ----------------
    t0 = time.perf_counter()
    b3, b11 = t3["bst"], t11["bst"]
    X3, X11 = t3["Xva"][:SHAP_ROWS], t11["Xva"][:2048]
    bc.predict(data[:8], pred_contrib=True)     # builds the forest's paths
    build_s = time.perf_counter() - t0
    shap.TREE_SHAP_LAUNCHES.reset()
    c_forest = bc.predict(x4k, pred_contrib=True)
    c3 = b3.predict(X3, pred_contrib=True)
    c11 = b11.predict(X11, pred_contrib=True)
    torch.cuda.synchronize()
    s_launches = shap.TREE_SHAP_LAUNCHES.launches
    check(s_launches == 3, f"T14: kernel S launched {s_launches} times for "
          "3 pred_contrib calls")
    check(c_forest.shape == (SHAP_ROWS, F + 1)
          and np.isfinite(c_forest).all(), "T14: forest contributions")
    raw3 = b3.predict(X3, raw_score=True)
    check(np.allclose(c3.sum(axis=1), raw3, rtol=1e-5, atol=1e-6),
          "T14: T3 contributions do not sum to the raw scores")
    F11 = X11.shape[1]
    raw11 = b11.predict(X11, raw_score=True)
    sums11 = c11.reshape(len(X11), 7, F11 + 1).sum(axis=2)
    check(c11.shape == (len(X11), 7 * (F11 + 1))
          and np.allclose(sums11, raw11, rtol=1e-5, atol=1e-6),
          "T14: T11a contributions do not sum to the raw scores per class")
    print(f"T14 pred_contrib: the {T}-tree forest's first call (paths "
          f"built and uploaded) {build_s:.1f} s; S launches {s_launches} "
          f"(forest "
          f"{SHAP_ROWS} rows, T3 {len(X3)} rows, T11a {len(X11)} rows x 7 "
          f"classes); row sums == raw scores (max |diff| T3 "
          f"{np.abs(c3.sum(axis=1) - raw3).max():.3g}, T11a "
          f"{np.abs(sums11 - raw11).max():.3g}) [{smi}]")

    # -- kernel S against its plain version; times and bound ----------------
    s = shap_kernel_phase(dev, smi, trees, data)

    # -- refit on T3's validation rows ---------------------------------------
    Xv, yv = t3["Xva"], t3["valid"].get_label()
    old = leaves_of(b3)
    t0 = time.perf_counter()
    same = b3.refit(Xv, yv, decay_rate=1.0)
    refit1_s = time.perf_counter() - t0
    check(np.array_equal(leaves_of(same), old),
          "T14: refit with decay_rate=1.0 changed a leaf")
    t0 = time.perf_counter()
    new = b3.refit(Xv, yv, decay_rate=0.9)
    refit9_s = time.perf_counter() - t0
    lv = leaves_of(new)
    check(np.isfinite(lv).all() and not np.array_equal(lv, old),
          "T14: refit with decay_rate=0.9")
    print(f"T14 refit: T3's model on {len(Xv)} validation rows, "
          f"decay_rate=1.0 every leaf unchanged ({refit1_s:.2f} s host "
          f"wall), 0.9 every leaf finite ({refit9_s:.2f} s) [{smi}]")
    big = s[SHAP_ROWS]
    return {"leaf_launches": leaf_launches, "shap": {
        "name": "tree_shap", "route": "cuda",
        "source": "lambdagap_tpu_torch/csrc/treeshap.cu",
        "replaces": "lambdagap_tpu/native/treeshap.cpp:173",
        "launches": s_launches,
        "max_abs_err": max(v["max_abs_err"] for v in s.values()),
        "ms": big["ms"], "plain_ms": big["plain_ms"],
        "bound_ms": big["bound_ms"], "bound_by": big["bound_by"],
        "library_ms": None}}


def shap_kernel_phase(dev, smi: str, trees, data) -> dict:
    """Kernel S on phase 3's forest against its plain version at 1, 256
    and 4,096 rows (rtol 1e-9 / atol 1e-12), each rerun bit-identical:
    the path build's host time, the warp groups and their packing, the
    long paths, the CUDA launches a call makes, S's device time, the plain
    version's and the bound. Returns each row count's numbers."""
    import torch
    from lambdagap_tpu_torch.models import shap

    t0 = time.perf_counter()
    paths = shap.build_paths(trees, [0] * len(trees), 1)
    build_s = time.perf_counter() - t0
    p = shap.to_device(paths, dev)
    groups = paths.class_groups[-1]
    lane_path = np.asarray(paths.lane_path)
    eff = float((lane_path >= 0).sum()) / max(1, 32 * groups)
    print(f"T14 S layout: {len(paths.path_value)} paths (longest merged "
          f"path {paths.max_elems} elements) in {groups} warp groups, "
          f"packing efficiency {eff:.4f} (lanes used / 32 x groups), "
          f"{paths.num_long} long paths; paths built in {build_s:.3f} s "
          f"(host) [{smi}]")
    out, first = {}, None
    for n in SHAP_TIMED_ROWS:
        x = torch.from_numpy(data[:n].astype(np.float64)).to(dev)
        plan = shap.launch_plan(paths, n, x.shape[1])
        got = shap.tree_shap(x, p)
        again = shap.tree_shap(x, p)
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        a.record()
        want = shap._tree_shap_reference(x, p, max_lattice=1 << 25)
        b.record()
        torch.cuda.synchronize()
        plain_ms = a.elapsed_time(b)
        check(torch.equal(got, again), f"T14: kernel S rerun differs at {n} "
              "rows")
        check(np.allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-9,
                          atol=1e-12), f"T14: kernel S != plain at {n} rows")
        first = got[:1] if first is None else first
        check(torch.equal(got[:1], first), f"T14: kernel S's row 0 at {n} "
              "rows != row 0 alone")
        err = float((got - want).abs().max())
        ms = cuda_ms(lambda: shap.tree_shap(x, p), reps=3 if n > 256 else 10,
                     warm=1)
        bound, by, ops, nbytes = shap_bound(paths, n, x.numel() * 8,
                                            got.numel() * 8)
        print(f"T14 kernel S @{n} rows x {len(paths.path_value)} paths: "
              f"{ms:.4f} ms device (median of {3 if n > 256 else 10}), "
              f"plain {plain_ms:.1f} ms, bound {bound:.4f} ms ({by}: "
              f"{ops:.3g} float64 ops, {nbytes / 1e6:.1f} MB); "
              f"{plan['cuda_launches']} CUDA launches a call ("
              f"{plan['passes']} pass(es), grid "
              f"{plan['row_tiles']} row tiles x {plan['chunks']} chunks of "
              f"{plan['groups_per_chunk']} groups, {plan['warps']} warps x "
              f"{plan['tile']} rows a block, {plan['smem_bytes']} B shared); "
              f"max |S - plain| {err:.3g}; rerun and row 0 bit-identical "
              f"[{smi}]")
        out[n] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                  "bound_by": by, "max_abs_err": err}
        del x, got, again, want
    print(f"T14 S checks: {time.perf_counter() - t0:.1f} s")
    return out


def t11a_only(args, dev, smi: str) -> dict:
    """T11a alone (``--only predict``): the 7-class model T14 explains."""
    params, tr, va, Xva, _ = covtype_data(args, smi)
    bst, _, _, _ = probed_train(params, tr, va, COV_ROUNDS, "T11a", smi)
    return {"bst": bst, "Xva": Xva}


# ---------------------------------------------------------------------------
# T15-T15b: the tree options at HIGGS width; card against CPU; the guard
# ---------------------------------------------------------------------------
# four constrained features (+1: rising in the label's score, -1: falling)
T15_MONO = {0: 1, 5: 1, 9: -1, 13: -1}
T15_GROUPS = [list(range(g, g + 7)) for g in (0, 7, 14, 21)]
T15_HALVED = (1, 3, 5, 7, 9, 11, 13, 15)
T15_FORCED = {"feature": 3, "threshold": 0.0,
              "left": {"feature": 1, "threshold": 0.5,
                       "left": {"feature": 2, "threshold": -0.5}},
              "right": {"feature": 4, "threshold": 0.0}}
T15_FORCED_BFS = [3, 1, 4, 2]     # the forced nodes' features, step order
OPTION_ROUNDS = 2                 # T15 (cut from 3: the script's time)
OPTION_CPU_ROUNDS = 8             # T15b: early_stopping(5) can fire (cut from 10 for T20)


def option_variants(f: int, forced_path: str, mono: dict, groups: list,
                    halved) -> list:
    """(tag, what, params) of T15's variants (a)-(h) at ``f`` features."""
    mc = [mono.get(j, 0) for j in range(f)]
    inter = {"monotone_constraints": mc,
             "monotone_constraints_method": "intermediate"}
    return [
        ("a", "extra_trees", {"extra_trees": True}),
        ("b", "feature_fraction_bynode=0.5",
         {"feature_fraction_bynode": 0.5}),
        ("c", "monotone basic, penalty 1",
         {"monotone_constraints": mc, "monotone_penalty": 1.0}),
        ("d", "monotone intermediate", inter),
        ("e", f"interaction_constraints, {len(groups)} groups",
         {"interaction_constraints": groups}),
        ("f", f"feature_contri halving {len(halved)} features",
         {"feature_contri": [0.5 if j in halved else 1.0
                             for j in range(f)]}),
        ("g", "three-level forced splits",
         {"forcedsplits_filename": forced_path}),
        ("h", "quantized 16 levels + bagging 0.7 + (d) + (b)",
         {"use_quantized_grad": True, "num_grad_quant_bins": 16,
          "bagging_fraction": 0.7, "bagging_freq": 1,
          "feature_fraction_bynode": 0.5, **inter}),
    ]


def check_monotone(bst, X: np.ndarray, mono: dict, tag: str) -> None:
    """Every one of ``X``'s rows predicts monotonically along a 64-point
    sweep of each constrained feature (raw scores: sums of f32 leaf
    values in forest order, and rounding is monotone, so exactly)."""
    for j, sign in mono.items():
        grid = np.quantile(X[:, j], np.linspace(0.0, 1.0, 64))
        rows = np.repeat(X, len(grid), axis=0)
        rows[:, j] = np.tile(grid, len(X))
        d = np.diff(bst.predict(rows, raw_score=True).reshape(len(X), -1),
                    axis=1)
        check(bool((d * sign >= 0).all()),
              f"{tag}: feature {j} not monotone ({sign:+d}): worst step "
              f"{float((d * sign).min())}")


def paths_features(tree) -> list:
    """The set of split features on each root-to-leaf path of a tree."""
    out, stack = [], [(0, frozenset())]
    while stack:
        node, seen = stack.pop()
        seen = seen | {tree.split_feature[node]}
        for child in (tree.left_child[node], tree.right_child[node]):
            if child >= 0:
                stack.append((child, seen))
            else:
                out.append(seen)
    return out


def tree_phases(bst, smi: str, tag: str) -> None:
    """One more tree with CUDA events around its phases (after the counts
    were read): histogram / split scan / partition / the monotone
    propagation and re-scans."""
    import torch
    gb = bst._booster
    lr = gb.learner
    lr.time_phases = True
    grad, hess = gb.boosting()
    grad, hess, mask = gb.sample_strategy.sample(gb.iter_, grad, hess)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    (lr.train if gb.serial else lr.train_device)(grad[0], hess[0], mask)
    torch.cuda.synchronize()
    tree_ms = (time.perf_counter() - t1) * 1e3
    lr.time_phases = False
    ph = lr.phase_ms
    print(f"{tag} one tree: {tree_ms:.1f} ms host wall; device-stream time "
          f"between CUDA events: histogram {ph.get('histogram', 0):.1f} ms, "
          f"split scan {ph.get('split_scan', 0):.1f} ms, partition "
          f"{ph.get('partition', 0):.1f} ms, constraints "
          f"{ph.get('constraints', 0):.1f} ms, quantize "
          f"{ph.get('quantize', 0):.1f} ms, layout_apply "
          f"{ph.get('layout_apply', 0):.1f} ms ({lr.layout}); "
          f"{lr.host_syncs} host syncs [{smi}]")


def options_phase(t3: dict, dev, smi: str) -> dict:
    """T15: each tree option on T3's Datasets at HIGGS width, 2 rounds
    each, the counts zeroed just before each run and read just after."""
    import tempfile
    import lambdagap_tpu_torch as lgt
    tmp = tempfile.mkdtemp(prefix="chip_smoke_forced_")
    forced_path = os.path.join(tmp, "forced.json")
    with open(forced_path, "w") as fh:
        json.dump(T15_FORCED, fh)
    Xs = np.ascontiguousarray(t3["Xva"][:1000])
    out = {}
    for tag, what, extra in option_variants(F, forced_path, T15_MONO,
                                            T15_GROUPS, T15_HALVED):
        name = f"T15({tag})"
        params = {**t3["params"], **extra}
        t0 = time.perf_counter()
        bst, hist, probe, used = probed_train(params, t3["train"],
                                              t3["valid"], OPTION_ROUNDS,
                                              f"{name} [{what}]", smi)
        wall = time.perf_counter() - t0
        ll = hist["binary_logloss"]
        check(ll[-1] < ll[0], f"{name}: valid logloss did not fall: "
              f"{ll[0]} -> {ll[-1]}")
        trees = bst._booster.host_models
        syncs = bst._booster.learner.host_syncs
        if "monotone_constraints" in extra:
            check_monotone(bst, Xs, T15_MONO, name)
        if "interaction_constraints" in extra:
            groups = [set(g) for g in T15_GROUPS]
            for t in trees:
                for seen in paths_features(t):
                    check(any(seen <= g for g in groups),
                          f"{name}: a path splits on {sorted(seen)}, in no "
                          "one group")
        if "forcedsplits_filename" in extra:
            lr = bst._booster.learner
            for t in trees:
                check(t.split_feature[:4] == T15_FORCED_BFS,
                      f"{name}: first nodes {t.split_feature[:4]} != the "
                      f"JSON's {T15_FORCED_BFS}")
            want = [lr._forced_bin(n)[1] for n in (
                T15_FORCED, T15_FORCED["left"], T15_FORCED["right"],
                T15_FORCED["left"]["left"])]
            check(all(t.threshold_bin[:4] == want for t in trees),
                  f"{name}: forced thresholds != the JSON's bins {want}")
        if tag in ("a", "h"):
            again = lgt.train(params, t3["train"], OPTION_ROUNDS,
                              valid_sets=[t3["valid"]])
            check(again.model_to_string() == bst.model_to_string(),
                  f"{name}: a rerun grew different trees")
        tree_phases(bst, smi, name)
        serve_trained_phase(bst, t3["Xva"], dev, smi, tag=name)
        print(f"{name} [{what}]: {len(trees)} trees of "
              f"{[t.num_leaves for t in trees]} leaves; host syncs in the "
              f"last tree {syncs}; {'K2' if 'use_quantized_grad' in extra else 'K1'}"
              f" launches {used} == histograms built; valid logloss "
              f"{ll[0]:.5f} -> {ll[-1]:.5f}"
              f"{'; rerun bit-identical' if tag in ('a', 'h') else ''}; "
              f"{wall:.1f} s [{smi}]")
        out[tag] = {"walls": [r["wall"] for r in probe.rounds],
                    "syncs": syncs}
    return out


def options_card_vs_cpu_phase(smi: str) -> None:
    """T15b: (a)-(h) at 16,000 x 20 on the card and on the CPU, then the
    non-finite guard on the card."""
    import tempfile
    import lambdagap_tpu_torch as lgt
    from lambdagap_tpu_torch.guard.nonfinite import NonFiniteError
    rng = np.random.RandomState(0)
    X = rng.randn(20_000, 20)
    y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + 0.3 * rng.randn(20_000) > 0
         ).astype(np.float64)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_forced_")
    forced_path = os.path.join(tmp, "forced.json")
    with open(forced_path, "w") as fh:
        json.dump(T15_FORCED, fh)
    base = {"objective": "binary", "metric": ["auc", "binary_logloss"],
            "num_leaves": 31, "learning_rate": 0.1, "verbose": -1}
    mono = {0: 1, 5: 1, 9: -1, 13: -1}
    groups = [list(range(g, g + 5)) for g in (0, 5, 10, 15)]
    with CpuSide() as cpu:
        runs = [(tag, what, card_vs_cpu(cpu, {**base, **extra}, X[:16_000],
                                        y[:16_000], X[16_000:], y[16_000:],
                                        OPTION_CPU_ROUNDS))
                for tag, what, extra in option_variants(
                    20, forced_path, mono, groups, T15_HALVED)]
        outs = [(tag, what, finish()) for tag, what, finish in runs]
    for tag, what, out in outs:
        (pc, bc, ac, sc, _), (pp, _, _, sp, _) = out["cuda"], out["cpu"]
        print(f"T15b card == CPU [({tag}) {what}]: predictions max |diff| "
              f"{np.abs(pc - pp).max():.3g}, best_iteration {bc}, valid AUC "
              f"{ac:.5f}; train {sc:.1f} s on the card, {sp:.1f} s on the "
              f"CPU [{smi}]")
    # the non-finite guard on the card (regression: a NaN label is a NaN
    # gradient; the binary objective refuses it at construction)
    reg = {"objective": "regression", "num_leaves": 31, "verbose": -1}
    yn = X[:16_000, 0] + 0.5 * X[:16_000, 1] * X[:16_000, 2]
    yn[[7, 700, 7000]] = np.nan
    try:
        lgt.train(reg, lgt.Dataset(X[:16_000], label=yn), 3)
        fail("T15b: a NaN label trained on under guard_nonfinite=raise")
    except NonFiniteError as e:
        print(f"T15b guard raise: NonFiniteError ({e})")
    prng_ = np.random.RandomState(3)
    Xp = prng_.randn(1000, 6)
    yp = np.exp(Xp[:, 0] * 2 + Xp[:, 1]) * prng_.poisson(1.0, 1000)
    pp_ = {"objective": "poisson", "num_leaves": 7, "learning_rate": 2.9,
           "min_data_in_leaf": 5, "verbose": -1,
           "guard_nonfinite": "skip_tree"}
    kept = {}
    for device in ("cuda", "cpu"):
        b = lgt.train({**pp_, "device_type": device},
                      lgt.Dataset(Xp, label=yp), 5)
        kept[device] = (len(b._booster.models), b.predict(Xp, raw_score=True))
    check(kept["cuda"][0] == kept["cpu"][0] == 1,
          f"T15b skip_tree kept {kept['cuda'][0]} trees on the card, "
          f"{kept['cpu'][0]} on the CPU (want round 0's one)")
    check(np.isfinite(kept["cuda"][1]).all()
          and np.allclose(kept["cuda"][1], kept["cpu"][1], rtol=1e-4,
                          atol=1e-5), "T15b skip_tree: card != CPU")
    b = lgt.train({**reg, "guard_nonfinite": "clip"},
                  lgt.Dataset(X[:16_000], label=yn), 3)
    pc = b.predict(X[16_000:])
    check(np.isfinite(pc).all() and len(b._booster.models) == 3,
          "T15b clip: not a finite 3-tree model")
    print(f"T15b guard skip_tree: the poisson run kept round 0's tree of 5 "
          f"rounds on the card and on the CPU (its exp overflows from round "
          f"1), card == CPU; clip: NaN labels trained to a finite 3-tree "
          f"model [{smi}]")


def options_phases(t3: dict, dev, smi: str) -> dict:
    t0 = time.perf_counter()
    t15 = options_phase(t3, dev, smi)
    print(f"T15: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    options_card_vs_cpu_phase(smi)
    print(f"T15b: {time.perf_counter() - t0:.1f} s")
    return t15


# ---------------------------------------------------------------------------
# T16-T16b: the host-driven serial learner at HIGGS width; card against CPU
# ---------------------------------------------------------------------------
SERIAL_ROUNDS = 2                 # T16 (cut from 3: the script's time)
SERIAL_CPU_ROUNDS = 8           # T16b: early_stopping(5) can fire (cut from 10 for T20)
# eight features with a coupled cost, six of them ones the label depends on
T16_COUPLED = (1, 2, 3, 4, 5, 9, 13, 17)
# (r)'s split penalty, paid a row of the split leaf: (c)'s 0.1 a row
# outweighs every split below the root at 10.5M rows (2-leaf trees); at
# 0.001 the CPU grew 20-23 leaves a tree at 1M rows of T3's data
T16_SPLIT_PER_ROW = 0.001


def serial_variants(f: int, mono: dict) -> list:
    """(tag, what, params) of T16's variants (s), (c), (r), (l), (v) at
    ``f`` features, all on ``tpu_fused_learner=0``."""
    lazy = [0.01 * (1 + j % 5) for j in range(f)]
    coupled = [1e6 if j in T16_COUPLED else 0.0 for j in range(f)]
    return [
        ("s", "tpu_fused_learner=0", {}),
        ("c", "CEGB: split 0.1, coupled on 8 features",
         {"cegb_tradeoff": 1.0, "cegb_penalty_split": 0.1,
          "cegb_penalty_feature_coupled": coupled}),
        ("r", "CEGB: split 0.001, coupled on 8 features",
         {"cegb_tradeoff": 1.0, "cegb_penalty_split": T16_SPLIT_PER_ROW,
          "cegb_penalty_feature_coupled": coupled}),
        ("l", "lazy CEGB + bagging 0.8/1",
         {"cegb_penalty_feature_lazy": lazy, "bagging_fraction": 0.8,
          "bagging_freq": 1}),
        ("v", "monotone advanced",
         {"monotone_constraints": [mono.get(j, 0) for j in range(f)],
          "monotone_constraints_method": "advanced"}),
    ]


def serial_phase(t3: dict, dev, smi: str) -> dict:
    """T16: the serial learner on T3's Datasets at HIGGS width, 2 rounds
    of each variant, the counts zeroed just before each run and read just
    after."""
    import lambdagap_tpu_torch as lgt
    Xva = t3["Xva"]
    Xs = np.ascontiguousarray(Xva[:1000])
    out, feats = {}, {}
    for tag, what, extra in serial_variants(F, T15_MONO):
        name = f"T16({tag})"
        params = {**t3["params"], "tpu_fused_learner": "0", **extra}
        t0 = time.perf_counter()
        bst, hist, probe, used = probed_train(params, t3["train"],
                                              t3["valid"], SERIAL_ROUNDS,
                                              f"{name} [{what}]", smi)
        wall = time.perf_counter() - t0
        gb = bst._booster
        check(gb.serial, f"{name}: did not train on the serial learner")
        ll = hist["binary_logloss"]
        check(ll[-1] < ll[0], f"{name}: valid logloss did not fall: "
              f"{ll[0]} -> {ll[-1]}")
        trees = gb.host_models
        syncs = gb.learner.host_syncs
        feats[tag] = {f for t in trees for f in t.split_feature}
        notes = []
        if tag == "s":
            # the same trees as the fused learner's: T3's model at 2 rounds
            got = bst.predict(Xva)
            want = t3["bst"].predict(Xva, num_iteration=SERIAL_ROUNDS)
            d = float(np.abs(got - want).max())
            check(np.allclose(got, want, rtol=1e-4, atol=1e-5),
                  f"{name}: validation predictions part from the fused "
                  f"learner's T3 model (max |diff| {d})")
            notes.append(f"validation predictions == T3's fused model at "
                         f"{SERIAL_ROUNDS} rounds (max |diff| {d:.3g})")
        if tag in ("c", "r"):
            check(len(feats[tag]) < len(feats["s"]),
                  f"{name}: {len(feats[tag])} distinct features, not fewer "
                  f"than (s)'s {len(feats['s'])}")
            check(not feats[tag] & set(T16_COUPLED),
                  f"{name}: split on a coupled feature "
                  f"{sorted(feats[tag] & set(T16_COUPLED))}")
            notes.append(f"{len(feats[tag])} distinct features, (s) "
                         f"{len(feats['s'])}, none of the coupled 8")
        if tag == "r":
            # the coupled cost keeps out features (s) splits on, and the
            # split penalty stops trees short of num_leaves but past stumps
            check(bool(feats["s"] & set(T16_COUPLED)),
                  f"{name}: (s) used none of the coupled 8")
            sizes = [t.num_leaves for t in trees]
            check(all(2 < n < LEAVES for n in sizes),
                  f"{name}: trees of {sizes} leaves, not between 3 and "
                  f"{LEAVES - 1}")
        if tag == "l":
            check(bool(gb.learner._paid.any()), f"{name}: no row paid")
        if tag == "v":
            check_monotone(bst, Xs, T15_MONO, name)
            notes.append("monotone along every sweep")
        if tag in ("l", "v"):
            again = lgt.train(params, t3["train"], SERIAL_ROUNDS,
                              valid_sets=[t3["valid"]])
            check(again.model_to_string() == bst.model_to_string(),
                  f"{name}: a rerun grew different trees")
            notes.append("rerun bit-identical")
        tree_phases(bst, smi, name)
        serve_trained_phase(bst, Xva, dev, smi, tag=name)
        print(f"{name} [{what}]: {len(trees)} trees of "
              f"{[t.num_leaves for t in trees]} leaves; host syncs in the "
              f"last tree {syncs}; K1 launches {used} == histograms built; "
              f"valid logloss {ll[0]:.5f} -> {ll[-1]:.5f}; "
              + "; ".join(notes) + f"; {wall:.1f} s [{smi}]")
        out[tag] = {"walls": [r["wall"] for r in probe.rounds],
                    "syncs": syncs, "launches": used}
    return out


def serial_card_vs_cpu_phase(smi: str) -> None:
    """T16b: (s), (c), (r), (l), (v), softmax and regression_l1 on the
    serial learner at 16,000 x 20, 31 leaves, 8 rounds, on the card and
    on the CPU."""
    rng = np.random.RandomState(0)
    X = rng.randn(20_000, 20)
    z = X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + 0.3 * rng.randn(20_000)
    y = (z > 0).astype(np.float64)
    base = {"objective": "binary", "metric": ["auc", "binary_logloss"],
            "num_leaves": 31, "learning_rate": 0.1, "verbose": -1,
            "tpu_fused_learner": "0"}
    runs = [(f"({tag}) {what}", {**base, **extra}, y, "auc")
            for tag, what, extra in serial_variants(20, T15_MONO)]
    runs += [
        ("softmax (3 classes)", {**base, "objective": "multiclass",
                                 "num_class": 3, "metric": "multi_logloss"},
         np.digitize(z, np.quantile(z, [1 / 3, 2 / 3])).astype(float),
         "multi_logloss"),
        ("regression_l1", {**base, "objective": "regression_l1",
                           "metric": "l1"}, 10 * z + 50, "l1")]
    with CpuSide() as cpu:
        pairs = [(what, metric, card_vs_cpu(
            cpu, params, X[:16_000], label[:16_000], X[16_000:],
            label[16_000:], SERIAL_CPU_ROUNDS, metric))
            for what, params, label, metric in runs]
        outs = [(what, metric, finish()) for what, metric, finish in pairs]
    for what, metric, out in outs:
        (pc, bc, mc, sc, b), (pp, _, _, sp, _) = out["cuda"], out["cpu"]
        check(b._booster.serial, f"T16b {what}: not the serial learner")
        print(f"T16b card == CPU [{what}]: predictions max |diff| "
              f"{np.abs(pc - pp).max():.3g}, best_iteration {bc}, valid "
              f"{metric} {mc:.5f}; trees of "
              f"{[t.num_leaves for t in b._booster.host_models]} leaves; "
              f"train {sc:.1f} s on the card, {sp:.1f} s on the CPU [{smi}]")


def serial_phases(t3: dict, dev, smi: str) -> dict:
    t0 = time.perf_counter()
    t16 = serial_phase(t3, dev, smi)
    print(f"T16: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    serial_card_vs_cpu_phase(smi)
    print(f"T16b: {time.perf_counter() - t0:.1f} s")
    return t16


# ---------------------------------------------------------------------------
# T17: tree_layout=sorted against gather; K1 and K2 in window mode
# ---------------------------------------------------------------------------
def _model_text(bst) -> str:
    """The model text without the layout's own parameter line."""
    return "\n".join(ln for ln in bst.model_to_string().splitlines()
                     if not ln.startswith("[tree_layout:"))


def layout_run(params: dict, tr, rounds: int, tag: str, smi: str) -> dict:
    """One T17 training (no validation set): the counts zeroed just before
    and read just after; the kernel's launches == the histograms built
    (each round's one tree's), under sorted every one a window launch;
    then one more tree with CUDA events around its phases."""
    import torch
    import lambdagap_tpu_torch as lgt
    from lambdagap_tpu_torch.ops import hist_cuda as hc
    counters = (hc.HIST_LAUNCHES, hc.HIST_Q_LAUNCHES,
                hc.HIST_WINDOW_LAUNCHES, hc.HIST_Q_WINDOW_LAUNCHES)
    walls, built = [], []
    last = [0.0]

    def per_round(env) -> None:
        now = time.perf_counter()
        walls.append((now - last[0]) * 1e3)
        last[0] = now
        built.append(env.model._booster.learner.hist_builds)

    torch.cuda.synchronize()
    for c in counters:
        c.reset()
    last[0] = time.perf_counter()
    bst = lgt.train(params, tr, rounds, callbacks=[per_round])
    torch.cuda.synchronize()
    k1, k2, w1, w2 = (c.launches for c in counters)
    gb = bst._booster
    lr = gb.learner
    quant = bool(params.get("use_quantized_grad")) and not gb.serial
    used, other, window = (k2, k1, w2) if quant else (k1, k2, w1)
    layout = params["tree_layout"]
    check(lr.layout == layout, f"{tag}: trained {lr.layout}")
    check(gb.scores.is_cuda and lr.x_rows.is_cuda, f"{tag}: not on the card")
    check(used > 0 and used == sum(built), f"{tag}: {'K2' if quant else 'K1'}"
          f" launches {used} != histograms built {sum(built)}")
    check(other == 0, f"{tag}: launched the other kernel {other} times")
    if layout == "sorted":
        check(window == used, f"{tag}: {window} window launches of {used}")
        check(not hasattr(lr.row_layout, "x_cols"),
              f"{tag}: holds a column-major copy")
    lr.time_phases = True
    grad, hess = gb.boosting()
    grad, hess, mask = gb.sample_strategy.sample(gb.iter_, grad, hess)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    (lr.train if gb.serial else lr.train_device)(grad[0], hess[0], mask)
    torch.cuda.synchronize()
    tree_ms = (time.perf_counter() - t1) * 1e3
    lr.time_phases = False
    ph = dict(lr.phase_ms)
    print(f"{tag}: rounds (ms) {', '.join(f'{w:.1f}' for w in walls)}, "
          f"median {statistics.median(walls):.1f}; {'K2' if quant else 'K1'}"
          f" launches {used} == histograms built, {window} without a row "
          f"list; one more tree {tree_ms:.1f} ms host wall, device-stream "
          f"layout_apply {ph.get('layout_apply', 0):.2f} ms, partition "
          f"{ph.get('partition', 0):.1f} ms, histogram "
          f"{ph.get('histogram', 0):.1f} ms, split scan "
          f"{ph.get('split_scan', 0):.1f} ms; resident "
          f"{lr.resident_bytes() / 1e9:.3f} GB [{smi}]")
    out = {"text": _model_text(bst), "walls": walls,
           "median": statistics.median(walls), "window": window,
           "tree_ms": tree_ms, "phases": ph}
    del bst, gb, lr, grad, hess, mask
    torch.cuda.empty_cache()
    return out


def layout_phase(t3: dict, t8: dict, smi: str) -> dict:
    """T17 (a)-(d): each variant under explicit gather, then sorted; the
    model texts byte-equal. Returns the sorted runs' window launches of K1
    and K2 and every run's numbers."""
    quant = {"use_quantized_grad": True, "num_grad_quant_bins": 4,
             "bagging_fraction": 0.7, "bagging_freq": 1}
    variants = [("a", "f32 fused", t3, {}, LAYOUT_ROUNDS),
                ("b", "quantized 4 levels + bagging 0.7/1 (K2)", t3, quant,
                 LAYOUT_ROUNDS),
                ("c", "tpu_fused_learner=0", t3, {"tpu_fused_learner": "0"},
                 LAYOUT_ROUNDS),
                ("d", "lambdarank ndcg at MSLR width", t8, {},
                 LAYOUT_RANK_ROUNDS)]
    out = {"k1_window": 0, "k2_window": 0}
    for tag, what, base, extra, rounds in variants:
        runs = {}
        for layout in ("gather", "sorted"):
            params = {**base["params"], **extra, "tree_layout": layout}
            runs[layout] = layout_run(params, base["train"], rounds,
                                      f"T17({tag}) [{what}, {layout}]", smi)
        g, srt = runs["gather"], runs["sorted"]
        check(srt["text"] == g["text"], f"T17({tag}): the sorted model text "
              "differs from gather's")
        out["k2_window" if tag == "b" else "k1_window"] += srt["window"]
        print(f"T17({tag}) [{what}]: model text byte-equal under gather and "
              f"sorted; median round {g['median']:.1f} -> "
              f"{srt['median']:.1f} ms, partition "
              f"{g['phases'].get('partition', 0):.1f} -> "
              f"{srt['phases'].get('partition', 0):.1f} ms, histogram "
              f"{g['phases'].get('histogram', 0):.1f} -> "
              f"{srt['phases'].get('histogram', 0):.1f} ms, layout_apply "
              f"{srt['phases'].get('layout_apply', 0):.2f} ms a tree "
              f"(gather -> sorted) [{smi}]")
        out[tag] = runs
    return out


def hist_window_phase(dev, seed: int, smi: str) -> dict:
    """T17's kernels: K1 (no mask) and K2 (bagging mask 0.8) in window
    mode at T3's 41,176-row leaf, the right child at its offset in its
    parent's window of leaf-ordered copies of HIGGS-width rows, the next
    leaf's rows past it: ``torch.equal`` to the plain version, to a rerun
    and to the same leaf gathered through the permutation; the window
    timed beside the gathered leaf, the plain version and ``index_add_``
    over the contiguous window, with its bound."""
    import torch
    from lambdagap_tpu_torch.ops import hist_cuda as hc
    gen = torch.Generator(device=dev).manual_seed(seed)
    N, nb = HIGGS_ROWS, 256
    bins = torch.randint(0, MAX_BIN, (N, F), generator=gen, device=dev,
                         dtype=torch.uint8)
    grad = torch.randn(N, generator=gen, device=dev)
    hess = torch.rand(N, generator=gen, device=dev) * 0.25
    gq = torch.randint(-2, 3, (N,), generator=gen, device=dev,
                       dtype=torch.int8)
    hq = torch.randint(0, 5, (N,), generator=gen, device=dev,
                       dtype=torch.int8)
    bag = torch.rand(N, generator=gen, device=dev) < 0.8
    perm = torch.randperm(N, generator=gen, device=dev).int()
    p = perm.long()
    xs, gs, hs, gqs, hqs, ms = (t[p].contiguous() for t in (bins, grad, hess,
                                                           gq, hq, bag))
    leaf = N // 255
    begin, off = 1_003, leaf + 3        # the parent's window; its right child
    w = slice(begin, begin + off + leaf + 5)
    live = slice(begin + off, begin + off + leaf)
    scale = hc.hist_scale(grad, hess)
    cases = {
        "K1": (hc.hist_rows, hc._hist_reference,
               (xs[w], gs[w], hs[w], None, one(dev, leaf), nb, None,
                one(dev, off), scale),
               (bins, grad, hess, perm[w], one(dev, leaf), nb, None,
                one(dev, off), scale),
               (xs[live], gs[live], hs[live], None, leaf, nb, None), 8, 5),
        "K2": (hc.hist_rows_q, hc._hist_q_reference,
               (xs[w], gqs[w], hqs[w], None, one(dev, leaf), nb, ms[w],
                one(dev, off)),
               (bins, gq, hq, perm[w], one(dev, leaf), nb, bag,
                one(dev, off)),
               (xs[live], gqs[live], hqs[live], None, leaf, nb, ms[live]),
               2, 2)}
    out = {}
    for name, (kernel, plain, args, gathered, lib_args, chan_bytes,
               int_ops) in cases.items():
        got = kernel(*args)
        again = kernel(*args)
        ref = plain(*args)
        via_perm = kernel(*gathered)
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"{name} window: rerun differs")
        check(torch.equal(got, ref), f"{name} window != plain: "
              f"{int((got != ref).sum())} entries differ")
        check(torch.equal(got, via_perm), f"{name} window != the same leaf "
              "gathered through the permutation")
        inbag = leaf if args[6] is None else int(ms[live].sum())
        check(int(got[..., 2].long().sum()) == inbag * F,
              f"{name} window counted rows wrongly")
        k_ms = cuda_ms(lambda: kernel(*args))
        g_ms = cuda_ms(lambda: kernel(*gathered))
        p_ms = cuda_ms(lambda: plain(*args), reps=3, warm=1)
        lib = index_add_call(*lib_args)
        l_ms = cuda_ms(lib, reps=5, warm=1)
        del lib
        bound, by, nbytes = hist_bound(xs[live], None, leaf, nb, args[6],
                                       chan_bytes, int_ops)
        print(f"{name} window == plain [T3's {leaf}-row leaf at offset "
              f"{off} in its parent's window at position {begin}, the next "
              f"leaf's rows past it"
              f"{', bagging mask 0.8' if args[6] is not None else ''}]: "
              f"torch.equal, rerun bit-identical, == the leaf gathered "
              f"through the permutation; window {k_ms:.4f} ms, gathered "
              f"{g_ms:.4f} ms, plain {p_ms:.3f} ms, index_add_ over the "
              f"window {l_ms:.4f} ms, bound {bound:.4f} ms ({by}: "
              f"{nbytes / 1e6:.1f} MB) [{smi}]")
        out[name] = {"ms": k_ms, "gathered_ms": g_ms, "plain_ms": p_ms,
                     "library_ms": l_ms, "bound_ms": bound, "bound_by": by,
                     "max_abs_err": float((got.double()
                                           - ref.double()).abs().max())}
    del bins, grad, hess, gq, hq, bag, perm, p, xs, gs, hs, gqs, hqs, ms
    torch.cuda.empty_cache()
    return out


def layout_phases(t3: dict, t8: dict, dev, seed: int, smi: str) -> dict:
    t0 = time.perf_counter()
    t17 = layout_phase(t3, t8, smi)
    t17["kernels"] = hist_window_phase(dev, seed, smi)
    print(f"T17: {time.perf_counter() - t0:.1f} s")
    return t17


# ---------------------------------------------------------------------------
# T18: the multi-model registry, hot swap, delta swap, the swap breaker and
# cross-model packing (the fused kernel's packed mode)
# ---------------------------------------------------------------------------
REG_REQUESTS = 240              # T18 (a): mixed requests over the members
REG_SWAPS = 6                   # T18 (c): swaps of default under load (cut from 10 for T20)
REG_BASE_TREES = 400            # T18 (c)-(d): the delta's base
PACK_ROWS = 4096                # T18 (e): the packed launch timed


def registry_members(seed: int, text: str, params: dict) -> dict:
    """T18's members on the card as (Booster, features, rows maker):
    ``default`` phase 3's forest from its text; a 300-tree 3-class forest
    at HIGGS width; the 70-category forest with hostile rows; a 200 x 63
    regression forest at MSLR-WEB30K's 136 columns."""
    import lambdagap_tpu_torch as lgt
    from lambdagap_tpu_torch.convert import booster_from_numpy
    from lambdagap_tpu_torch.models import synth

    def booster(trees, feats, objective):
        return booster_from_numpy(synth.header(feats, objective), trees,
                                  params)
    return {
        "default": (lgt.Booster(model_str=text, params=params), F,
                    synth.random_rows),
        "multiclass": (booster(synth.random_trees(seed + 3, 300, LEAVES, F,
                                                  GRID), F,
                               "multiclass num_class:3"), F,
                       synth.random_rows),
        "categorical": (booster(synth.categorical_trees(
            seed + 1, num_features=6), 6, "binary sigmoid:1"), 6,
            synth.hostile_rows),
        "mslr": (booster(synth.random_trees(seed + 19, 200, 63, MSLR_F,
                                            GRID), MSLR_F, "regression"),
                 MSLR_F, synth.random_rows),
    }


def scan_oracle(gb, X: np.ndarray, dev, trees: Optional[int] = None):
    """Raw scores of the first ``trees`` trees of ``gb`` on the card
    through the scan engine: [N] for one class, [N, K] for more."""
    import torch
    from lambdagap_tpu_torch.ops.predict import (forest_to_arrays,
                                                 predict_forest)
    models = gb.models[:trees]
    K = gb.num_tree_per_iteration
    forest, depth = forest_to_arrays(models, device=dev)
    out = predict_forest(torch.from_numpy(X).to(dev), forest,
                         [i % K for i in range(len(models))], K, depth,
                         has_linear=any(t.is_linear for t in models)
                         ).cpu().numpy()
    return out[0] if K == 1 else out.T


def model_burst(server, data: dict, plan, clients: int = 4):
    """Submit every (model, offset, rows) request of ``plan`` from
    ``clients`` threads at once; returns (results in plan order, seconds).
    No request may fail."""
    answers = [None] * len(plan)
    errors = []

    def client(tid: int) -> None:
        futs = []
        for i in range(tid, len(plan), clients):
            name, lo, n = plan[i]
            futs.append((i, server.submit(data[name][lo:lo + n],
                                          model=name)))
        for i, f in futs:
            try:
                answers[i] = f.result(timeout=300)
            except Exception as e:  # noqa: BLE001 — reported, fails below
                errors.append(f"request {i}: {e!r}")
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(k,))
               for k in range(clients)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(600)
    seconds = time.perf_counter() - t0
    check(not any(th.is_alive() for th in threads), "T18 clients hung")
    check(not errors, "T18: " + "; ".join(errors[:3]))
    return answers, seconds


def check_model_answers(tag: str, answers, plan, oracle: dict) -> None:
    for i, ((name, lo, n), res) in enumerate(zip(plan, answers)):
        want = oracle[name][lo:lo + n]
        check(res.values.shape == want.shape and
              np.array_equal(res.values, want),
              f"{tag}: request {i} ({n} rows of {name!r}) != its scan oracle")


def packed_bound(xt, packed, cfs: dict, rows_of: dict, steps: int):
    """The packed launch's bound, on ``fused_bound``'s yardstick: the rows,
    every member's tables once (the artifact's node tables, the leaf table,
    the CSR, the classes and the member maps), the row map and the scores,
    each once (not the carry nor the workspace, which stay on the chip's
    side of the bound); one f32 operation per decision step of each row's
    own member and per add of its own trees. Also returns the bytes of the
    [T, R] f32 workspace, printed beside the bound."""
    import torch
    R = xt.shape[0]
    t = packed.tables
    nbytes = xt.numel() * 4 + sum(int(a.nbytes) for a in
                                  t.artifact_tables()
                                  if isinstance(a, torch.Tensor))
    nbytes += sum(int(a.nbytes) for a in (
        packed._leaf_value, t.group_tree_lo, t.group_tree,
        packed._tree_class, packed._group_model))
    nbytes += R * 4 + packed.num_class * R * 4
    adds = sum(len(rows_of[n]) * cf.num_trees for n, cf in cfs.items())
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = (steps + adds) / H100_F32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes, packed.num_trees * R * 4)


def registry_phase(seed: int, dev, smi: str, text: str) -> dict:
    """T18 (a)-(e); returns the packed kernel's numbers for the kernels
    line."""
    import torch
    import lambdagap_tpu_torch as lgt
    from lambdagap_tpu_torch.guard.degrade import SwapFailed, SwapRejected
    from lambdagap_tpu_torch.infer import engine as eng
    from lambdagap_tpu_torch.serve import delta
    t_phase = time.perf_counter()
    # (a)'s server swaps in (c)-(d): its breaker opens after 2 failures
    members = registry_members(seed, text, {"predict_engine": "compiled",
                                            "serve_swap_breaker": 2})
    names = list(members)
    rng = np.random.RandomState(seed + 18)
    data = {n: np.ascontiguousarray(make(rng, 20000, feats))
            for n, (_b, feats, make) in members.items()}
    boosters = {n: b for n, (b, _f, _m) in members.items()}
    oracle = {n: scan_oracle(b._booster, data[n], dev)
              for n, b in boosters.items()}
    for n in names:
        check(np.all(np.isfinite(oracle[n])), f"T18: {n} oracle not finite")
    print(f"T18 members, rows and scan oracles: "
          f"{time.perf_counter() - t_phase:.1f} s")

    # (a) four models behind one registry, 240 mixed requests, 4 threads
    t0 = time.perf_counter()
    plan = [(names[i % 4], (i * 977) % (20000 - SIZES[i % len(SIZES)]),
             SIZES[i % len(SIZES)]) for i in range(REG_REQUESTS)]
    with Dispatches() as da:
        server = boosters["default"].as_server(raw_score=True)
        for n in names[1:]:
            server.add_model(n, boosters[n])
        answers, secs = model_burst(server, data, plan)
        snap = server.stats_snapshot()
    da.check("T18 (a)")
    check_model_answers("T18 (a)", answers, plan, oracle)
    check(snap["requests"] == REG_REQUESTS and
          snap["registry"]["resident_models"] == 4, "T18 (a): stats")
    sizes = {n: server.registry.entry(n).bytes for n in names}
    artifacts = {n: server.artifact_bytes(n) for n in names}
    print(f"T18 (a) registry: {REG_REQUESTS} requests of 1-4096 rows over "
          f"{len(names)} models ({', '.join(f'{n} {sizes[n] / 1e6:.2f} MB' for n in names)}) "
          f"from 4 threads in {secs:.2f} s, each == its scan oracle; "
          f"{da.line()} ({time.perf_counter() - t0:.1f} s) [{smi}]")

    # (b) the budget fits any two members: round-robin traffic evicts and
    # re-admits (the artifacts admitted from (a): no second compile)
    t0 = time.perf_counter()
    top2 = sorted(sizes.values())[-2:]
    budget_mb = (sum(top2) + 4096) / (1 << 20)
    check(min(sizes.values()) > 4096 + 1, "T18 (b): a member under 4 KB")
    bst_b = lgt.Booster(model_str=text, params={
        "predict_engine": "compiled", "serve_hbm_budget_mb": budget_mb})
    with bst_b.as_server(raw_score=True, buckets=(8, 64)) as srv:
        for n in names[1:]:
            srv.admit_artifact(artifacts[n])
        for n in names[1:]:
            srv.add_model(n, boosters[n])
        rr = [(names[i % 4], 64 * i, 64) for i in range(8)]
        got = [srv.submit(data[n][lo:lo + k], model=n).result(300)
               for n, lo, k in rr]
        snapb = srv.stats_snapshot()
    check_model_answers("T18 (b)", got, rr, oracle)
    reg = snapb["registry"]
    check(snapb["evictions"] > 0 and snapb["readmissions"] > 0,
          f"T18 (b): {snapb['evictions']} evictions, "
          f"{snapb['readmissions']} readmissions")
    check(all(m["generation"] == 0 for m in reg["models"].values()) and
          all(r.generation == 0 for r in got), "T18 (b): a generation moved")
    check(reg["hbm_bytes_resident"] <= reg["hbm_budget_bytes"],
          "T18 (b): resident bytes over the budget")
    print(f"T18 (b) budget {reg['hbm_budget_bytes']} bytes (two members): "
          f"8 round-robin requests, each == its oracle; "
          f"{snapb['evictions']} evictions, {snapb['readmissions']} "
          f"readmissions, generations 0, resident "
          f"{reg['hbm_bytes_resident']} bytes; compiles local "
          f"{snapb['cache']['compiles_local']} shared "
          f"{snapb['cache']['compiles_shared']} "
          f"({time.perf_counter() - t0:.1f} s) [{smi}]")

    # (c) on (a)'s server: 6 swaps of default between the full forest and
    # its first 400 trees while 4 threads submit; (d) the delta swap back
    # to the full forest, a stale delta, the breaker
    t0 = time.perf_counter()
    srv = server
    gb = boosters["default"]._booster
    base_bst = lgt.Booster(model_str=gb.save_model_to_string(
        num_iteration=REG_BASE_TREES), params={"predict_engine": "compiled"})
    xd = data["default"]
    swap_oracle = [oracle["default"],
                   scan_oracle(gb, xd, dev, trees=REG_BASE_TREES)]
    check(not np.array_equal(swap_oracle[0], swap_oracle[1]),
          "T18 (c): the two forests score alike")
    stop = threading.Event()
    served, bad, errors = [0] * 4, [], []

    def client(tid: int) -> None:
        crng = np.random.RandomState(seed + 100 + tid)
        while not stop.is_set():
            n = int(crng.choice((1, 7, 64, 512)))
            lo = int(crng.randint(0, len(xd) - n))
            try:
                res = srv.submit(xd[lo:lo + n]).result(timeout=300)
            except Exception as e:  # noqa: BLE001 — reported, fails below
                errors.append(repr(e))
                return
            served[tid] += 1
            if not np.array_equal(res.values,
                                  swap_oracle[res.generation % 2][lo:lo + n]):
                bad.append((tid, lo, n, res.generation))

    threads = [threading.Thread(target=client, args=(k,)) for k in range(4)]
    for th in threads:
        th.start()
    swaps = [base_bst, boosters["default"]]
    swap_s = []
    for g in range(1, REG_SWAPS + 1):
        ts = time.perf_counter()
        check(srv.swap(swaps[(g + 1) % 2]) == g, "T18 (c): swap order")
        swap_s.append(time.perf_counter() - ts)
    stop.set()
    for th in threads:
        th.join(600)
    check(not any(th.is_alive() for th in threads), "T18 (c): clients hung")
    check(not errors, "T18 (c): " + "; ".join(errors[:3]))
    check(not bad, f"T18 (c): {len(bad)} torn answers, first {bad[:2]}")
    check(sum(served) >= 40, f"T18 (c): only {sum(served)} requests served")
    print(f"T18 (c) hot swap: {REG_SWAPS} swaps of default (500 <-> "
          f"{REG_BASE_TREES} trees, median {statistics.median(swap_s):.2f} s "
          f"a swap) under {sum(served)} requests from 4 threads, each == its "
          f"generation's oracle, none failed "
          f"({time.perf_counter() - t0:.1f} s) [{smi}]")

    t0 = time.perf_counter()
    check(srv.swap(base_bst) == REG_SWAPS + 1, "T18 (d): swap to the base")
    frame = delta.make_delta(srv.model_text(), text)
    check(frame is not None, "T18 (d): the full forest extends its base")
    gen = srv.swap_delta(frame)
    check(gen == REG_SWAPS + 2, "T18 (d): delta generation")
    res = srv.submit(xd[:4096]).result(300)
    check(res.generation == gen and
          np.array_equal(res.values, oracle["default"][:4096]),
          "T18 (d): the delta-swapped forest != the full forest's oracle")
    for _ in range(2):
        try:
            srv.swap_delta(frame)             # its base has moved on
            fail("T18 (d): a stale delta swapped")
        except SwapFailed:
            pass
        check(srv.generation == gen, "T18 (d): a failed swap moved on")
    try:
        srv.swap(base_bst)
        fail("T18 (d): the breaker let a swap through")
    except SwapRejected:
        pass
    res = srv.submit(xd[:64]).result(300)
    check(np.array_equal(res.values, oracle["default"][:64]) and
          srv.health.snapshot()["swap_breaker"] == "open",
          "T18 (d): serving after the breaker opened")
    snapd = srv.stats_snapshot()
    srv.close()
    print(f"T18 (d) delta swap: {delta.delta_bytes(frame)} bytes of frame "
          f"against {len(text)} of full text, answers == the full forest's "
          f"oracle; 2 stale deltas SwapFailed at generation {gen}, then "
          f"SwapRejected (breaker {snapd['health']['swap_breaker']}), "
          f"serving on; swaps {snapd['swaps']}, failures "
          f"{snapd['swap_failures']} ({time.perf_counter() - t0:.1f} s) "
          f"[{smi}]")

    # (e) serve_pack_models: a mixed burst through the packed mode, then
    # the packed launch at 4,096 mixed rows against its plain version and
    # each member's own launch
    t0 = time.perf_counter()
    t_e = t0
    bst_e = lgt.Booster(model_str=text, params={
        "predict_engine": "compiled", "serve_pack_models": True})
    srv = bst_e.as_server(raw_score=True)
    for n in names[1:]:
        srv.admit_artifact(artifacts[n])
        srv.add_model(n, boosters[n])
    before = srv.stats_snapshot()["cache"]["packed_dispatches"]
    with Dispatches() as de:
        answers, secs = model_burst(srv, data, plan)
    snape = srv.stats_snapshot()
    packed_n = snape["cache"]["packed_dispatches"] - before
    check_model_answers("T18 (e)", answers, plan, oracle)
    check(de.calls == 0 and de.k3 == 0 and de.acc == 0,
          f"T18 (e): per-model dispatches under packing ({de.line()})")
    check(packed_n > 0 and de.fused == packed_n,
          f"T18 (e): {de.fused} fused launches for {packed_n} packed "
          "dispatches")
    pack = srv._pack
    packed = pack.packed
    print(f"T18 (e) packing: {REG_REQUESTS} mixed requests in {secs:.2f} s, "
          f"each == its oracle; {packed_n} packed dispatches, {de.fused} "
          f"fused launches, none per model; pack of {packed.num_trees} "
          f"trees, width {packed.width}, {pack.hbm_bytes / 1e6:.2f} MB "
          f"({time.perf_counter() - t0:.1f} s) [{smi}]")

    cfs = {n: srv.registry.get(n)._compiled for n in packed.names}
    prng = np.random.RandomState(seed + 181)
    rm = prng.randint(0, len(cfs), PACK_ROWS).astype(np.int32)
    x = np.full((PACK_ROWS, packed.width), np.nan, np.float32)
    rows_of = {}
    for i, n in enumerate(packed.names):
        mine = np.nonzero(rm == i)[0]
        rows_of[n] = mine
        x[mine, :data[n].shape[1]] = data[n][mine]
    xt = torch.from_numpy(x).to(dev)
    rmt = torch.from_numpy(rm).to(dev)
    t = packed.tables

    def launch():
        return eng._predict_forest(xt, t, t.group_tree_lo, t.group_tree,
                                   packed._leaf_value, packed._tree_class,
                                   packed.num_class, 0, 0.0, rmt,
                                   packed._group_model)

    def plain():
        return eng._predict_forest_reference(
            xt, t, t.group_tree_lo, t.group_tree, packed._leaf_value,
            packed._tree_class, packed.num_class, 0, 0.0, rmt,
            packed._group_model)
    got, ref = launch(), plain()
    again = launch()
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    check(torch.equal(got, ref) and torch.equal(again, got),
          f"T18 (e): packed launch != plain ({int((got != ref).sum())} "
          "scores differ) or a rerun moved")
    xs, steps = {}, 0
    for n, cf in cfs.items():
        idx = torch.from_numpy(rows_of[n]).to(dev)
        xs[n] = xt[idx, :cf.width].contiguous()
        solo = cf.predict(xs[n])
        check(torch.equal(got[:cf.num_class, idx], solo) and
              not bool(got[cf.num_class:, idx].any()),
              f"T18 (e): packed rows of {n!r} != its own launch")
        carry = eng.traverse_forest(xs[n], cf.tables)
        steps += steps_taken(cf.artifact, carry.cpu().numpy())
    ms = cuda_ms(launch)
    solo_ms = cuda_ms(lambda: [cfs[n].predict(xs[n]) for n in cfs])
    plain_ms = cuda_ms(plain, reps=3, warm=1)
    bound_ms, bound_by, nbytes, ws_bytes = packed_bound(
        xt, packed, cfs, rows_of, steps)
    print(f"T18 (e) packed launch @{PACK_ROWS} mixed rows x "
          f"{packed.num_trees} trees ({len(cfs)} members, "
          f"{', '.join(f'{n} {len(r)}' for n, r in rows_of.items())} rows): "
          f"{ms:.4f} ms against the members' solo launches {solo_ms:.4f} ms "
          f"(sum, same rows); bound {bound_ms:.4f} ms ({bound_by}: "
          f"{nbytes / 1e6:.2f} MB, {steps} own decision steps; the "
          f"workspace's {ws_bytes / 1e6:.2f} MB would add "
          f"{ws_bytes / H100_BYTES_PER_S * 1e3:.4f} ms); plain "
          f"{plain_ms:.3f} ms; == plain == each solo launch, rerun "
          f"bit-identical ({time.perf_counter() - t_e:.1f} s in (e)) "
          f"[{smi}]")

    # a swap of a packed member rebuilds the pack before it returns: the
    # next mixed batch serves the new forest under its generation
    t0 = time.perf_counter()
    before = srv.stats_snapshot()["cache"]["packed_dispatches"]
    check(srv.swap(base_bst) == 1, "T18 (e): packed swap generation")
    other = names[1]
    got = [srv.submit(xd[:512]), srv.submit(data[other][:64], model=other)]
    got = [f.result(300) for f in got]
    snap_sw = srv.stats_snapshot()
    srv.close()
    check(got[0].generation == 1 and got[1].generation == 0 and
          np.array_equal(got[0].values, swap_oracle[1][:512]) and
          np.array_equal(got[1].values, oracle[other][:64]),
          "T18 (e): after a packed swap, answers != their generation's "
          "oracle")
    check(snap_sw["cache"]["packed_dispatches"] > before and
          snap_sw["errors"] == 0, "T18 (e): the swapped pack did not serve")
    print(f"T18 (e) packed swap of default to {REG_BASE_TREES} trees: the "
          f"pack rebuilt within the swap, the next mixed requests == their "
          f"generations' oracles ({time.perf_counter() - t0:.1f} s) "
          f"[{smi}]")
    print(f"T18: {time.perf_counter() - t_phase:.1f} s")
    return {"launches": de.fused, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "solo_ms": solo_ms}


# ---------------------------------------------------------------------------
# ---------------------------------------------------------------------------
# T19: out of core: stream training on T3's Datasets in host shards,
# predict_stream through the two rings, pred_contrib a window at a time
# ---------------------------------------------------------------------------
def stream_run(params: dict, ds, tag: str, smi: str, streamed: bool,
               rounds: int = STREAM_ROUNDS) -> dict:
    """One T19 (a) training of ``rounds`` rounds (no validation set),
    the counts zeroed just before and read just after. Streamed: every
    histogram from K1's accumulate mode (one finish a histogram, at least
    one window each), no resident K1 launch, no device matrix."""
    import torch
    import lambdagap_tpu_torch as lgt
    from lambdagap_tpu_torch.ops import hist_cuda as hc
    counters = (hc.HIST_LAUNCHES, hc.HIST_Q_LAUNCHES,
                hc.HIST_STREAM_LAUNCHES, hc.HIST_FINISH_LAUNCHES)
    walls, built, syncs = [], [], []
    last = [0.0]

    def per_round(env) -> None:
        now = time.perf_counter()
        walls.append((now - last[0]) * 1e3)
        last[0] = now
        lr_ = env.model._booster.learner
        built.append(lr_.hist_builds)
        syncs.append(lr_.host_syncs)

    torch.cuda.synchronize()
    for c in counters:
        c.reset()
    last[0] = time.perf_counter()
    bst = lgt.train(params, ds, rounds, callbacks=[per_round])
    torch.cuda.synchronize()
    k1, k2, win, fin = (c.launches for c in counters)
    lr = bst._booster.learner
    check(lr.residency == ("stream" if streamed else "hbm"),
          f"{tag}: data_residency resolved to {lr.residency}")
    check(bst._booster.scores.is_cuda, f"{tag}: scores not on the card")
    check(k2 == 0, f"{tag}: launched K2 {k2} times")
    out = {"text": _model_text(bst).split("end of trees")[0],
           "walls": walls, "median": statistics.median(walls),
           "built": built, "syncs": syncs, "windows": win}
    if streamed:
        lay = lr.row_layout
        check(lr.x_rows is None, f"{tag}: holds a device matrix")
        check(k1 == 0, f"{tag}: {k1} resident K1 launches")
        check(fin == sum(built) and win >= fin,
              f"{tag}: {fin} finishes and {win} window launches for "
              f"{sum(built)} histograms")
        ph = lay.clock.snapshot()
        out.update(phases=ph, ring_windows=lay.ring.windows,
                   ring_bytes=lay.ring.bytes)
        print(f"{tag}: rounds (ms) {', '.join(f'{w:.1f}' for w in walls)};"
              f" K1 accumulate-mode launches {win} for {sum(built)} "
              f"histograms (finishes {fin}), no resident K1 launch; ring "
              f"{lay.ring.windows} windows, {lay.ring.bytes / 1e9:.3f} GB "
              f"up; h2d_prefetch {ph.get('h2d_prefetch', 0):.3f} s, "
              f"chunk_wait {ph.get('chunk_wait', 0):.3f} s, host_read "
              f"{ph.get('host_read', 0):.3f} s, host_mirror "
              f"{ph.get('host_mirror', 0):.3f} s; host reads a tree "
              f"{syncs} [{smi}]")
    else:
        check(k1 == sum(built) and win == 0 and fin == 0,
              f"{tag}: K1 launches {k1} != histograms {sum(built)}, or "
              f"accumulate mode launched ({win}, {fin})")
        print(f"{tag}: rounds (ms) {', '.join(f'{w:.1f}' for w in walls)}; "
              f"K1 launches {k1} == histograms; host reads a tree {syncs} "
              f"[{smi}]")
    del bst, lr
    torch.cuda.empty_cache()
    return out


def stream_train_phase(t3: dict, smi: str) -> dict:
    """T19 (a): T3's training set in host shards of 2^20 rows (the last
    ragged); each configuration trained resident and streamed in this
    call, the model texts byte-equal up to ``end of trees``."""
    import lambdagap_tpu_torch as lgt
    t0 = time.perf_counter()
    sds = lgt.ShardedBinnedDataset.from_dataset(t3["train"].construct(),
                                                STREAM_SHARD_ROWS)
    print(f"T19 data: T3's {sds.num_data} x {sds.num_features} bins in "
          f"{sds.num_shards} host shards of {sds.shard_rows} rows (last "
          f"{sds.shards[-1].shape[0]}), {time.perf_counter() - t0:.1f} s")
    goss = {"data_sample_strategy": "goss", "learning_rate": 1.0}
    variants = [("fused gather", {"tree_layout": "gather"}),
                ("fused sorted", {"tree_layout": "sorted"}),
                ("serial", {"tpu_fused_learner": "0"}),
                ("GOSS, compaction on", goss),
                ("GOSS, compaction off", {**goss,
                                          "stream_goss_compact": False})]
    out = {"launches": 0, "runs": {}}
    resident = {}
    for what, extra in variants:
        params = {**t3["params"], **extra}
        rounds = (STREAM_GOSS_ROUNDS if "data_sample_strategy" in extra
                  else STREAM_ROUNDS)
        # compaction changes nothing resident: both GOSS runs share a twin
        key = json.dumps({k: v for k, v in extra.items()
                          if k != "stream_goss_compact"}, sort_keys=True)
        if key not in resident:
            resident[key] = stream_run(
                {**params, "data_residency": "hbm"}, t3["train"],
                f"T19(a) [{what}, resident]", smi, False, rounds)
        res = resident[key]
        st = stream_run(params, lgt.Dataset(sds), f"T19(a) [{what}, "
                        "streamed]", smi, True, rounds)
        check(st["text"] == res["text"], f"T19(a) [{what}]: the streamed "
              "model text differs from the resident one")
        out["launches"] += st["windows"]
        out["runs"][what] = (res, st)
        print(f"T19(a) [{what}]: model text byte-equal streamed and "
              f"resident; median round {res['median']:.1f} -> "
              f"{st['median']:.1f} ms (resident -> streamed; T3's median "
              f"round {t3['median_ms']:.1f} ms) [{smi}]")
    del sds
    return out


def stream_kernel_phase(t3: dict, smi: str) -> dict:
    """``hist_rows@stream``: K1's accumulate mode over T3's root in
    windows of 2^20 rows (already on the card: kernel time, no copies),
    ``torch.equal`` to its plain version and to one resident launch over
    the same rows; timed beside the resident launch, the plain version
    and ``index_add_``, with the root's bound."""
    import torch
    from lambdagap_tpu_torch.ops import hist_cuda as hc
    gb = t3["bst"]._booster
    bins = gb.learner.x_rows
    grad, hess = gb.boosting()
    grad, hess = grad[0].contiguous(), hess[0].contiguous()
    N, nb = bins.shape[0], 256
    scale = hc.hist_scale(grad, hess)
    spans = [(lo, min(lo + STREAM_SHARD_ROWS, N))
             for lo in range(0, N, STREAM_SHARD_ROWS)]
    acc = hc.hist_acc(bins.shape[1], nb, bins.device)

    def streamed():
        for lo, hi in spans:
            hc.hist_rows_add(acc, bins[lo:hi], grad[lo:hi], hess[lo:hi],
                             None, hi - lo, nb, scale)
        return hc.hist_finish(acc, scale)

    def plain():
        a = hc.hist_acc(bins.shape[1], nb, bins.device)
        for lo, hi in spans:
            hc._hist_add_reference(a, bins[lo:hi], grad[lo:hi], hess[lo:hi],
                                   None, hi - lo, nb, None, None, scale)
        return hc._hist_finish_reference(a, scale)

    def resident():
        return hc.hist_rows(bins, grad, hess, None, N, nb, scale=scale)

    got, again, ref, one_ = streamed(), streamed(), plain(), resident()
    torch.cuda.synchronize()
    check(torch.equal(got, again), "hist_rows@stream: rerun differs")
    check(torch.equal(got, ref), f"hist_rows@stream != plain: "
          f"{int((got != ref).sum())} entries differ")
    check(torch.equal(got, one_), "hist_rows@stream != one resident launch "
          "over the same rows")
    s_ms = cuda_ms(streamed)
    r_ms = cuda_ms(resident)
    p_ms = cuda_ms(plain, reps=3, warm=1)
    lib = index_add_call(bins, grad, hess, None, N, nb)
    l_ms = cuda_ms(lib, reps=5, warm=1)
    del lib
    bound, by, nbytes = hist_bound(bins, None, N, nb)
    print(f"hist_rows@stream == plain == one resident launch [T3's root, "
          f"{N} x {bins.shape[1]}, {len(spans)} windows of "
          f"{STREAM_SHARD_ROWS} rows]: streamed root {s_ms:.4f} ms "
          f"({len(spans)} accumulate launches + 1 finish), resident root "
          f"{r_ms:.4f} ms, plain {p_ms:.3f} ms, index_add_ {l_ms:.4f} ms, "
          f"bound {bound:.4f} ms ({by}: {nbytes / 1e6:.1f} MB) [{smi}]")
    out = {"ms": s_ms, "resident_ms": r_ms, "plain_ms": p_ms,
           "library_ms": l_ms, "bound_ms": bound, "bound_by": by,
           "max_abs_err": float((got.double() - ref.double()).abs().max())}
    del acc, grad, hess, got, again, ref, one_
    torch.cuda.empty_cache()
    return out


def predict_stream_phase(t3: dict, smi: str) -> None:
    """T19 (b)-(c): T3's model scores its 500,000 validation rows out of
    core — an ndarray at each window size and ring depth (each window one
    launch of the fused kernel), an ``np.memmap`` into an ``np.memmap``
    out, a binned ShardedBinnedDataset on T3's bins — each
    ``array_equal`` to ``Booster.predict``; then ``pred_contrib`` of
    4,096 rows on kernel S, equal to ``predict(pred_contrib=True)``."""
    import torch
    import lambdagap_tpu_torch as lgt
    from lambdagap_tpu_torch.infer import PREDICT_LAUNCHES
    from lambdagap_tpu_torch.models.shap import TREE_SHAP_LAUNCHES
    bst, Xva = t3["bst"], t3["Xva"]
    cfg = bst._booster.config
    want = bst.predict(Xva, raw_score=True)
    conv = bst.predict(Xva)
    for W in STREAM_WINDOWS:
        for depth in STREAM_DEPTHS:
            cfg.predict_stream_depth = depth
            st = {}
            torch.cuda.synchronize()
            PREDICT_LAUNCHES.reset()
            got = bst.predict_stream(Xva, raw_score=True, window_rows=W,
                                     stats_out=st)
            launches = PREDICT_LAUNCHES.launches
            check(np.array_equal(got, want), f"T19(b): predict_stream at "
                  f"{W} rows, depth {depth} != predict")
            check(launches == st["windows"], f"T19(b): {launches} fused "
                  f"launches for {st['windows']} windows")
            ph = st["phases"]
            print(f"T19(b) [ndarray, window {W}, depth {depth}]: "
                  f"{st['rows']} rows in {st['windows']} windows (buckets "
                  f"{st['buckets']}) == predict, one fused launch a window;"
                  f" {st['rows_per_s']:.0f} rows/s, wall {st['wall_s']:.3f}"
                  f" s; h2d_prefetch {ph['h2d_prefetch']:.4f} s, chunk_wait"
                  f" {ph['chunk_wait']:.4f} s, d2h_scores "
                  f"{ph['d2h_scores']:.4f} s [{smi}]")
    cfg.predict_stream_depth = 0
    here = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "t19")
    os.makedirs(here, exist_ok=True)
    src = np.memmap(os.path.join(here, "valid.f32"), dtype=np.float32,
                    mode="w+", shape=Xva.shape)
    src[:] = Xva
    src.flush()
    out = np.memmap(os.path.join(here, "scores.f32"), dtype=np.float32,
                    mode="w+", shape=(Xva.shape[0],))
    st = {}
    bst.predict_stream(src, window_rows=STREAM_WINDOWS[0], out=out,
                       stats_out=st)
    check(np.array_equal(np.asarray(out), conv),
          "T19(b): the memmap source's converted scores != predict")
    print(f"T19(b) [np.memmap in, np.memmap out, converted]: == predict; "
          f"{st['rows_per_s']:.0f} rows/s [{smi}]")
    del src, out
    sv = lgt.ShardedBinnedDataset.from_dataset(t3["valid"].construct(),
                                               STREAM_SHARD_ROWS)
    st = {}
    got = bst.predict_stream(sv, raw_score=True,
                             window_rows=STREAM_WINDOWS[0], stats_out=st)
    check(np.array_equal(got, want),
          "T19(b): the binned source's scores != predict")
    print(f"T19(b) [ShardedBinnedDataset on T3's bins, tensor engine]: == "
          f"predict; {st['rows_per_s']:.0f} rows/s [{smi}]")
    sub = np.ascontiguousarray(Xva[:STREAM_CONTRIB_ROWS])
    ref = bst.predict(sub, pred_contrib=True)
    TREE_SHAP_LAUNCHES.reset()
    st = {}
    got = bst.predict_stream(sub, pred_contrib=True, window_rows=1024,
                             stats_out=st)
    check(TREE_SHAP_LAUNCHES.launches == st["windows"] == 4,
          f"T19(c): {TREE_SHAP_LAUNCHES.launches} S calls for "
          f"{st['windows']} windows")
    check(np.array_equal(got, ref), "T19(c): streamed pred_contrib != "
          "predict(pred_contrib=True)")
    print(f"T19(c) [pred_contrib, {STREAM_CONTRIB_ROWS} rows in windows of "
          f"1024]: == predict(pred_contrib=True), one S call a window; "
          f"{st['rows_per_s']:.0f} rows/s [{smi}]")


def stream_phases(t3: dict, smi: str) -> dict:
    t0 = time.perf_counter()
    t19 = stream_train_phase(t3, smi)
    t19["kernel"] = stream_kernel_phase(t3, smi)
    predict_stream_phase(t3, smi)
    print(f"T19: {time.perf_counter() - t0:.1f} s")
    return t19


# ---------------------------------------------------------------------------
# T20: the training API on T3's Datasets: fobj and feval, init_model, DART,
# RF, cv, reset_parameter; T20b the same at 16,000 x 20, card against CPU
# ---------------------------------------------------------------------------
def binary_fobj(preds, train_data):
    """Binary logloss gradients in numpy (sigmoid 1), flat."""
    y = train_data.metadata.label
    p = 1.0 / (1.0 + np.exp(-preds.astype(np.float64)))
    return (p - y).astype(np.float32), (p * (1.0 - p)).astype(np.float32)


def raw_logloss(raw, label) -> float:
    """Binary logloss of raw scores (``feval`` of an ``objective=none``
    booster, whose converted scores are its raw ones)."""
    p = np.clip(1.0 / (1.0 + np.exp(-np.asarray(raw, np.float64))),
                1e-15, 1 - 1e-15)
    y = np.asarray(label, np.float64)
    return float(-np.mean(y * np.log(p) + (1 - y) * np.log(1 - p)))


class _Walls:
    """Each round's wall: from the round's start (``callbacks()``' first,
    a before-iteration callback, starts the clock as round 1 begins,
    after the booster is built and any model replayed) or the last
    round's end, to the round's end."""

    def __init__(self) -> None:
        self.walls = []
        self.t_last = time.perf_counter()

    def start(self) -> None:
        self.t_last = time.perf_counter()

    def __call__(self, env=None) -> None:
        now = time.perf_counter()
        self.walls.append((now - self.t_last) * 1e3)
        self.t_last = now

    def callbacks(self) -> list:
        def begin(env) -> None:
            if env.iteration == 0:
                self.start()
        begin.before_iteration = True
        return [begin, self]


def k1_counted(tag: str, run, built) -> tuple:
    """``run()`` with the K1 and K2 counts zeroed just before and read just
    after: K1 launches must equal ``built(result)``, the histograms the run
    built, and K2 must stay unlaunched. Returns (result, K1 launches)."""
    import torch
    from lambdagap_tpu_torch.ops import hist_cuda as hc
    torch.cuda.synchronize()
    hc.HIST_LAUNCHES.reset()
    hc.HIST_Q_LAUNCHES.reset()
    out = run()
    torch.cuda.synchronize()
    k1, k2 = hc.HIST_LAUNCHES.launches, hc.HIST_Q_LAUNCHES.launches
    want = built(out)
    check(k1 > 0 and k1 == want, f"{tag}: K1 launches {k1} != leaf "
          f"histograms built {want}")
    check(k2 == 0, f"{tag}: launched K2 {k2} times")
    return out, k1


def leaves_from(bst, first: int = 0) -> int:
    """The leaf histograms the fused learner built for the trees from
    index ``first`` on (one a leaf: the root's, then the smaller child's
    at each split)."""
    return sum(t.num_leaves for t in bst._booster.host_models[first:])


def valid_equals_predict(tag: str, bst, Xva, rtol: float = 1e-5,
                         atol: float = 1e-6) -> float:
    """``predict(raw_score=True)`` on the validation rows equals the
    booster's own validation scores (the forest replays, the in-place
    renormalizations and the predict caches agree)."""
    got = bst.predict(Xva, raw_score=True)
    own = bst._booster.valid_scores[0][0].cpu().numpy()
    d = float(np.abs(got - own).max())
    check(np.allclose(got, own, rtol=rtol, atol=atol),
          f"{tag}: predict(raw_score=True) != the booster's validation "
          f"scores (max |diff| {d})")
    return d


def api_fobj_phase(t3: dict, smi: str) -> dict:
    """T20 (a): ``objective=none`` on T3's Datasets, a numpy
    binary-logloss fobj through ``Booster.update``, 2 rounds, a feval of
    the validation logloss."""
    import torch
    import lambdagap_tpu_torch as lgt
    from lambdagap_tpu_torch.metrics import create_metrics
    va_ds = t3["valid"].construct()
    yva = va_ds.metadata.label
    builtin = create_metrics(lgt.Config.from_params(
        {"objective": "binary", "metric": "binary_logloss"}),
        va_ds.metadata, va_ds.num_data)[0]

    def run():
        bst = lgt.Booster(params={**t3["params"], "objective": "none"},
                          train_set=t3["train"])
        bst.add_valid(t3["valid"], "valid_0")
        walls, fev = _Walls(), []
        walls.start()
        for _ in range(2):
            bst.update(fobj=binary_fobj)
            torch.cuda.synchronize()
            walls()
            fev.append(raw_logloss(bst._booster.valid_scores[0][0].cpu()
                                   .numpy(), yva))
        return bst, walls.walls, fev

    (bst, walls, fev), k1 = k1_counted("T20(a)", run,
                                       lambda o: leaves_from(o[0]))
    gb = bst._booster
    check(gb.scores.is_cuda and gb.objective is None,
          "T20(a): not an objective=none booster on the card")
    check(fev[-1] < fev[0], f"T20(a): the feval logloss did not fall: "
          f"{fev}")
    raw = gb.valid_scores[0]
    conv = (1.0 / (1.0 + torch.exp(-raw))).cpu().numpy().astype(np.float64)
    (_, ll), = builtin.eval(conv[0])
    check(np.isclose(fev[-1], ll, rtol=1e-6, atol=0), f"T20(a): feval "
          f"{fev[-1]} != binary_logloss {ll} of the same scores")
    print(f"T20(a) [fobj + feval]: rounds (ms) "
          f"{', '.join(f'{w:.1f}' for w in walls)}; K1 launches {k1} == "
          f"histograms built; feval valid logloss {fev[0]:.5f} -> "
          f"{fev[-1]:.5f} (== binary_logloss {ll:.5f}) [{smi}]")
    del bst
    return {"walls": walls}


def api_init_model_phase(t3: dict, smi: str) -> dict:
    """T20 (b): T3's 5-round model continued 2 rounds with ``init_model``;
    the replayed scores against T3's own, a late ``add_valid``."""
    import torch
    import lambdagap_tpu_torch as lgt
    from lambdagap_tpu_torch.models.gbdt import GBDT
    g3 = t3["bst"]._booster
    seen, replay = {}, []
    orig = GBDT.resume_from

    def timed(gb, trees):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        orig(gb, trees)
        torch.cuda.synchronize()
        replay.append((time.perf_counter() - t0) * 1e3)

    def first(env):
        if "scores" not in seen:
            gb = env.model._booster
            seen["scores"] = gb.scores.clone()
            seen["valid"] = gb.valid_scores[0].clone()
    first.before_iteration = True
    walls, ev = _Walls(), {}

    def run():
        GBDT.resume_from = timed
        try:
            return lgt.train(t3["params"], t3["train"], 2,
                             valid_sets=[t3["valid"]],
                             init_model=t3["bst"],
                             callbacks=[first, lgt.record_evaluation(ev)]
                             + walls.callbacks())
        finally:
            GBDT.resume_from = orig

    bst, k1 = k1_counted("T20(b)", run, lambda b: leaves_from(b, ROUNDS))
    check(bst.num_trees() == ROUNDS + 2,
          f"T20(b): {bst.num_trees()} trees, not {ROUNDS + 2}")
    for what, got, want in (("training", seen["scores"], g3.scores),
                            ("validation", seen["valid"],
                             g3.valid_scores[0])):
        d = float((got - want).abs().max())
        check(torch.allclose(got, want, rtol=1e-6, atol=1e-6),
              f"T20(b): replayed {what} scores part from T3's (max |diff| "
              f"{d})")
        print(f"T20(b): replayed {what} scores == T3's final ones (max "
              f"|diff| {d:.3g})")
    ll = ev["valid_0"]["binary_logloss"]
    check(ll[-1] < t3["logloss"], f"T20(b): valid logloss {ll[-1]} not "
          f"below T3's {t3['logloss']}")
    gb = bst._booster
    bst.add_valid(t3["valid"], "late")
    d = float((gb.valid_scores[1] - gb.valid_scores[0]).abs().max())
    check(torch.allclose(gb.valid_scores[1], gb.valid_scores[0],
                         rtol=1e-6, atol=1e-6),
          f"T20(b): the late validation set's replay != the scores "
          f"built round by round (max |diff| {d})")
    print(f"T20(b) [init_model]: replay of {ROUNDS} trees over "
          f"{gb.num_data} + {t3['valid'].num_data()} rows {replay[0]:.1f} "
          f"ms; rounds (ms) {', '.join(f'{w:.1f}' for w in walls.walls)};"
          f" K1 launches {k1} == histograms built; {bst.num_trees()} "
          f"trees; valid logloss {t3['logloss']:.5f} (T3) -> {ll[-1]:.5f};"
          f" a late add_valid == the incremental scores (max |diff| "
          f"{d:.3g}) [{smi}]")
    del bst, gb
    return {"walls": walls.walls, "replay_ms": replay[0]}


def api_boosting_phase(t3: dict, dev, smi: str, tag: str, extra: dict
                       ) -> dict:
    """T20 (c) DART / (d) RF on T3's Datasets, 3 rounds: K1 launches ==
    histograms built, the booster's validation scores == its
    ``predict(raw_score=True)``, the served model == the scan oracle."""
    import lambdagap_tpu_torch as lgt
    walls = _Walls()

    def run():
        return lgt.train({**t3["params"], **extra}, t3["train"], 3,
                         valid_sets=[t3["valid"]],
                         callbacks=walls.callbacks())

    bst, k1 = k1_counted(tag, run, leaves_from)
    gb = bst._booster
    check(type(gb).__name__ == {"dart": "DART", "rf": "RF"}[
        extra["boosting"]], f"{tag}: booster {type(gb).__name__}")
    d = valid_equals_predict(tag, bst, t3["Xva"])
    note = ""
    if extra["boosting"] == "dart":
        check(len(gb.tree_weight) == 3, f"{tag}: tree weights "
              f"{gb.tree_weight}")
        note = f"; tree weights {[round(w, 5) for w in gb.tree_weight]}"
    else:
        check(gb.average_output, f"{tag}: not averaged")
    print(f"{tag}: rounds (ms) {', '.join(f'{w:.1f}' for w in walls.walls)}"
          f"; K1 launches {k1} == histograms built; trees of "
          f"{[t.num_leaves for t in gb.host_models]} leaves; "
          f"predict(raw) == validation scores (max |diff| {d:.3g}){note} "
          f"[{smi}]")
    serve_trained_phase(bst, t3["Xva"], dev, smi, tag=tag)
    del bst, gb
    return {"walls": walls.walls}


def api_cv_phase(t3: dict, smi: str) -> dict:
    """T20 (e): ``cv`` with nfold=3, 2 rounds, on T3's first 2^20 rows
    under ``free_raw_data=False``."""
    import lambdagap_tpu_torch as lgt
    X, y = t3["head"]
    binning = [0.0]
    orig = lgt.Dataset.construct

    def timed(ds, config=None):
        t0 = time.perf_counter()
        fresh = ds._constructed is None
        out = orig(ds, config)
        if fresh and ds.used_indices is not None:
            binning[0] += time.perf_counter() - t0
        return out

    def run():
        lgt.Dataset.construct = timed
        try:
            t0 = time.perf_counter()
            res = lgt.cv(t3["params"], lgt.Dataset(X, label=y,
                                                   free_raw_data=False), 2,
                         nfold=3, return_cvbooster=True)
            return res, time.perf_counter() - t0
        finally:
            lgt.Dataset.construct = orig

    (res, secs), k1 = k1_counted(
        "T20(e)", run, lambda o: sum(leaves_from(b)
                                     for b in o[0]["cvbooster"].boosters))
    cvb = res["cvbooster"]
    folds = [dict((m, v) for _, m, v, _ in ev) for ev in cvb.eval_valid()]
    mean = res["valid binary_logloss-mean"][-1]
    want = float(np.mean([f["binary_logloss"] for f in folds]))
    check(len(cvb.boosters) == 3 and np.isclose(mean, want, rtol=1e-12),
          f"T20(e): valid binary_logloss-mean {mean} != the folds' mean "
          f"{want}")
    check(all(b._booster.scores.is_cuda for b in cvb.boosters),
          "T20(e): a fold did not train on the card")
    print(f"T20(e) [cv, nfold=3, {len(y)} rows]: {secs:.1f} s, of which "
          f"the folds' binning {binning[0]:.1f} s; K1 launches {k1} == "
          f"histograms built; valid binary_logloss-mean "
          f"{res['valid binary_logloss-mean'][0]:.5f} -> {mean:.5f} (== "
          f"the folds' mean), stdv {res['valid binary_logloss-stdv'][-1]:.2g}"
          f"; valid auc-mean {res['valid auc-mean'][-1]:.5f} [{smi}]")
    return {"secs": secs, "binning": binning[0]}


def api_reset_phase(t3: dict, smi: str) -> dict:
    """T20 (f): ``reset_parameter(learning_rate=[0.1, 0.05])`` over 2
    rounds; the model text's shrinkage lines follow the schedule."""
    import lambdagap_tpu_torch as lgt
    walls = _Walls()
    schedule = [0.1, 0.05]

    def run():
        return lgt.train(t3["params"], t3["train"], 2,
                         valid_sets=[t3["valid"]],
                         callbacks=[lgt.reset_parameter(
                             learning_rate=schedule)] + walls.callbacks())

    bst, k1 = k1_counted("T20(f)", run, leaves_from)
    shrink = [float(ln.split("=", 1)[1])
              for ln in bst.model_to_string().splitlines()
              if ln.startswith("shrinkage=")]
    check(shrink == schedule, f"T20(f): shrinkage lines {shrink}, not "
          f"{schedule}")
    print(f"T20(f) [reset_parameter]: rounds (ms) "
          f"{', '.join(f'{w:.1f}' for w in walls.walls)}; K1 launches {k1} "
          f"== histograms built; shrinkage lines {shrink} [{smi}]")
    del bst
    return {"walls": walls.walls}


def api_train(params: dict, rounds: int, data: dict, api: str) -> dict:
    """One T20b run (on the card, or with ``device_type=cpu`` in a CPU
    worker): ``fobj`` (``objective=none`` through ``Booster.update``; the
    best round the one of least validation logloss), ``init_model`` (a
    5-round model continued), or ``train`` (with the params' boosting and
    any ``reset_parameter`` schedule in ``data``), early stopping after 5
    rounds. Returns the training-row predictions, best_iteration and the
    seconds."""
    import lambdagap_tpu_torch as lgt
    X, y, Xv, yv = data["X"], data["y"], data["Xv"], data["yv"]
    tr = lgt.Dataset(X, label=y)
    va = lgt.Dataset(Xv, label=yv, reference=tr)
    t0 = time.perf_counter()
    if api == "fobj":
        bst = lgt.Booster(params={**params, "objective": "none"},
                          train_set=tr)
        bst.add_valid(va, "valid_0")
        hist = []
        for _ in range(rounds):
            bst.update(fobj=binary_fobj)
            hist.append(raw_logloss(bst._booster.valid_scores[0][0].cpu()
                                    .numpy(), yv))
        best = int(np.argmin(hist)) + 1
    else:
        kw = {}
        if api == "init_model":
            kw["init_model"] = lgt.train(params, tr, 5)
            rounds -= 5
        cbs = [lgt.early_stopping(5, verbose=False)]
        if data.get("schedule"):
            cbs.append(lgt.reset_parameter(learning_rate=data["schedule"]))
        bst = lgt.train(params, tr, rounds, valid_sets=[va], callbacks=cbs,
                        **kw)
        best = bst.best_iteration
    return {"pred": bst.predict(X), "best": best,
            "secs": time.perf_counter() - t0}


def api_card_vs_cpu_phase(smi: str) -> None:
    """T20b: fobj, init_model, DART, RF and reset_parameter at 16,000 x 20,
    31 leaves, 10 rounds, on the card and on the CPU."""
    rng = np.random.RandomState(0)
    X = rng.randn(20_000, 20)
    y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + 0.3 * rng.randn(20_000) > 0
         ).astype(np.float64)
    data = {"X": X[:16_000], "y": y[:16_000], "Xv": X[16_000:],
            "yv": y[16_000:]}
    base = {"objective": "binary", "metric": ["binary_logloss", "auc"],
            "num_leaves": 31, "learning_rate": 0.1, "verbose": -1}
    runs = [
        ("fobj", base, "fobj", {}),
        ("init_model (5 + 5 rounds)", base, "init_model", {}),
        ("DART 0.5", {**base, "boosting": "dart", "drop_rate": 0.5,
                      "skip_drop": 0.0}, "train", {}),
        ("RF 0.5/1", {**base, "boosting": "rf", "bagging_fraction": 0.5,
                      "bagging_freq": 1}, "train", {}),
        ("reset_parameter", base, "train",
         {"schedule": [0.2 - 0.015 * i for i in range(API_CPU_ROUNDS)]}),
    ]
    with CpuSide() as cpu:
        futs = [cpu.pool.submit(api_train, {**p, "device_type": "cpu"},
                                API_CPU_ROUNDS, {**data, **d}, api)
                for _, p, api, d in runs]
        cards = [api_train(p, API_CPU_ROUNDS, {**data, **d}, api)
                 for _, p, api, d in runs]
        cpus = [f.result() for f in futs]
    for (what, *_), c, p in zip(runs, cards, cpus):
        d = float(np.abs(c["pred"] - p["pred"]).max())
        check(np.allclose(c["pred"], p["pred"], rtol=1e-4, atol=1e-5),
              f"T20b [{what}]: card != CPU predictions (max |diff| {d})")
        check(c["best"] == p["best"], f"T20b [{what}]: best_iteration card "
              f"{c['best']} != CPU {p['best']}")
        print(f"T20b card == CPU [{what}]: predictions max |diff| {d:.3g}, "
              f"best_iteration {c['best']}; train {c['secs']:.1f} s on the "
              f"card, {p['secs']:.1f} s on the CPU [{smi}]")


def api_phases(t3: dict, dev, smi: str) -> None:
    """T20 (a)-(f) on T3's Datasets, then T20b."""
    import torch
    t0 = time.perf_counter()
    out = {"T3": t3["median_ms"]}
    variants = [
        ("(a) fobj", lambda: api_fobj_phase(t3, smi)),
        ("(b) init_model", lambda: api_init_model_phase(t3, smi)),
        ("(c) DART", lambda: api_boosting_phase(
            t3, dev, smi, "T20(c) [DART 0.5, skip_drop 0]",
            {"boosting": "dart", "drop_rate": 0.5, "skip_drop": 0.0})),
        ("(d) RF", lambda: api_boosting_phase(
            t3, dev, smi, "T20(d) [RF, bagging 0.5/1]",
            {"boosting": "rf", "bagging_fraction": 0.5,
             "bagging_freq": 1})),
        ("(e) cv", lambda: api_cv_phase(t3, smi)),
        ("(f) reset_parameter", lambda: api_reset_phase(t3, smi)),
    ]
    for name, run in variants:
        out[name] = run()
        torch.cuda.empty_cache()
    print("T20 median round (ms): " + "; ".join(
        f"{name} {statistics.median(r['walls']):.1f}"
        for name, r in out.items() if isinstance(r, dict) and "walls" in r)
        + f"; T3 {t3['median_ms']:.1f} [{smi}]")
    print(f"T20: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    api_card_vs_cpu_phase(smi)
    print(f"T20b: {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# T21: piece-wise linear leaves at HIGGS width; T21b card against CPU
# ---------------------------------------------------------------------------
class _LinearProbe:
    """Within the block: the linear fit's host wall a tree (its moment
    pass, its float64 solve, the device syncs between), the first fit's
    tree before it and its inputs (row -> leaf map, gradients), and every
    moment pass's results, read through ``models/linear_leaf``."""

    def __enter__(self):
        import torch
        from lambdagap_tpu_torch.models import linear_leaf as ll
        self.ll, self.fit_ms, self.moments, self.first = ll, [], [], None
        self.orig = (ll.fit_linear_leaves_batched, ll.accumulate_leaf_moments)
        fit, acc = self.orig

        def timed_fit(tree, X, leaf_idx, grad, hess, *rest):
            if self.first is None:
                self.first = (copy.deepcopy(tree), leaf_idx, grad, hess)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fit(tree, X, leaf_idx, grad, hess, *rest)
            torch.cuda.synchronize()
            self.fit_ms.append((time.perf_counter() - t0) * 1e3)

        def kept(*args):
            out = acc(*args)
            self.moments.append(out)
            return out
        ll.fit_linear_leaves_batched = timed_fit
        ll.accumulate_leaf_moments = kept
        return self

    def __exit__(self, *exc):
        self.ll.fit_linear_leaves_batched, self.ll.accumulate_leaf_moments = \
            self.orig
        return False


def linear_bound(x, tables, T: int, L: int, K: int, steps: int,
                 leaves: int, leaf_slots: int, slots: int):
    """The linear mode's bound: ``fused_bound``'s bytes plus what the linear
    tables give this run's rows, each once: a leaf constant (4 bytes) for
    each distinct (tree, leaf) reached (``leaves``) and a feature id and a
    coefficient (8 bytes) for each real slot of those leaves
    (``leaf_slots``); padding and unreached leaves are never read. Its
    operations are ``fused_bound``'s plus a multiply and an add for each
    slot the rows read (``slots``: the reached leaves' feature counts
    summed over (row, tree))."""
    _, _, nbytes = fused_bound(x, tables, T, L, K, steps)
    nbytes += 4 * leaves + 8 * leaf_slots
    R = x.shape[0]
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = (steps + R * T + 2 * slots) / H100_F32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes)


def linear_rows(seed: int, n: int):
    """:func:`higgs_like` rows with NaN in two columns, every 13th row in
    column 0 and every 29th in column 2 (``tests/test_linear.py:33-35``)."""
    X, y = higgs_like(seed, n)
    X[::13, 0] = np.nan
    X[::29, 2] = np.nan
    return X, y


def linear_kernel_phase(dev, smi: str, trees, cf) -> dict:
    """T21 (d): phase 3's forest with linear payloads (each leaf's path
    features, random coefficients; ``synth.linearize``) through the fused
    kernel's linear mode at 1, 256 and 4,096 rows (NaN rows mixed in):
    ``torch.equal`` to its plain version and to a rerun; timed beside the
    constant mode on the same forest (``cf``), with its bound and its
    plain version's time."""
    import torch
    import lambdagap_tpu_torch as lgt
    from lambdagap_tpu_torch.convert import booster_from_numpy
    from lambdagap_tpu_torch.infer import CompiledForest, compile_forest
    from lambdagap_tpu_torch.infer import engine as eng
    from lambdagap_tpu_torch.models import synth
    t0 = time.perf_counter()
    lin = synth.linearize([copy.deepcopy(t) for t in trees], 21)
    text = booster_from_numpy(synth.header(F), lin,
                              {"device_type": "cpu"}).model_to_string()
    gb = lgt.Booster(model_str=text, params={"device_type": "cpu"})._booster
    lcf = CompiledForest(compile_forest(gb), dev)
    lt = lcf.linear
    check(lt is not None, "T21(d): the linearized artifact has no tables")
    t = lcf.tables
    T, L = lcf._leaf_value.shape
    FL = int(lt.leaf_feat.shape[2])
    nfeat = (lt.leaf_feat >= 0).sum(-1)                  # [T, L]
    rng = np.random.RandomState(21)
    err, out = 0.0, {}
    for n in LINEAR_TIMED_ROWS:
        x = torch.from_numpy(synth.random_rows(rng, n, F)).to(dev)

        def plain():
            return eng._predict_forest_reference(
                x, t, t.group_tree_lo, t.group_tree, lcf._leaf_value,
                lcf._tree_class, 1, 0, 0.0, linear=lt)
        ref = plain()
        got, again = lcf.predict(x), lcf.predict(x)
        torch.cuda.synchronize()
        err = max(err, float((got - ref).abs().max()))
        check(torch.equal(got, ref) and torch.equal(again, got),
              f"T21(d): linear mode != plain at {n} rows "
              f"({int((got != ref).sum())} scores differ) or a rerun moved")
        carry = eng.traverse_forest(x, t)
        leaf = ~carry.T[lcf._group_of_tree.long()].long()   # [T, n]
        slots = int(nfeat.gather(1, leaf).sum())
        reached = torch.zeros(T, L, dtype=torch.bool, device=leaf.device)
        reached.scatter_(1, leaf, True)
        leaves = int(reached.sum())
        leaf_slots = int(nfeat[reached].sum())
        steps = steps_taken(lcf.artifact, carry.cpu().numpy())
        ms = cuda_ms(lambda: lcf.predict(x))
        const_ms = cuda_ms(lambda: cf.predict(x))
        bound_ms, bound_by, nbytes = linear_bound(x, t, T, L, 1, steps,
                                                  leaves, leaf_slots, slots)
        out[n] = {"ms": ms, "const_ms": const_ms, "bound_ms": bound_ms,
                  "bound_by": bound_by}
        if n == LINEAR_TIMED_ROWS[-1]:
            out[n]["plain_ms"] = cuda_ms(plain, reps=3, warm=1)
        print(f"T21(d) linear mode @{n} rows x {T} trees (FL {FL}, "
              f"{leaves} leaves and {leaf_slots} of their slots reached, "
              f"{slots} slot reads): {ms:.4f} ms against the constant "
              f"mode {const_ms:.4f} ms on the same forest ("
              f"{ms / const_ms:.2f}x); bound {bound_ms:.4f} ms ({bound_by}:"
              f" {nbytes / 1e6:.2f} MB, {steps} steps + {n * T} adds + "
              f"{2 * slots} slot operations)"
              + (f"; plain {out[n]['plain_ms']:.3f} ms" if "plain_ms" in
                 out[n] else "") + f"; == plain, rerun bit-identical [{smi}]")
    res = dict(out[LINEAR_TIMED_ROWS[-1]])
    res["max_abs_err"] = err
    print(f"T21(d): {time.perf_counter() - t0:.1f} s")
    return res


def linear_phase(args, t3: dict, dev, smi: str, trees, cf) -> dict:
    """T21 (a)-(f): linear leaves at HIGGS width on the card."""
    import torch
    import lambdagap_tpu_torch as lgt
    t_phase = time.perf_counter()
    params = {**t3["params"], "linear_tree": True, "linear_lambda": 1e-3}
    cfg = lgt.Config.from_params(params)
    t0 = time.perf_counter()
    X, y = linear_rows(args.seed + 100, args.rows)
    Xv, yv = linear_rows(args.seed + 101, VALID_ROWS)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tr = lgt.Dataset(X, label=y, reference=t3["train"])
    va = lgt.Dataset(Xv, label=yv, reference=tr)
    tr.construct(cfg)
    va.construct(cfg)
    build_s = time.perf_counter() - t0
    del X
    check(tr.construct().raw is not None and va.construct().raw is not None,
          "T21: the Datasets did not keep their raw matrices")
    print(f"T21 data: {args.rows} + {VALID_ROWS} rows x {F}, NaN in columns "
          f"0 and 2, made in {gen_s:.1f} s; Dataset construction on T3's "
          f"bins (binning, the raw matrices kept) {build_s:.1f} s")

    # (a) the fused learner
    ev, walls = {}, _Walls()

    def run_a():
        return lgt.train(params, tr, LINEAR_ROUNDS, valid_sets=[va],
                         callbacks=[lgt.record_evaluation(ev)]
                         + walls.callbacks())
    with _LinearProbe() as pa:
        bst, k1 = k1_counted("T21(a)", run_a, leaves_from)
    gb = bst._booster
    models = gb.host_models
    check(len(models) == LINEAR_ROUNDS and all(t.is_linear for t in models),
          "T21(a): the trees are not linear")
    coeffs = np.concatenate([np.concatenate([np.asarray(c, np.float64)
                                             for c in t.leaf_coeff] + [[]])
                             for t in models])
    check(coeffs.size > 0 and np.isfinite(coeffs).all()
          and all(np.isfinite(t.leaf_const[:t.num_leaves]).all()
                  for t in models), "T21(a): non-finite coefficients")
    ll = ev["valid_0"]["binary_logloss"]
    check(all(b < a for a, b in zip(ll, ll[1:])),
          f"T21(a): valid logloss did not fall every round: {ll}")
    ll3 = t3["ll"][:LINEAR_ROUNDS]
    text_a = bst.model_to_string()
    slots = sum(len(f) for t in models for f in t.leaf_features)
    print(f"T21(a) [fused]: {LINEAR_ROUNDS} rounds, walls (ms) "
          f"{', '.join(f'{w:.0f}' for w in walls.walls)} (median "
          f"{statistics.median(walls.walls):.1f}; T3's median round "
          f"{t3['median_ms']:.1f}: {statistics.median(walls.walls) / t3['median_ms']:.2f}x);"
          f" the linear fit (moments + solve) a tree "
          f"{', '.join(f'{w:.0f}' for w in pa.fit_ms)} ms; K1 launches {k1} "
          f"== histograms built; {slots} leaf coefficients, all finite; "
          f"valid logloss {', '.join(f'{v:.5f}' for v in ll)} against T3's "
          f"{', '.join(f'{v:.5f}' for v in ll3)} at the same rounds [{smi}]")
    rerun = lgt.train(params, tr, LINEAR_ROUNDS)
    check(rerun.model_to_string().split("end of trees")[0]
          == text_a.split("end of trees")[0],
          "T21(a): a rerun's model text differs")
    del rerun
    print("T21(a): a rerun's model text byte-equal")

    # (b) the serial learner; the moments of (a)'s first tree and map
    # through the serial booster's fit
    walls_b = _Walls()
    with _LinearProbe() as pb:
        bst_b, k1b = k1_counted(
            "T21(b)", lambda: lgt.train({**params, "tpu_fused_learner": "0"},
                                        tr, LINEAR_ROUNDS,
                                        callbacks=walls_b.callbacks()),
            serial_built)
        gb_b = bst_b._booster
        check(gb_b.serial, "T21(b): not the serial learner")
        tree0, leaf0, g0, h0 = pa.first
        n_before = len(pb.moments)
        gb_b._fit_linear_tree(copy.deepcopy(tree0), leaf0, g0, h0)
        mine = pb.moments[n_before]
    same = all(torch.equal(a, b) for a, b in zip(mine, pa.moments[0]))
    check(same, "T21(b): the serial path's moments of (a)'s first tree and "
          "map != (a)'s")
    print(f"T21(b) [serial]: {LINEAR_ROUNDS} rounds, walls (ms) "
          f"{', '.join(f'{w:.0f}' for w in walls_b.walls)}; the fit a tree "
          f"{', '.join(f'{w:.0f}' for w in pb.fit_ms[:LINEAR_ROUNDS])} ms; "
          f"K1 launches {k1b} == histograms built; the moments of (a)'s "
          f"first tree and row -> leaf map through the serial booster's fit "
          f"torch.equal to (a)'s [{smi}]")
    del bst_b, gb_b, pb

    # (c) predict, serve, pack
    t0 = time.perf_counter()
    d = valid_equals_predict("T21(c)", bst, Xv)
    srv_bst = lgt.Booster(model_str=text_a)
    data = np.ascontiguousarray(Xv[:20_000])
    plan = [((i * 977) % (len(data) - SIZES[i % len(SIZES)]),
             SIZES[i % len(SIZES)]) for i in range(REQUESTS)]
    with Dispatches() as dc:
        with srv_bst.as_server(raw_score=True, workers=1) as server:
            answers, secs = burst(server, data, plan)
    dc.check("T21(c) serve path")
    oracle = scan_oracle(srv_bst._booster, data, dev)
    check_answers(answers, plan, oracle)
    check(np.isnan(data).any(), "T21(c): no NaN rows served")
    print(f"T21(c): predict(raw_score=True) on {VALID_ROWS} validation rows "
          f"== the booster's validation scores (max |diff| {d:.3g}); "
          f"{REQUESTS} served requests (NaN rows among them) each == the "
          f"scan oracle in {secs:.2f} s; {dc.line()} [{smi}]")
    t3_text = t3["bst"].model_to_string()
    pk = lgt.Booster(model_str=text_a, params={"serve_pack_models": True})
    srv = pk.as_server(raw_score=True)
    srv.add_model("t3", t3_text)
    odata = {"default": data, "t3": np.ascontiguousarray(t3["Xva"][:20_000])}
    oracles = {"default": oracle,
               "t3": scan_oracle(lgt.Booster(model_str=t3_text)._booster,
                                 odata["t3"], dev)}
    mplan = [(("default", "t3")[i % 2],) + plan[i] for i in range(len(plan))]
    before = srv.stats_snapshot()["cache"]["packed_dispatches"]
    with Dispatches() as dp:
        got, psecs = model_burst(srv, odata, mplan)
    packed_n = srv.stats_snapshot()["cache"]["packed_dispatches"] - before
    srv.close()
    check_model_answers("T21(c) packed", got, mplan, oracles)
    check(dp.calls == 0 and packed_n > 0 and dp.fused == packed_n,
          f"T21(c): {dp.fused} fused launches for {packed_n} packed "
          f"dispatches ({dp.line()})")
    print(f"T21(c) packed [(a)'s linear model + T3's constant one]: "
          f"{len(mplan)} mixed requests in {psecs:.2f} s, each == its "
          f"model's scan oracle; {packed_n} packed dispatches, {dp.fused} "
          f"fused launches, none per model ({time.perf_counter() - t0:.1f} "
          f"s) [{smi}]")

    # (d) the kernel alone
    kern = linear_kernel_phase(dev, smi, trees, cf)

    # (e) pred_contrib, predict_stream
    t0 = time.perf_counter()
    xc = Xv[:SHAP_ROWS]
    phi = bst.predict(xc, pred_contrib=True)
    raw = bst.predict(xc, raw_score=True)
    dphi = float(np.abs(phi.sum(1) - raw).max())
    check(np.allclose(phi.sum(1), raw, rtol=1e-5, atol=1e-6),
          f"T21(e): contributions do not sum to the raw scores (max |diff| "
          f"{dphi})")
    here = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "t21")
    os.makedirs(here, exist_ok=True)
    src = np.memmap(os.path.join(here, "valid.f32"), dtype=np.float32,
                    mode="w+", shape=Xv.shape)
    src[:] = Xv
    src.flush()
    st = {}
    streamed = bst.predict_stream(src, window_rows=STREAM_WINDOWS[0],
                                  stats_out=st)
    check(np.array_equal(streamed, bst.predict(Xv)),
          "T21(e): predict_stream from the memmap != predict")
    del src
    print(f"T21(e): pred_contrib of {SHAP_ROWS} rows (NaN rows among them) "
          f"sums to the raw scores (max |diff| {dphi:.3g}); predict_stream "
          f"of {VALID_ROWS} rows from an np.memmap == predict, "
          f"{st['rows_per_s']:.0f} rows/s ({time.perf_counter() - t0:.1f} s)"
          f" [{smi}]")

    # (f) init_model: (a) continued one round
    seen, replay = {}, []

    def first(env):
        if "scores" not in seen:
            g = env.model._booster
            seen["scores"] = g.scores.clone()
            seen["valid"] = g.valid_scores[0].clone()
    first.before_iteration = True
    from lambdagap_tpu_torch.models.gbdt import GBDT
    orig = GBDT.resume_from

    def timed(g, trees_):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        orig(g, trees_)
        torch.cuda.synchronize()
        replay.append((time.perf_counter() - t1) * 1e3)

    def run_f():
        GBDT.resume_from = timed
        try:
            return lgt.train(params, tr, 1, valid_sets=[va], init_model=bst,
                             callbacks=[first])
        finally:
            GBDT.resume_from = orig
    bst_f, k1f = k1_counted("T21(f)", run_f,
                            lambda b: leaves_from(b, LINEAR_ROUNDS))
    check(bst_f.num_trees() == LINEAR_ROUNDS + 1,
          f"T21(f): {bst_f.num_trees()} trees")
    for what, got_, want in (("training", seen["scores"], gb.scores),
                             ("validation", seen["valid"],
                              gb.valid_scores[0])):
        dd = float((got_ - want).abs().max())
        check(torch.allclose(got_, want, rtol=1e-6, atol=1e-6),
              f"T21(f): replayed {what} scores part from (a)'s (max |diff| "
              f"{dd})")
        print(f"T21(f): replayed {what} scores == (a)'s final ones (max "
              f"|diff| {dd:.3g})")
    print(f"T21(f) [init_model]: replay of {LINEAR_ROUNDS} linear trees over "
          f"{gb.num_data} + {VALID_ROWS} rows {replay[0]:.1f} ms; "
          f"{bst_f.num_trees()} trees; K1 launches {k1f} == histograms "
          f"built [{smi}]")
    launches = dc.fused
    del bst_f, bst, gb, tr, va, srv_bst, pk
    torch.cuda.empty_cache()
    print(f"T21: {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "kernel": kern, "walls": walls.walls}


def linear_card_vs_cpu_phase(smi: str) -> None:
    """T21b: linear regression and binary on the fused learner and linear
    regression on the serial learner at 16,000 x 20 with NaN cells, 31
    leaves, 10 rounds, on the card and on the CPU."""
    rng = np.random.RandomState(0)
    X = rng.randn(20_000, 20)
    X[::13, 0] = np.nan
    X[::29, 2] = np.nan
    base = np.nan_to_num(X, nan=1.0)
    yr = base[:, 0] + 0.5 * base[:, 1] * base[:, 2] + 0.3 * rng.randn(20_000)
    yb = (yr > 0).astype(np.float64)
    common = {"num_leaves": 31, "learning_rate": 0.1, "verbose": -1,
              "linear_tree": True, "linear_lambda": 1e-3}
    runs = [("regression, fused", {**common, "objective": "regression"},
             yr, "l2"),
            ("binary, fused", {**common, "objective": "binary"}, yb,
             "binary_logloss"),
            ("regression, serial", {**common, "objective": "regression",
                                    "tpu_fused_learner": "0"}, yr, "l2")]
    with CpuSide() as cpu:
        fins = [(name, card_vs_cpu(cpu, p, X[:16_000], y[:16_000],
                                   X[16_000:], y[16_000:], LINEAR_CPU_ROUNDS,
                                   metric))
                for name, p, y, metric in runs]
        outs = [(name, fin()) for name, fin in fins]
    for name, out in outs:
        (pc, bc, _, sc, _), (pp, _, _, sp, _) = out["cuda"], out["cpu"]
        print(f"T21b card == CPU [{name}]: predictions max |diff| "
              f"{np.abs(pc - pp).max():.3g}, best_iteration {bc}; train "
              f"{sc:.1f} s on the card, {sp:.1f} s on the CPU [{smi}]")


def linear_phases(args, t3: dict, dev, smi: str, trees=None,
                  cf=None) -> dict:
    """T21 on T3's bins, then T21b. ``trees`` / ``cf``: phase 3's forest
    and its CompiledForest (built here when not given)."""
    import torch
    from lambdagap_tpu_torch.infer import CompiledForest, compile_forest
    if trees is None:
        import lambdagap_tpu_torch as lgt
        from lambdagap_tpu_torch.convert import booster_from_numpy
        from lambdagap_tpu_torch.models import synth
        trees = synth.random_trees(args.seed, T, LEAVES, F, GRID)
        gb = booster_from_numpy(synth.header(F), trees,
                                {"device_type": "cpu"})._booster
        cf = CompiledForest(compile_forest(gb), dev)
    out = linear_phase(args, t3, dev, smi, trees, cf)
    t0 = time.perf_counter()
    linear_card_vs_cpu_phase(smi)
    print(f"T21b: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=HIGGS_ROWS,
                    help="training rows of phase T3 (HIGGS's count)")
    ap.add_argument("--only", choices=("all", "kernels", "rank",
                                       "objectives", "predict", "shap",
                                       "options", "serial", "layout",
                                       "registry", "stream", "api",
                                       "linear"),
                    default="all",
                    help="kernels: phases 1-4 (with the SASS check), T2 and "
                    "T2q; rank: phases 1-2, T8, T2 at 136 features, T9 and "
                    "T10; objectives: phases 1-2, T11a-c, T2 at T11's "
                    "width, T11-serve, T12 and T13; predict: phases 1-3, "
                    "phase 5's scan oracle, T3, T11a and T14; shap: phases "
                    "1-3 and T14's kernel S checks; options: phases 1-2, "
                    "T3, T15 and T15b; serial: phases 1-2, T3, T16 and "
                    "T16b; layout: phases 1-2, T3, T8's data and T17; "
                    "registry: phases 1-3 and T18; stream: phases 1-2, T3 "
                    "and T19; api: phases 1-2, T3, T20 and T20b; linear: "
                    "phases 1-2, T3, T21 and T21b; each then stops without "
                    "a result line")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script runs the "
              "port on the card only", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import lambdagap_tpu_torch as lgt
    from lambdagap_tpu_torch.convert import booster_from_numpy
    from lambdagap_tpu_torch.infer import CompiledForest, compile_forest
    from lambdagap_tpu_torch.infer import engine as eng
    from lambdagap_tpu_torch.models import shap, synth
    from lambdagap_tpu_torch.ops import hist_cuda
    from lambdagap_tpu_torch.ops.predict import (forest_to_arrays,
                                                 predict_forest)
    from lambdagap_tpu_torch.utils import cuda_build
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)

    # -- 1. the card and the software --------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    nvcc_v = subprocess.run([cuda_build.nvcc(), "--version"],
                            capture_output=True, text=True,
                            check=True).stdout.strip().splitlines()[-1]
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"nvcc {nvcc_v}, device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}")

    # -- 2. build every kernel of the path, in parallel ---------------------
    t0 = time.perf_counter()
    sources = [eng.TRAVERSE_SOURCE, hist_cuda.HIST_SOURCE,
               hist_cuda.HIST_Q_SOURCE, shap.TREE_SHAP_SOURCE]
    handles = [cuda_build.start_build(s) for s in sources]
    for s, h in zip(sources, handles):
        report = cuda_build.finish_build(h)
        regs = [ln.split("info    :", 1)[-1].strip()
                for ln in report.splitlines()
                if "Compiling entry" in ln or "registers" in ln
                or "spill" in ln]
        print(f"built {s}: " + ("; ".join(regs) if regs else "(cached)"))
    print(f"build: {time.perf_counter() - t0:.2f} s")
    sass_phase()
    if args.only == "rank":
        rank_phases(args, dev, smi)
        print(f"chip_smoke: rank phases passed in "
              f"{time.perf_counter() - t_start:.1f} s (--only rank: no "
              "result)")
        return 0
    if args.only == "options":
        t3 = train_phase(args, smi)
        options_phases(t3, dev, smi)
        print(f"chip_smoke: option phases passed in "
              f"{time.perf_counter() - t_start:.1f} s (--only options: no "
              "result)")
        return 0
    if args.only == "serial":
        t3 = train_phase(args, smi)
        serial_phases(t3, dev, smi)
        print(f"chip_smoke: serial phases passed in "
              f"{time.perf_counter() - t_start:.1f} s (--only serial: no "
              "result)")
        return 0
    if args.only == "layout":
        t3 = train_phase(args, smi)
        layout_phases(t3, mslr_data(args), dev, args.seed + 17, smi)
        print(f"chip_smoke: layout phases passed in "
              f"{time.perf_counter() - t_start:.1f} s (--only layout: no "
              "result)")
        return 0
    if args.only == "stream":
        t3 = train_phase(args, smi)
        stream_phases(t3, smi)
        print(f"chip_smoke: stream phases passed in "
              f"{time.perf_counter() - t_start:.1f} s (--only stream: no "
              "result)")
        return 0
    if args.only == "api":
        t3 = train_phase(args, smi)
        api_phases(t3, dev, smi)
        print(f"chip_smoke: training-API phases passed in "
              f"{time.perf_counter() - t_start:.1f} s (--only api: no "
              "result)")
        return 0
    if args.only == "linear":
        t3 = train_phase(args, smi)
        linear_phases(args, t3, dev, smi)
        print(f"chip_smoke: linear-leaf phases passed in "
              f"{time.perf_counter() - t_start:.1f} s (--only linear: no "
              "result)")
        return 0
    if args.only == "objectives":
        objective_phases(args, dev, smi)
        print(f"chip_smoke: objective phases passed in "
              f"{time.perf_counter() - t_start:.1f} s (--only objectives: "
              "no result)")
        return 0

    # -- 3. the HIGGS-width forest, round-tripped through text --------------
    t0 = time.perf_counter()
    trees = synth.random_trees(args.seed, T, LEAVES, F, GRID)
    text = booster_from_numpy(synth.header(F), trees,
                              {"device_type": "cpu"}).model_to_string()
    host = lgt.Booster(model_str=text, params={"device_type": "cpu"})
    check(host.model_to_string() == text, "text round trip not byte-stable")
    gb = host._booster
    check(len(gb.models) == T and all(t.num_leaves == LEAVES
                                      for t in gb.models),
          "forest shape after the text round trip")
    art = compile_forest(gb)
    m = art.meta
    print(f"forest: {T} trees x {LEAVES} leaves x {F} features, text "
          f"{len(text) / 1e6:.1f} MB; artifact groups {m['num_groups']}, "
          f"blocks {m['num_blocks']}, nodes {len(art.buffers['node_feat'])}"
          f" (pruned {m['nodes_pruned']}), thr_bits {m['thr_bits']}, "
          f"{art.nbytes / 1e6:.2f} MB, sha256 {art.hash[:16]} "
          f"({time.perf_counter() - t0:.1f} s)")
    check(m["thr_bits"] == 16, "the 254-boundary grid needs u16 codes")

    if args.only == "registry":
        registry_phase(args.seed, dev, smi, text)
        print(f"chip_smoke: registry phases passed in "
              f"{time.perf_counter() - t_start:.1f} s (--only registry: no "
              "result)")
        return 0

    if args.only == "shap":
        data = synth.random_rows(np.random.RandomState(args.seed + 7), 20000,
                                 F)
        shap_kernel_phase(dev, smi, gb.models, data)
        print(f"chip_smoke: kernel S phases passed in "
              f"{time.perf_counter() - t_start:.1f} s (--only shap: no "
              "result)")
        return 0

    if args.only == "predict":
        rng = np.random.RandomState(args.seed + 7)
        data = synth.random_rows(rng, 20000, F)
        plan = [((i * 977) % (len(data) - SIZES[i % len(SIZES)]),
                 SIZES[i % len(SIZES)]) for i in range(REQUESTS)]
        forest, depth = forest_to_arrays(gb.models, device=dev)
        oracle = predict_forest(torch.from_numpy(data).to(dev), forest,
                                [0] * T, 1, depth)[0].cpu().numpy()
        del forest
        t3 = train_phase(args, smi)
        t11 = t11a_only(args, dev, smi)
        t0 = time.perf_counter()
        predict_phase(dev, smi, text, gb.models, data, plan, oracle, t3, t11)
        print(f"T14: {time.perf_counter() - t0:.1f} s")
        print(f"chip_smoke: predict phases passed in "
              f"{time.perf_counter() - t_start:.1f} s (--only predict: no "
              "result)")
        return 0

    # -- 4. K3 and the accumulation against their plain versions; times ----
    rng = np.random.RandomState(args.seed + 7)
    cf = CompiledForest(art, dev)
    k3, acc, fused = serve_kernels_phase(args.seed, rng, dev, smi, art, cf)
    if args.only == "kernels":
        hist_phase(dev, args.seed + 11, smi)
        hist_q_phase(dev, args.seed + 12, smi)
        print("chip_smoke: kernel phases passed (--only kernels: no result)")
        return 0

    # -- 5. the main path ----------------------------------------------------
    data = synth.random_rows(rng, 20000, F)
    with Dispatches() as d5:
        bst = lgt.Booster(model_str=text,
                          params={"predict_engine": "compiled"})
        server = bst.as_server(raw_score=True)
        check(server.cache.device.type == "cuda", "server not on the card")
        plan = [((i * 977) % (len(data) - SIZES[i % len(SIZES)]),
                 SIZES[i % len(SIZES)]) for i in range(REQUESTS)]
        answers, serve_s = burst(server, data, plan)
        snap = server.stats_snapshot()
        conv = bst.predict(data[:4096])
        server.close()
    d5.check("phase 5 serve path")

    xall = torch.from_numpy(data).to(dev)
    forest, depth = forest_to_arrays(gb.models, device=dev)
    oracle = predict_forest(xall, forest, [0] * T, 1, depth)[0].cpu().numpy()
    check_answers(answers, plan, oracle)
    check(np.all(np.isfinite(oracle)), "non-finite scores")
    sig = 1.0 / (1.0 + np.exp(-oracle[:4096].astype(np.float64)))
    check(np.allclose(conv, sig, rtol=1e-6, atol=1e-7),
          "converted predict != sigmoid of the oracle")
    check(snap["requests"] == len(plan), "stats lost requests")
    lat = snap["latency_ms"]
    print(f"serve: {snap['requests']} requests, {snap['rows']} rows from 4 "
          f"threads in {serve_s:.2f} s, each == scan oracle; latency p50 "
          f"{lat['p50']:.3f} ms p99 {lat['p99']:.3f} ms; "
          f"{snap['throughput_rows_per_s']:.0f} rows/s; "
          f"{snap['batches']['count']} batches; {d5.line()} [{smi}]")

    # -- 5b. the same burst per worker count; closed-loop one-row latency ----
    for workers in (1, 4):
        with bst.as_server(raw_score=True, workers=workers) as srv:
            got, secs = burst(srv, data, plan)
            check_answers(got, plan, oracle)
            one = []
            for i in range(100):
                t0 = time.perf_counter()
                srv.predict(data[i])
                one.append((time.perf_counter() - t0) * 1e3)
        one.sort()
        print(f"serve workers={workers}: burst {sum(n for _, n in plan) / secs:.0f}"
              f" rows/s ({secs:.2f} s); one-row closed loop p50 "
              f"{one[49]:.3f} ms p99 {one[98]:.3f} ms [{smi}]")

    # -- T18. the registry, hot / delta swap, the breaker, packing ----------
    t18 = registry_phase(args.seed, dev, smi, text)

    # -- T2. the histogram kernels against their plain versions -------------
    t0 = time.perf_counter()
    k1 = hist_phase(dev, args.seed + 11, smi)
    k2 = hist_q_phase(dev, args.seed + 12, smi)
    print(f"T2+T2q: {time.perf_counter() - t0:.1f} s")

    # -- T3. the f32 training path (counts zeroed just before, read after) ---
    t0 = time.perf_counter()
    t3 = train_phase(args, smi)
    print(f"T3: {time.perf_counter() - t0:.1f} s")

    # -- T6. the quantized, bagged path on T3's Datasets ---------------------
    t0 = time.perf_counter()
    bst6, k2_launches = quant_phase(t3, smi)
    serve_trained_phase(bst6, t3["Xva"], dev, smi, tag="T6")
    print(f"T6: {time.perf_counter() - t0:.1f} s")

    # -- T4. card against CPU; T5. serve what T3 trained; T7. EFB ------------
    t0 = time.perf_counter()
    card_vs_cpu_phase()
    serve_trained_phase(t3["bst"], t3["Xva"], dev, smi)
    print(f"T4+T5: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    efb_phase(smi)
    print(f"T7: {time.perf_counter() - t0:.1f} s")

    # -- T15. the tree options on T3's Datasets; T15b card vs CPU, guard -----
    options_phases(t3, dev, smi)

    # -- T16. the serial learner on T3's Datasets; T16b card vs CPU ----------
    serial_phases(t3, dev, smi)

    # -- T8. ranking at MSLR width; T2 at 136 features; T9; T10 -------------
    t8, k1m = rank_phases(args, dev, smi)

    # -- T19. out of core: stream training, predict_stream, pred_contrib ----
    t19 = stream_phases(t3, smi)

    # -- T20. the training API on T3's Datasets; T20b card vs CPU -----------
    api_phases(t3, dev, smi)

    # -- T21. linear leaves on T3's bins; T21b card vs CPU -------------------
    t21 = linear_phases(args, t3, dev, smi, gb.models, cf)

    # -- T17. sorted against gather on T3's and T8's Datasets; windows -------
    t17 = layout_phases(t3, t8, dev, args.seed + 17, smi)
    del t8["train"]

    # -- T11-T13. multiclass at Covertype width, T12, leaf renew at MSD -----
    t11, k1c, k2c_err = objective_phases(args, dev, smi)

    # -- T14. the predict API: tensor engine, pred_leaf, pred_contrib, refit -
    t0 = time.perf_counter()
    t14 = predict_phase(dev, smi, text, gb.models, data, plan, oracle, t3,
                        t11)
    print(f"T14: {time.perf_counter() - t0:.1f} s")

    # -- 6. the kernels line, then the device line ---------------------------
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "predict_forest", "route": "cuda",
        "source": "lambdagap_tpu_torch/csrc/traverse.cu",
        "replaces": "lambdagap_tpu/infer/engine.py:68",
        "launches": d5.fused,
        "max_abs_err": fused[4096]["max_abs_err"],
        "ms": fused[4096]["ms"], "plain_ms": fused[4096]["plain_ms"],
        "bound_ms": fused[4096]["bound_ms"],
        "bound_by": fused[4096]["bound_by"], "library_ms": None}, {
        "name": "predict_forest@packed", "route": "cuda",
        "source": "lambdagap_tpu_torch/csrc/traverse.cu",
        "replaces": "lambdagap_tpu/infer/engine.py:241",
        "launches": t18["launches"], "max_abs_err": t18["max_abs_err"],
        "ms": t18["ms"], "plain_ms": t18["plain_ms"],
        "bound_ms": t18["bound_ms"], "bound_by": t18["bound_by"],
        "library_ms": None}, {
        "name": "traverse_forest", "route": "cuda",
        "source": "lambdagap_tpu_torch/csrc/traverse.cu",
        "replaces": "lambdagap_tpu/infer/engine.py:68",
        "launches": d5.k3 + t14["leaf_launches"],
        "max_abs_err": k3[4096]["max_abs_err"],
        "ms": k3[4096]["ms"], "plain_ms": k3[4096]["plain_ms"],
        "bound_ms": k3[4096]["bound_ms"], "bound_by": k3[4096]["bound_by"],
        "library_ms": None}, {
        "name": "accumulate_forest", "route": "cuda",
        "source": "lambdagap_tpu_torch/csrc/traverse.cu",
        "replaces": "lambdagap_tpu/infer/engine.py:181",
        "launches": d5.acc,
        "max_abs_err": acc[4096]["max_abs_err"],
        "ms": acc[4096]["ms"], "plain_ms": acc[4096]["plain_ms"],
        "bound_ms": acc[4096]["bound_ms"], "bound_by": acc[4096]["bound_by"],
        "library_ms": None}, {
        "name": "hist_rows", "route": "cuda",
        "source": "lambdagap_tpu_torch/csrc/hist.cu",
        "replaces": "lambdagap_tpu/ops/hist_pallas.py:79",
        "launches": t3["launches"], "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"], "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
        "library_ms": k1["library_ms"]}, {
        "name": "hist_rows@136f", "route": "cuda",
        "source": "lambdagap_tpu_torch/csrc/hist.cu",
        "replaces": "lambdagap_tpu/ops/hist_pallas.py:79",
        "launches": t8["out"]["ndcg"]["launches"],
        "max_abs_err": k1m["max_abs_err"],
        "ms": k1m["ms"], "plain_ms": k1m["plain_ms"],
        "bound_ms": k1m["bound_ms"], "bound_by": k1m["bound_by"],
        "library_ms": k1m["library_ms"]}, {
        "name": "hist_rows@covtype", "route": "cuda",
        "source": "lambdagap_tpu_torch/csrc/hist.cu",
        "replaces": "lambdagap_tpu/ops/hist_pallas.py:79",
        "launches": t11["launches"], "max_abs_err": k1c["max_abs_err"],
        "ms": k1c["ms"], "plain_ms": k1c["plain_ms"],
        "bound_ms": k1c["bound_ms"], "bound_by": k1c["bound_by"],
        "library_ms": k1c["library_ms"]}, {
        "name": "hist_rows_q", "route": "cuda",
        "source": "lambdagap_tpu_torch/csrc/hist_q.cu",
        "replaces": "lambdagap_tpu/ops/hist_pallas.py:207",
        "launches": k2_launches,
        "max_abs_err": max(k2["max_abs_err"], k2c_err),
        "ms": k2["ms"], "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
        "library_ms": k2["library_ms"]}] + [{
        "name": f"{name}@sorted", "route": "cuda",
        "source": f"lambdagap_tpu_torch/csrc/{src}",
        "replaces": f"lambdagap_tpu/ops/hist_pallas.py:{line}",
        "launches": t17[count], "max_abs_err": w["max_abs_err"],
        "ms": w["ms"], "plain_ms": w["plain_ms"], "bound_ms": w["bound_ms"],
        "bound_by": w["bound_by"], "library_ms": w["library_ms"]}
        for name, src, line, count, w in (
            ("hist_rows", "hist.cu", 79, "k1_window", t17["kernels"]["K1"]),
            ("hist_rows_q", "hist_q.cu", 207, "k2_window",
             t17["kernels"]["K2"]))] + [{
        "name": "hist_rows@stream", "route": "cuda",
        "source": "lambdagap_tpu_torch/csrc/hist.cu",
        "replaces": "lambdagap_tpu/ops/hist_pallas.py:79",
        "launches": t19["launches"],
        "max_abs_err": t19["kernel"]["max_abs_err"],
        "ms": t19["kernel"]["ms"], "plain_ms": t19["kernel"]["plain_ms"],
        "bound_ms": t19["kernel"]["bound_ms"],
        "bound_by": t19["kernel"]["bound_by"],
        "library_ms": t19["kernel"]["library_ms"]}, {
        "name": "predict_forest@linear", "route": "cuda",
        "source": "lambdagap_tpu_torch/csrc/traverse.cu",
        "replaces": "lambdagap_tpu/infer/engine.py:159",
        "launches": t21["launches"],
        "max_abs_err": t21["kernel"]["max_abs_err"],
        "ms": t21["kernel"]["ms"], "plain_ms": t21["kernel"]["plain_ms"],
        "bound_ms": t21["kernel"]["bound_ms"],
        "bound_by": t21["kernel"]["bound_by"],
        "library_ms": None}] + [t14["shap"]]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
