"""Best-split search over histograms.

The port of ``lambdagap_tpu/ops/split.py``: the reference's per-feature
threshold scan (reference: src/treelearner/feature_histogram.hpp:396-441,
:828-1058 FindBestThresholdSequentially) and its gain / leaf-output math
(:711-830), vectorized over every (feature, bin) at once with cumulative
sums. Every function takes histograms ``[..., F, B, 3]`` with any leading
batch shape and per-leaf aggregates shaped like that batch, so the fused
learner scans both children of a split in one call (the JAX package's
``vmap``). The f32 operations follow the JAX package's, in the same order;
bitsets are int64 words holding u32 values (torch has no u32 shift on the
CPU).

The tree options enter here as they do in the JAX package's scan:
monotone ``constraints`` clamp every candidate's child outputs to the
leaf's bounds and veto the wrong direction, ``rand_thresholds``
(extra_trees) keep one candidate threshold per feature, ``gain_penalty``
(CEGB) is subtracted from each feature's finite gain, and ``gain_mult``
(``feature_contri`` and the monotone split penalty) scales each
feature's post-shift gain. The constraints are either one (min, max) per
leaf (the basic and intermediate methods) or, under the advanced method,
dense per-threshold bounds ``(min_l, max_l, min_r, max_r)`` ``[..., F,
B]`` for the left and the right child of a split at each bin
(``lambdagap_tpu/ops/split.py:112-126``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

K_EPSILON = 1e-15
K_MIN_SCORE = float("-inf")
CAT_WORDS = 8                    # bin-space bitset words (256 bins)

# missing-type codes (data.dataset.MISSING_CODES)
MT_NONE, MT_ZERO, MT_NAN = 0, 1, 2


@dataclass(frozen=True)
class SplitParams:
    """Hyperparameters entering the gain math (fixed for a training run)."""
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    max_delta_step: float = 0.0
    path_smooth: float = 0.0
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    min_gain_to_split: float = 0.0
    cat_smooth: float = 10.0
    cat_l2: float = 10.0
    max_cat_threshold: int = 32
    max_cat_to_onehot: int = 4
    min_data_per_group: int = 100

    @classmethod
    def from_config(cls, config) -> "SplitParams":
        return cls(**{k: getattr(config, k)
                      for k in cls.__dataclass_fields__})


class SplitResult(NamedTuple):
    """Split info at a fixed (feature, threshold) — the analog of
    ``SplitInfo`` (reference: src/treelearner/split_info.hpp)."""
    gain: torch.Tensor
    feature: int
    threshold: int
    default_left: torch.Tensor
    left_sum_g: torch.Tensor
    left_sum_h: torch.Tensor
    left_count: torch.Tensor
    right_sum_g: torch.Tensor
    right_sum_h: torch.Tensor
    right_count: torch.Tensor
    left_output: torch.Tensor
    right_output: torch.Tensor
    is_categorical: torch.Tensor
    cat_bitset: torch.Tensor


def threshold_l1(s, l1):
    """(reference: feature_histogram.hpp:711 ThresholdL1)"""
    return torch.sign(s) * torch.clamp(s.abs() - l1, min=0.0)


def calculate_leaf_output(sum_g, sum_h, p: SplitParams, num_data=None,
                          parent_output=0.0, l2_extra=0.0):
    """(reference: feature_histogram.hpp:716-737 CalculateSplittedLeafOutput)"""
    l2 = p.lambda_l2 + l2_extra
    if p.lambda_l1 > 0:
        ret = -threshold_l1(sum_g, p.lambda_l1) / (sum_h + l2)
    else:
        ret = -sum_g / (sum_h + l2)
    if p.max_delta_step > 0:
        ret = torch.clamp(ret, -p.max_delta_step, p.max_delta_step)
    if p.path_smooth > K_EPSILON and num_data is not None:
        n_over_s = num_data / p.path_smooth
        ret = ret * n_over_s / (n_over_s + 1.0) + \
            parent_output / (n_over_s + 1.0)
    return ret


def leaf_gain_given_output(sum_g, sum_h, output, p: SplitParams,
                           l2_extra=0.0):
    """(reference: feature_histogram.hpp:818-830 GetLeafGainGivenOutput)"""
    l2 = p.lambda_l2 + l2_extra
    sg = threshold_l1(sum_g, p.lambda_l1) if p.lambda_l1 > 0 else sum_g
    return -(2.0 * sg * output + (sum_h + l2) * output * output)


def leaf_gain(sum_g, sum_h, p: SplitParams, num_data=None,
              parent_output=0.0, l2_extra=0.0):
    """(reference: feature_histogram.hpp:800-816 GetLeafGain)"""
    if p.max_delta_step <= 0 and p.path_smooth <= K_EPSILON \
            and l2_extra == 0.0:
        sg = threshold_l1(sum_g, p.lambda_l1) if p.lambda_l1 > 0 else sum_g
        return (sg * sg) / (sum_h + p.lambda_l2)
    out = calculate_leaf_output(sum_g, sum_h, p, num_data, parent_output,
                                l2_extra)
    return leaf_gain_given_output(sum_g, sum_h, out, p, l2_extra)


def split_gains(lg, lh, rg, rh, p: SplitParams, l_cnt=None, r_cnt=None,
                parent_output=0.0, l2_extra=0.0):
    """(reference: feature_histogram.hpp:759-797 GetSplitGains)"""
    return (leaf_gain(lg, lh, p, l_cnt, parent_output, l2_extra)
            + leaf_gain(rg, rh, p, r_cnt, parent_output, l2_extra))


def _clip(x, lo, hi):
    """``jnp.clip``: the lower bound first, then the upper."""
    return torch.minimum(torch.maximum(x, lo), hi)


def monotone_split_penalty(depth, penalization: float) -> torch.Tensor:
    """Gain multiplier of a split on a monotone-constrained feature at a
    leaf depth (reference: monotone_constraints.hpp:357
    ComputeMonotoneSplitGainPenalty), in float32 as the JAX package
    computes it: ~0 for the first floor(penalization) levels, then a
    decaying penalty. ``depth``: an int or an integer tensor."""
    d = torch.as_tensor(depth).to(torch.float32)

    def f32(v: float) -> torch.Tensor:
        return torch.full((), v, dtype=torch.float32, device=d.device)

    p = f32(penalization)
    # XLA lowers exp2 as exp(x ln 2); so does the second branch, whose
    # exponent is not an integer (it can part from XLA's by an ulp)
    pen = (1.0 - p / torch.exp2(d) + K_EPSILON if penalization <= 1.0
           else 1.0 - torch.exp((f32(penalization - 1.0) - d)
                                * f32(0.6931471805599453)) + K_EPSILON)
    return torch.where(p >= d + 1.0, f32(K_EPSILON), pen)


def _norm_constraints(constraints):
    """``(monotone, min_l, max_l, min_r, max_r)``: the left child's bounds
    and the right child's, the same pair for the one-bound-per-leaf form
    (``lambdagap_tpu/ops/split.py:112-126``)."""
    if len(constraints) == 3:
        monotone, lo, hi = constraints
        return monotone, lo, hi, lo, hi
    return constraints


def _take(a: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """a[..., f, t[..., f]]"""
    return torch.gather(a, -1, t.unsqueeze(-1)).squeeze(-1)


def _cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Running sums of f32 histogram channels, accumulated in float64 and
    rounded once per prefix: the same bits on the CPU (whose f32 cumsum
    accumulates in double) and on the card (whose f32 cumsum accumulates in
    float, in a parallel order along the last dimension), so a tie between
    two thresholds resolves alike on both."""
    return torch.cumsum(x, dim=dim, dtype=torch.float64).float()


# ---------------------------------------------------------------------------
# numerical scan
# ---------------------------------------------------------------------------
def _numerical_best(hist, parent_g, parent_h, parent_c, parent_output,
                    num_bins, default_bins, missing_types, feature_mask,
                    p: SplitParams, constraints=None, rand_thresholds=None):
    """Both-direction scan for all features at once. Aggregates arrive
    shaped [..., 1, 1]. ``constraints``: (monotone [F] in {-1, 0, +1},
    min, max), the bounds shaped like the aggregates, or (monotone, min_l,
    max_l, min_r, max_r), dense ``[..., F, B]`` (the advanced method);
    ``rand_thresholds``:
    [..., F], each feature's one candidate under extra_trees (reference:
    feature_histogram.hpp:192-205 USE_RAND). Returns per-feature best
    (gain, threshold, default_left, left_g, left_h, left_c), each
    [..., F]."""
    B = hist.shape[-2]
    g, h, c = hist[..., 0], hist[..., 1], hist[..., 2]
    bin_idx = torch.arange(B, device=hist.device)[None, :]    # [1, B]
    nb = num_bins[:, None]                                    # [F, 1]
    is_zero_missing = (missing_types == MT_ZERO)[:, None]
    is_nan_missing = (missing_types == MT_NAN)[:, None]
    is_default = bin_idx == default_bins[:, None]
    is_nan_bin = bin_idx == (nb - 1)

    # the missing bin's content is excluded from the left accumulation, so
    # it lands on the side right = parent - left (reference: SKIP_DEFAULT_BIN
    # / NA_AS_MISSING of FindBestThresholdSequentially)
    excl = (is_zero_missing & is_default) | (is_nan_missing & is_nan_bin)
    ghc = torch.stack([torch.where(excl, 0.0, g), torch.where(excl, 0.0, h),
                       torch.where(excl, 0.0, c)], dim=-1)    # [..., F, B, 3]
    cs_f = _cumsum(ghc, -2)
    lg_f, lh_f, lc_f = cs_f[..., 0], cs_f[..., 1], cs_f[..., 2]
    # right sums for threshold t = sum of bins > t: the inclusive suffix
    # sums shifted by one bin (the JAX package subtracts bin t from the
    # inclusive sum instead, equal up to rounding). Shifting keeps the sums
    # of thresholds t and t+1 bit-equal when bin t+1 is empty — as it is
    # when it holds only out-of-bag rows — so that exact tie goes to the
    # first threshold in both directions and on every device.
    rev = torch.flip(_cumsum(torch.flip(ghc, [-2]), -2), [-2])
    rev = torch.cat([rev[..., 1:, :], torch.zeros_like(rev[..., :1, :])],
                    dim=-2)
    rg_r, rh_r, rc_r = rev[..., 0], rev[..., 1], rev[..., 2]

    def eval_dir(left_g, left_h, left_c):
        right_g = parent_g - left_g
        right_h = parent_h - left_h
        right_c = parent_c - left_c
        ok = ((left_c >= p.min_data_in_leaf)
              & (right_c >= p.min_data_in_leaf)
              & (left_h >= p.min_sum_hessian_in_leaf)
              & (right_h >= p.min_sum_hessian_in_leaf))
        if constraints is None:
            gain = split_gains(left_g, left_h, right_g, right_h, p, left_c,
                               right_c, parent_output)
            return torch.where(ok, gain, K_MIN_SCORE)
        # child outputs clamped to the leaf's bounds (per threshold under
        # the advanced method), the wrong direction vetoed on a constrained
        # feature (reference: monotone_constraints.hpp:329
        # BasicLeafConstraints, CumulativeFeatureConstraint)
        monotone, min_l, max_l, min_r, max_r = _norm_constraints(constraints)
        lout = _clip(calculate_leaf_output(left_g, left_h, p, left_c,
                                           parent_output), min_l, max_l)
        rout = _clip(calculate_leaf_output(right_g, right_h, p, right_c,
                                           parent_output), min_r, max_r)
        m = monotone[:, None]
        veto = ((m > 0) & (lout > rout)) | ((m < 0) & (lout < rout))
        gain = (leaf_gain_given_output(left_g, left_h, lout, p)
                + leaf_gain_given_output(right_g, right_h, rout, p))
        return torch.where(ok & ~veto, gain, K_MIN_SCORE)

    gain_f = eval_dir(lg_f, lh_f, lc_f)
    lg_r = parent_g - rg_r
    lh_r = parent_h - rh_r
    lc_r = parent_c - rc_r
    gain_r = eval_dir(lg_r, lh_r, lc_r)

    # candidates: t in [0, num_bin-2]; Zero-missing skips the default bin;
    # the reverse scan with NaN-missing cannot put the NaN bin alone on the
    # right (reference: the reverse loop starts at num_bin-2-NA_AS_MISSING)
    cand = (bin_idx < nb - 1) & feature_mask[..., :, None]
    if rand_thresholds is not None:
        cand = cand & (bin_idx == rand_thresholds[..., :, None])
    cand_f = cand & ~(is_zero_missing & is_default)
    cand_r = cand_f & ~(is_nan_missing & (bin_idx == nb - 2))
    gain_f = torch.where(cand_f, gain_f, K_MIN_SCORE)
    gain_r = torch.where(cand_r, gain_r, K_MIN_SCORE)

    # the reverse direction wins ties (the reference runs REVERSE first and
    # needs a strict improvement)
    use_fwd = gain_f > gain_r
    gain = torch.maximum(gain_f, gain_r)
    left_g = torch.where(use_fwd, lg_f, lg_r)
    left_h = torch.where(use_fwd, lh_f, lh_r)
    left_c = torch.where(use_fwd, lc_f, lc_r)
    best_t = torch.argmax(gain, dim=-1)                       # [..., F]
    return (_take(gain, best_t), best_t, _take(~use_fwd, best_t),
            _take(left_g, best_t), _take(left_h, best_t),
            _take(left_c, best_t))


# ---------------------------------------------------------------------------
# categorical scan (one-hot + sorted subset)
# ---------------------------------------------------------------------------
def _bins_to_bitset(member: torch.Tensor) -> torch.Tensor:
    """bool [..., F, B<=256] -> int64 words [..., F, 8] (u32 values)."""
    B = member.shape[-1]
    m = torch.nn.functional.pad(member, (0, CAT_WORDS * 32 - B))
    m = m.reshape(*member.shape[:-1], CAT_WORDS, 32)
    bits = torch.ones(32, dtype=torch.int64, device=member.device) << \
        torch.arange(32, device=member.device)
    return torch.where(m, bits, 0).sum(dim=-1)


def _onehot_bits(t: torch.Tensor) -> torch.Tensor:
    """bin t -> its one-bit bitset, int64 words [..., 8]."""
    words = torch.arange(CAT_WORDS, device=t.device)
    bit = torch.ones_like(t) << (t % 32)
    return torch.where(words == (t // 32).unsqueeze(-1), bit.unsqueeze(-1), 0)


def _categorical_best(hist, parent_g, parent_h, parent_c, parent_output,
                      num_bins, feature_mask, p: SplitParams,
                      constraints=None, rand_thresholds=None):
    """Categorical split search (reference: feature_histogram.hpp
    FindBestThresholdCategoricalInner): one-vs-rest for small cardinality,
    otherwise prefixes and suffixes of the bins sorted by
    grad/(hess+cat_smooth), capped at max_cat_threshold. Returns per-feature
    (gain, threshold, left_g, left_h, left_c, bitset of bins going left)."""
    B = hist.shape[-2]
    g, h, c = hist[..., 0], hist[..., 1], hist[..., 2]
    bin_idx = torch.arange(B, device=hist.device)[None, :]
    nb = num_bins[:, None]
    valid_bin = (bin_idx < nb) & (c > 0)
    fm = feature_mask[..., :, None]

    def gains_for(left_g, left_h, left_c):
        right_g = parent_g - left_g
        right_h = parent_h - left_h
        right_c = parent_c - left_c
        ok = ((left_c >= p.min_data_in_leaf)
              & (right_c >= p.min_data_in_leaf)
              & (left_h >= p.min_sum_hessian_in_leaf)
              & (right_h >= p.min_sum_hessian_in_leaf))
        if constraints is None:
            gain = split_gains(left_g, left_h, right_g, right_h, p, left_c,
                               right_c, parent_output, l2_extra=p.cat_l2)
            return torch.where(ok, gain, K_MIN_SCORE)
        # no direction veto on a categorical split; its child outputs
        # still clamp to the leaf's bounds. Under the advanced method a
        # categorical split sends bins to both sides, so both children take
        # the full-range bound: the last prefix column of the left bounds
        if len(constraints) == 3:
            _, lo, hi = constraints
        else:
            lo, hi = constraints[1][..., -1:], constraints[2][..., -1:]
        lout = _clip(calculate_leaf_output(left_g, left_h, p, left_c,
                                           parent_output, l2_extra=p.cat_l2),
                     lo, hi)
        rout = _clip(calculate_leaf_output(right_g, right_h, p, right_c,
                                           parent_output, l2_extra=p.cat_l2),
                     lo, hi)
        gain = (leaf_gain_given_output(left_g, left_h, lout, p,
                                       l2_extra=p.cat_l2)
                + leaf_gain_given_output(right_g, right_h, rout, p,
                                         l2_extra=p.cat_l2))
        return torch.where(ok, gain, K_MIN_SCORE)

    # extra_trees: one random candidate position per feature, the same
    # draw indexing the one-hot bin and the sorted-order position
    # (reference: feature_histogram.hpp:1152,1269 USE_RAND)
    rand = fm
    if rand_thresholds is not None:
        rand = fm & (bin_idx == rand_thresholds[..., :, None]
                     % torch.clamp(nb - 1, min=1))
    onehot_gain = torch.where(valid_bin & rand, gains_for(g, h, c),
                              K_MIN_SCORE)

    score = torch.where(valid_bin, g / (h + p.cat_smooth), float("inf"))
    order = torch.argsort(score, dim=-1, stable=True)          # [..., F, B]
    g_s = torch.gather(g, -1, order)
    h_s = torch.gather(h, -1, order)
    c_s = torch.gather(c, -1, order)
    v_s = torch.gather(valid_bin, -1, order)
    g_s = torch.where(v_s, g_s, 0.0)
    h_s = torch.where(v_s, h_s, 0.0)
    c_s = torch.where(v_s, c_s, 0.0)
    csum_g = _cumsum(g_s, -1)
    csum_h = _cumsum(h_s, -1)
    csum_c = _cumsum(c_s, -1)
    prefix_len = torch.cumsum(v_s.to(torch.int32), dim=-1)
    sorted_cand = (prefix_len <= p.max_cat_threshold) & v_s & rand
    sorted_gain = torch.where(sorted_cand, gains_for(csum_g, csum_h, csum_c),
                              K_MIN_SCORE)
    # suffix direction: left set = bins AFTER position t in the order
    sfx_g = csum_g[..., -1:] - csum_g
    sfx_h = csum_h[..., -1:] - csum_h
    sfx_c = csum_c[..., -1:] - csum_c
    sfx_len = prefix_len[..., -1:] - prefix_len
    sfx_cand = (sfx_len <= p.max_cat_threshold) & (sfx_len > 0) & v_s & rand
    suffix_gain = torch.where(sfx_cand, gains_for(sfx_g, sfx_h, sfx_c),
                              K_MIN_SCORE)

    best_onehot = onehot_gain.amax(dim=-1)
    t_onehot = torch.argmax(onehot_gain, dim=-1)
    best_pref = sorted_gain.amax(dim=-1)
    t_pref = torch.argmax(sorted_gain, dim=-1)
    best_sfx = suffix_gain.amax(dim=-1)
    t_sfx = torch.argmax(suffix_gain, dim=-1)
    use_sfx = best_sfx > best_pref
    best_sorted = torch.maximum(best_pref, best_sfx)
    t_sorted = torch.where(use_sfx, t_sfx, t_pref)
    use_onehot = (num_bins <= p.max_cat_to_onehot) | (best_onehot >=
                                                      best_sorted)
    gain = torch.where(use_onehot, best_onehot, best_sorted)

    pos = torch.arange(B, device=hist.device)
    in_set = torch.where(use_sfx.unsqueeze(-1),
                         pos > t_sorted.unsqueeze(-1),
                         pos <= t_sorted.unsqueeze(-1)) & v_s
    # scatter back from sorted order to bin order
    member = torch.gather(in_set, -1, torch.argsort(order, dim=-1))
    bits = torch.where(use_onehot.unsqueeze(-1), _onehot_bits(t_onehot),
                       _bins_to_bitset(member))
    sort_g = torch.where(use_sfx, _take(sfx_g, t_sorted),
                         _take(csum_g, t_sorted))
    sort_h = torch.where(use_sfx, _take(sfx_h, t_sorted),
                         _take(csum_h, t_sorted))
    sort_c = torch.where(use_sfx, _take(sfx_c, t_sorted),
                         _take(csum_c, t_sorted))
    left_g = torch.where(use_onehot, _take(g, t_onehot), sort_g)
    left_h = torch.where(use_onehot, _take(h, t_onehot), sort_h)
    left_c = torch.where(use_onehot, _take(c, t_onehot), sort_c)
    threshold = torch.where(use_onehot, t_onehot, t_sorted)
    return gain, threshold, left_g, left_h, left_c, bits


# ---------------------------------------------------------------------------
# combined entries
# ---------------------------------------------------------------------------
def per_feature_best(hist, parent_g, parent_h, parent_c, parent_output,
                     num_bins, default_bins, missing_types, is_categorical,
                     feature_mask, params: SplitParams,
                     has_categorical: bool = False, constraints=None,
                     rand_thresholds=None, gain_penalty=None):
    """Per-feature best split candidates for leaves ``[..., F, B, 3]``
    (the per-feature stage of ``FindBestSplitsFromHistograms``).
    ``constraints``: (monotone [F], min, max) with the bounds shaped like
    the leaf batch, or the advanced method's (monotone [F], min_l, max_l,
    min_r, max_r), each ``[..., F, B]``; ``rand_thresholds``: [..., F];
    ``gain_penalty``: CEGB's [..., F], subtracted from each finite gain
    (reference: cost_effective_gradient_boosting.hpp:23 DeltaGain).
    Returns (gain, threshold, default_left, left_g, left_h, left_c) each
    [..., F] and the bin-space bitsets [..., F, 8]."""
    p = params

    def agg(v):
        return torch.as_tensor(v, dtype=torch.float32,
                               device=hist.device)[..., None, None]

    pg, ph, pc, po = (agg(v) for v in (parent_g, parent_h, parent_c,
                                       parent_output))
    if constraints is not None and len(constraints) == 3:
        constraints = (constraints[0], agg(constraints[1]),
                       agg(constraints[2]))
    num = _numerical_best(hist, pg, ph, pc, po, num_bins, default_bins,
                          missing_types, feature_mask & ~is_categorical, p,
                          constraints, rand_thresholds)
    lead = hist.shape[:-2]
    if has_categorical:
        if hist.shape[-2] > CAT_WORDS * 32:
            raise NotImplementedError(
                "categorical splits with more than 256 bins per feature: "
                "the JAX package fails there too (ROADMAP.md, Queue 3)")
        cat = _categorical_best(hist, pg, ph, pc, po, num_bins,
                                feature_mask & is_categorical, p,
                                constraints, rand_thresholds)
    else:
        zf = torch.zeros(lead, dtype=torch.float32, device=hist.device)
        cat = (torch.full(lead, K_MIN_SCORE, device=hist.device),
               torch.zeros(lead, dtype=torch.int64, device=hist.device),
               zf, zf, zf,
               torch.zeros(lead + (CAT_WORDS,), dtype=torch.int64,
                           device=hist.device))
    use_cat = is_categorical
    gain = torch.where(use_cat, cat[0], num[0])
    if gain_penalty is not None:
        gain = torch.where(torch.isfinite(gain), gain - gain_penalty, gain)
    thr = torch.where(use_cat, cat[1], num[1])
    dl = torch.where(use_cat, False, num[2])
    lg = torch.where(use_cat, cat[2], num[3])
    lh = torch.where(use_cat, cat[3], num[4])
    lc = torch.where(use_cat, cat[4], num[5])
    return gain, thr, dl, lg, lh, lc, cat[5]


class BestSplit(NamedTuple):
    """One leaf's (or a batch of leaves') best split — the fields the fused
    learner stores per leaf."""
    gain: torch.Tensor          # f32, K_MIN_SCORE when unsplittable
    feature: torch.Tensor       # int64 inner feature index
    threshold: torch.Tensor     # int64 bin threshold
    default_left: torch.Tensor  # bool
    is_categorical: torch.Tensor  # bool
    cat_bitset: torch.Tensor    # int64 [..., 8]
    left_g: torch.Tensor
    left_h: torch.Tensor
    left_c: torch.Tensor
    left_output: torch.Tensor
    right_output: torch.Tensor


def best_split(hist, parent_g, parent_h, parent_c, parent_output, depth,
               num_bins, default_bins, missing_types, is_categorical,
               feature_mask, params: SplitParams, has_categorical: bool,
               max_depth: int, constraints=None, rand_thresholds=None,
               gain_mult=None, gain_penalty=None) -> BestSplit:
    """Best split of each leaf of a batch, with the parent-gain shift and
    the max_depth guard — the fused learner's ``best_of``
    (lambdagap_tpu/models/fused_learner.py:813-920) and, with
    ``max_depth=0`` (no guard: the host loop skips leaves at the depth
    cap), the serial learner's ``find_best_split``
    (lambdagap_tpu/ops/split.py:545-616). ``depth`` is the leaves' depth
    (an int or a tensor shaped like the batch); ``constraints`` (monotone
    [F], min, max) clamp and veto as in the scan and clamp the winner's
    outputs, the advanced method's dense (monotone, min_l, max_l, min_r,
    max_r) at the chosen (feature, threshold) (a categorical winner: the
    last prefix column of the left bounds); ``rand_thresholds`` [..., F]
    are extra_trees' candidates; ``gain_penalty`` [..., F] is CEGB's,
    taken before the shift; ``gain_mult`` [..., F] scales each feature's
    post-shift gain (``feature_contri`` times the monotone split penalty,
    fused_learner.py:891-909)."""
    p = params
    gain, thr, dl, lg, lh, lc, bits = per_feature_best(
        hist, parent_g, parent_h, parent_c, parent_output, num_bins,
        default_bins, missing_types, is_categorical, feature_mask, p,
        has_categorical, constraints, rand_thresholds, gain_penalty)
    shift = leaf_gain(parent_g, parent_h, p, parent_c, parent_output) \
        + p.min_gain_to_split
    if gain_mult is not None:
        sh = torch.as_tensor(shift, dtype=torch.float32,
                             device=hist.device)[..., None]
        gain = torch.where(torch.isfinite(gain),
                           (gain - sh) * gain_mult + sh, gain)
    f = torch.argmax(gain, dim=-1)
    gf = _take(gain, f)
    g = gf - shift
    ok = torch.isfinite(gf) & (g > 0.0)
    if max_depth > 0:
        ok = ok & (torch.as_tensor(depth, device=hist.device) < max_depth)
    lg_f, lh_f, lc_f = _take(lg, f), _take(lh, f), _take(lc, f)
    lout = calculate_leaf_output(lg_f, lh_f, p, lc_f, parent_output)
    rout = calculate_leaf_output(parent_g - lg_f, parent_h - lh_f, p,
                                 parent_c - lc_f, parent_output)
    if constraints is not None and len(constraints) == 3:
        lout = _clip(lout, constraints[1], constraints[2])
        rout = _clip(rout, constraints[1], constraints[2])
    elif constraints is not None:
        _, min_l, max_l, min_r, max_r = constraints
        t_f = _take(thr, f)
        cat_w = is_categorical[f]

        def at(a, last):
            a_f = torch.gather(a, -2, f[..., None, None].expand(
                *f.shape, 1, a.shape[-1])).squeeze(-2)      # [..., B]
            return _take(a_f, torch.full_like(t_f, a.shape[-1] - 1)
                         if last else t_f)

        lout = _clip(lout, torch.where(cat_w, at(min_l, True),
                                       at(min_l, False)),
                     torch.where(cat_w, at(max_l, True), at(max_l, False)))
        rout = _clip(rout, torch.where(cat_w, at(min_l, True),
                                       at(min_r, False)),
                     torch.where(cat_w, at(max_l, True), at(max_r, False)))
    bits_f = torch.gather(bits, -2, f[..., None, None].expand(
        *f.shape, 1, CAT_WORDS)).squeeze(-2)
    return BestSplit(torch.where(ok, g, K_MIN_SCORE), f, _take(thr, f),
                     _take(dl, f), is_categorical[f], bits_f, lg_f, lh_f,
                     lc_f, lout, rout)


def gather_threshold_split(hist_f, parent_g, parent_h, parent_c,
                           parent_output, feature: int, threshold: int,
                           num_bin: int, default_bin: int, missing_type: int,
                           is_cat: bool, params: SplitParams,
                           bounds=None) -> SplitResult:
    """Split info at a FIXED (feature, threshold) — the forced-splits scan
    (reference: feature_histogram.hpp:474-609
    GatherInfoForThresholdNumerical/Categorical). Numerical: right = bins in
    (threshold, num_bin) without the missing bin, so missing values ride
    left and ``default_left`` is True; categorical: bin == threshold goes
    left. The gain is shifted by the parent gain + min_gain_to_split and is
    K_MIN_SCORE when the split is no better than not splitting. ``bounds``
    (min, max): the leaf's monotone bounds, which clamp the child outputs
    (not the gain). The bins are summed in float64 and rounded once, so the
    card and the CPU agree to the bit."""
    p = params
    g, h, c = hist_f[:, 0], hist_f[:, 1], hist_f[:, 2]
    bin_idx = torch.arange(hist_f.shape[0], device=hist_f.device)
    in_range = bin_idx < num_bin
    excl = (((missing_type == MT_ZERO) & (bin_idx == default_bin))
            | ((missing_type == MT_NAN) & (bin_idx == num_bin - 1)))

    def total(sel, x):
        return torch.where(sel, x, 0.0).double().sum().float()

    if is_cat:
        sel = (bin_idx == threshold) & in_range
        lg, lh, lc = total(sel, g), total(sel, h), total(sel, c)
    else:
        right = (bin_idx > threshold) & in_range & ~excl
        lg = parent_g - total(right, g)
        lh = parent_h - total(right, h)
        lc = parent_c - total(right, c)
    rg, rh, rc = parent_g - lg, parent_h - lh, parent_c - lc
    l2x = p.cat_l2 if is_cat else 0.0
    gain_raw = split_gains(lg, lh, rg, rh, p, lc, rc, parent_output,
                           l2_extra=l2x)
    shift = leaf_gain(parent_g, parent_h, p, parent_c, parent_output) \
        + p.min_gain_to_split
    usable = (lh > 0) & (rh > 0) & (lc > 0) & (rc > 0)
    splittable = usable & torch.isfinite(gain_raw) & (gain_raw > shift)
    lout = calculate_leaf_output(lg, lh, p, lc, parent_output, l2_extra=l2x)
    rout = calculate_leaf_output(rg, rh, p, rc, parent_output, l2_extra=l2x)
    if bounds is not None:
        lout = _clip(lout, bounds[0], bounds[1])
        rout = _clip(rout, bounds[0], bounds[1])
    bits = (_onehot_bits(torch.full((), threshold, dtype=torch.int64,
                                    device=hist_f.device))
            if is_cat else torch.zeros(CAT_WORDS, dtype=torch.int64,
                                       device=hist_f.device))
    return SplitResult(
        gain=torch.where(splittable, gain_raw - shift, K_MIN_SCORE),
        feature=feature, threshold=threshold,
        default_left=torch.tensor(not is_cat),
        left_sum_g=lg, left_sum_h=lh, left_count=lc,
        right_sum_g=rg, right_sum_h=rh, right_count=rc,
        left_output=lout, right_output=rout,
        is_categorical=torch.tensor(is_cat), cat_bitset=bits)
