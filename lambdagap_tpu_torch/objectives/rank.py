"""Ranking objectives: the extended LambdaRank family and RankXENDCG.

The port of ``lambdagap_tpu/objectives/rank.py``. ``lambdarank_target``
selects one of 18 pairwise gradient targets — ranknet / bin-ranknet / ndcg
/ bndcg / lambdaloss-{ndcg,bndcg}[-plus-plus] / precision / arpk /
lambdaloss-arp{1,2} / lambdagap-{s,x}[-plus[-plus]] — with the
``lambdagap_weight`` hybrid knob (reference:
src/objective/rank_objective.hpp:22-41 target enum, :253-524 pairwise loop
with per-target pair windows and delta_pair formulas).

Queries are bucketed by padded power-of-two length (at least 8). The JAX
package ``vmap``s one query's pair lattice over a bucket inside one jitted
program; here each bucket is batched torch ops over ``[nq, L]`` scores and
``[nq, R, L]`` pair blocks on the device, with the same f32 arithmetic per
pair. Three things differ, none of them in what a pair contributes:

* Eager torch keeps every intermediate of the lattice alive where XLA
  fuses them away, so a bucket is split into chunks of queries that form at
  most :data:`PAIR_CHUNK` pair entries each. Every document belongs to one
  query, so a chunk's lambdas are the same numbers.
* Targets whose outer loop stops at the truncation level (ndcg and the
  other ``_TRUNCATED_I_TARGETS``) form only the first
  ``min(L, truncation_level)`` rows of the lattice: the other rows hold no
  valid pair. The JAX package's row-tiled sweep stops there too.
* The transcendental functions are taken in float64 and rounded once (the
  discount table, ``exp`` in the pair sigmoid and the softmax, ``log2`` in
  the norm factor), and the lattice's row and column sums and the
  position-bias sums accumulate in float64: the card and the CPU then give
  the same float32 gradients, so the trees they grow do not part over an
  ulp (the binary objective's ``exp`` does the same).

No Pallas kernel is on this path in the JAX package (``_lambdarank_bucket``
is XLA-lowered), so there is no hand-written kernel here either.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..utils import log, prng
from .base import K_EPSILON, ObjectiveFunction, register_objective

K_MIN_SCORE = -1e30

# targets using the binarized pair filter (skip pairs with both labels > 0)
# (reference: rank_objective.hpp:365-380)
_BINARY_TARGETS = frozenset({
    "precision", "bndcg", "lambdaloss-bndcg", "lambdaloss-bndcg-plus-plus",
    "arpk", "bin-ranknet", "lambdagap-s", "lambdagap-x", "lambdagap-s-plus",
    "lambdagap-x-plus", "lambdagap-s-plus-plus", "lambdagap-x-plus-plus"})

# targets whose outer loop stops at the truncation level
# (reference: rank_objective.hpp:306-321)
_TRUNCATED_I_TARGETS = frozenset({
    "ndcg", "lambdaloss-ndcg", "lambdaloss-ndcg-plus-plus", "bndcg",
    "lambdaloss-bndcg", "lambdaloss-bndcg-plus-plus", "precision"})

_J_FROM_TL_TARGETS = frozenset({
    "precision", "arpk", "lambdagap-s-plus", "lambdagap-x-plus",
    "lambdagap-s-plus-plus", "lambdagap-x-plus-plus"})

# queries up to this padded length use the dense lattice; longer ones the
# row-tiled sweep (same math, O(L*tile) memory per query)
_DENSE_PAIR_L = 4096

# the most pair entries one chunk of queries forms per lattice intermediate
# (f32: 256 MB each)
PAIR_CHUNK = 1 << 26


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def max_dcg_at_k(labels: np.ndarray, k: int, label_gain: np.ndarray) -> float:
    """(reference: dcg_calculator.cpp CalMaxDCGAtK)"""
    top = np.sort(labels)[::-1][:k]
    disc = 1.0 / np.log2(2.0 + np.arange(len(top)))
    return float(np.sum(label_gain[top.astype(np.int64)] * disc))


def max_bdcg_at_k(labels: np.ndarray, k: int) -> float:
    """Binarized max DCG (fork-added; reference: dcg_calculator.cpp:82
    CalMaxBDCGAtK): sum of top-min(k, #relevant) discounts."""
    relevant = int(np.sum(labels > 0))
    kk = min(k, len(labels), relevant)
    if kk <= 0:
        return 0.0
    return float(np.sum(1.0 / np.log2(2.0 + np.arange(kk))))


def tile_for(L: int) -> Optional[int]:
    """The row tile of a bucket of padded length ``L``: None (dense) up to
    :data:`_DENSE_PAIR_L`, else ``max(_DENSE_PAIR_L**2 // L, 64)``, which
    divides the power-of-two ``L``."""
    return None if L <= _DENSE_PAIR_L else max(
        (_DENSE_PAIR_L * _DENSE_PAIR_L) // L, 64)


class _QueryBuckets:
    """Queries grouped by padded power-of-two length (at least 8), with no
    length cap: ``buckets`` holds ``(L, qids, idx)`` with ``idx`` int32
    ``[nq, L]`` row ids, ``num_data`` marking a pad."""

    def __init__(self, query_boundaries: np.ndarray, num_data: int) -> None:
        self.num_data = num_data
        qb = np.asarray(query_boundaries, dtype=np.int64)
        lengths = np.diff(qb)
        self.num_queries = len(lengths)
        buckets: Dict[int, List[int]] = {}
        for qi, ln in enumerate(lengths):
            L = max(_next_pow2(int(ln)), 8)
            buckets.setdefault(L, []).append(qi)
        self.buckets = []
        for L, qids in sorted(buckets.items()):
            q = np.asarray(qids, np.int64)
            ln = lengths[q]
            col = np.arange(L, dtype=np.int64)[None, :]
            idx = np.where(col < ln[:, None], qb[q][:, None] + col,
                           num_data).astype(np.int32)
            self.buckets.append((L, np.asarray(qids, np.int32), idx))


_TABLES: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def _discount_tables(L: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 ``1/log2(2 + r)`` for r in [0, L] and the lambdaloss term
    ``disc[d] - disc[d + 1]`` for d in [0, L), computed in float64 and
    rounded once, kept per (L, device) so no call copies from the host."""
    key = (L, str(device))
    t = _TABLES.get(key)
    if t is None:
        disc = (1.0 / np.log2(2.0 + np.arange(L + 1))).astype(np.float32)
        loss = disc[:-1] - disc[1:]              # f32 subtraction
        t = (torch.from_numpy(disc).to(device),
             torch.from_numpy(loss).to(device))
        _TABLES[key] = t
    return t


def _pair_block(i, j, si, sj, li, lj, vij, imd, imb, best, worst, tables,
                gains, *, target, sigmoid, norm, tl, w):
    """All pair quantities of one block of the sorted lattice of a chunk of
    queries. i / j: rank indices ``[1, R, 1]`` / ``[1, 1, L]``; s, l: scores
    and f32 labels at those ranks (``[nq, R, 1]`` / ``[nq, 1, L]``); vij
    the validity product; imd, imb, best, worst ``[nq, 1, 1]``. Returns
    (lam_to_row ``[nq, R, L]``, the signed lambda of the ROW document, p
    hessian, sum of p_lambda ``[nq]`` f64, valid pair count ``[nq]``); the
    column document's lambda is minus the row's (reference: :505-512)."""
    disc, loss_tab = tables
    pair_valid = vij & (i < j) & (li != lj)
    if target in _BINARY_TARGETS:
        pair_valid = pair_valid & ~((li > 0) & (lj > 0))
    # outer-loop truncation (i_end) and per-target (start, end) windows
    if target in _TRUNCATED_I_TARGETS:
        pair_valid = pair_valid & (i < tl)
    if target in _J_FROM_TL_TARGETS:
        pair_valid = pair_valid & (j >= tl)   # j >= max(i+1, tl); i<j holds
    elif target == "lambdagap-s":
        pair_valid = pair_valid & (j == i + tl)
    elif target == "lambdagap-x":
        pair_valid = pair_valid & (j >= i + tl)

    # orient the pair: high = larger label
    hi_is_i = li > lj
    delta_score = torch.where(hi_is_i, si, sj) - torch.where(hi_is_i, sj, si)

    def lambdarank():
        # |disc(rank of high) - disc(rank of low)|, symmetric in the ranks
        return torch.abs(disc[i] - disc[j])

    def lambdaloss():
        return loss_tab[(j - i).clamp(0, loss_tab.shape[0] - 1)]

    def gain_gap():
        gd = gains[li.long()] - gains[lj.long()]
        return torch.where(hi_is_i, gd, -gd)

    def f32(x):
        return x.to(torch.float32)

    # delta_pair per target (reference: rank_objective.hpp:398-489)
    if target == "ndcg":
        delta = gain_gap() * lambdarank() * imd
    elif target == "lambdaloss-ndcg":
        delta = gain_gap() * lambdaloss() * imd
    elif target == "lambdaloss-ndcg-plus-plus":
        delta = gain_gap() * (lambdarank() + lambdaloss() * w) * imd
    elif target == "bndcg":
        delta = lambdarank() * imb
    elif target == "lambdaloss-bndcg":
        delta = lambdaloss() * imb
    elif target == "lambdaloss-bndcg-plus-plus":
        delta = (lambdarank() + lambdaloss() * w) * imb
    elif target in ("precision", "lambdagap-s", "lambdagap-x",
                    "bin-ranknet", "ranknet"):
        delta = torch.ones_like(delta_score)
    elif target == "lambdagap-s-plus":
        delta = f32(j - i == tl) * w + f32(i < tl)
    elif target == "lambdagap-x-plus":
        delta = f32(j - i >= tl) * w + f32(i < tl)
    elif target == "lambdagap-s-plus-plus":
        delta = ((f32(j - i == tl) * w + f32(j + 1 - tl))
                 - f32((i >= tl) * (i + 1 - tl)))
    elif target == "lambdagap-x-plus-plus":
        delta = ((f32(j - i >= tl) * w + f32(j + 1 - tl))
                 - f32((i >= tl) * (i + 1 - tl)))
    elif target == "arpk":
        delta = f32((j + 1 - tl) - (i >= tl) * (i + 1 - tl))
    elif target == "lambdaloss-arp1":
        delta = torch.where(hi_is_i, li, lj)
    elif target == "lambdaloss-arp2":
        delta = torch.where(hi_is_i, li, lj) - torch.where(hi_is_i, lj, li)
    else:
        raise ValueError(f"unknown lambdarank target {target!r}")

    pair_valid = pair_valid & (delta != 0)

    # score-distance normalization (reference: :495-498)
    if norm:
        delta = torch.where(best != worst,
                            delta / (torch.abs(delta_score) + 0.01), delta)

    e = torch.exp((delta_score * sigmoid).double()).float()
    p = 1.0 / (e + 1.0)
    p_lambda = delta * (-sigmoid) * p
    p_hessian = delta * (sigmoid * sigmoid) * p * (1.0 - p)
    p_lambda = torch.where(pair_valid, p_lambda, 0.0)
    p_hessian = torch.where(pair_valid, p_hessian, 0.0)
    lam_to_row = torch.where(hi_is_i, p_lambda, -p_lambda)
    return (lam_to_row, p_hessian,
            p_lambda.sum((1, 2), dtype=torch.float64),
            pair_valid.sum((1, 2), dtype=torch.float64))


def _lambdarank_bucket(scores, labels, valid, inv_dcg, inv_bdcg, label_gain,
                       *, target: str, sigmoid: float, norm: bool,
                       truncation_level: int, lambdagap_weight: float,
                       tile: Optional[int] = None,
                       chunk_pairs: int = PAIR_CHUNK):
    """Per-query lambdas of one padded bucket.

    scores / labels / valid: ``[nq, L]``; inv_dcg / inv_bdcg: ``[nq]``;
    label_gain f32 on the same device. Returns (lambdas ``[nq, L]``,
    hessians ``[nq, L]``, effective pair rate ``[nq]``), f32.

    ``tile=None`` forms the lattice's rows in one block, ``tile=T`` in
    blocks of T rows (T must divide L) — the same arithmetic per pair, peak
    memory O(L*T). Rows at or past the truncation level of a truncated
    target hold no valid pair and are not formed. Queries go through in
    chunks of at most ``chunk_pairs`` pair entries."""
    nq, L = scores.shape
    tl = truncation_level
    if tile is not None and L % tile != 0:
        raise ValueError(f"tile={tile} must divide the padded bucket length "
                         f"{L}")
    dev = scores.device
    i_limit = min(L, tl) if target in _TRUNCATED_I_TARGETS else L
    if tile is None:
        blocks = [(0, i_limit)]
    else:
        blocks = [(b * tile, tile) for b in range(-(-i_limit // tile))]
    rows = max(r for _, r in blocks)
    per_chunk = max(1, chunk_pairs // (rows * L))
    tables = _discount_tables(L, dev)
    kw = dict(target=target, sigmoid=sigmoid, norm=norm, tl=tl,
              w=lambdagap_weight)
    ranks = torch.arange(L, device=dev)
    jr = ranks[None, None, :]
    lam_out, hes_out, eff_out = [], [], []
    for c0 in range(0, nq, per_chunk):
        c1 = min(nq, c0 + per_chunk)
        s, lab, v = scores[c0:c1], labels[c0:c1], valid[c0:c1]
        neg = torch.where(v, s, K_MIN_SCORE)
        # ranks by score, descending, ties in document order (pads last)
        order = torch.argsort(-neg, dim=1, stable=True)
        ss = neg.gather(1, order)
        ls = lab.gather(1, order).to(torch.float32)
        vs = v.gather(1, order)
        nv = vs.sum(1)
        best = ss[:, :1, None]
        worst = ss.gather(1, (nv - 1).clamp(min=0)[:, None])[:, :, None]
        imd = inv_dcg[c0:c1, None, None]
        imb = inv_bdcg[c0:c1, None, None]
        sj, lj, vj = ss[:, None, :], ls[:, None, :], vs[:, None, :]
        n = c1 - c0
        lam_row = torch.zeros((n, L), dtype=torch.float64, device=dev)
        hes_row = torch.zeros_like(lam_row)
        col_lam = torch.zeros_like(lam_row)
        col_hes = torch.zeros_like(lam_row)
        sum_pl = torch.zeros(n, dtype=torch.float64, device=dev)
        count = torch.zeros_like(sum_pl)
        for off, r in blocks:
            ir = ranks[None, off:off + r, None]
            si = ss[:, off:off + r, None]
            li = ls[:, off:off + r, None]
            vi = vs[:, off:off + r, None]
            ltr, ph, spl, cnt = _pair_block(
                ir, jr, si, sj, li, lj, vi & vj, imd, imb, best, worst,
                tables, label_gain, **kw)
            lam_row[:, off:off + r] += ltr.sum(2, dtype=torch.float64)
            hes_row[:, off:off + r] += ph.sum(2, dtype=torch.float64)
            col_lam += ltr.sum(1, dtype=torch.float64)
            col_hes += ph.sum(1, dtype=torch.float64)
            sum_pl += spl
            count += cnt
            del ltr, ph
        lam_sorted = (lam_row - col_lam).to(torch.float32)
        hes_sorted = (hes_row + col_hes).to(torch.float32)
        if norm:
            sum_lambdas = -2.0 * sum_pl
            factor = torch.where(
                sum_lambdas > 0,
                torch.log2(1.0 + sum_lambdas)
                / torch.clamp(sum_lambdas, min=K_EPSILON),
                1.0).to(torch.float32)[:, None]
            lam_sorted = lam_sorted * factor
            hes_sorted = hes_sorted * factor
        # unsort back to document order
        lam_out.append(torch.zeros_like(lam_sorted).scatter_(1, order,
                                                             lam_sorted))
        hes_out.append(torch.zeros_like(hes_sorted).scatter_(1, order,
                                                             hes_sorted))
        nvf = nv.to(torch.float64)
        eff_out.append((2.0 * count / torch.clamp(nvf * (nvf - 1.0), min=1.0)
                        ).to(torch.float32))
    return torch.cat(lam_out), torch.cat(hes_out), torch.cat(eff_out)


def lattice_entries(buckets, target: str, truncation_level: int) -> int:
    """Pair entries the lambda pass forms per round over ``buckets``
    (``_QueryBuckets.buckets``): nq x rows x L a bucket, rows cut at the
    truncation level for a truncated target."""
    total = 0
    for L, qids, _ in buckets:
        rows = (min(L, truncation_level) if target in _TRUNCATED_I_TARGETS
                else L)
        tile = tile_for(L)
        if tile is not None:
            rows = -(-rows // tile) * tile
        total += len(qids) * rows * L
    return total


class RankingBase(ObjectiveFunction):
    """Shared query plumbing (reference: rank_objective.hpp:45-147
    RankingObjective): the bucket loop on the device, position-bias Newton
    updates and the effective-pair-rate debug line."""

    def __init__(self, config: Config) -> None:
        super().__init__(config)
        self.position_bias_regularization = \
            config.lambdarank_position_bias_regularization
        self.learning_rate = config.learning_rate
        self.iter_count = 0
        self.last_effective_pair_rate = None
        self.positions: Optional[torch.Tensor] = None
        self.pos_biases: Optional[torch.Tensor] = None

    def init(self, metadata, num_data: int, device: torch.device) -> None:
        super().init(metadata, num_data, device)
        if metadata.query_boundaries is None:
            log.fatal("Ranking tasks require query information")
        self.query_boundaries = np.asarray(metadata.query_boundaries)
        self.num_queries = metadata.num_queries
        self.bucketing = _QueryBuckets(self.query_boundaries, num_data)
        self.bucket_idx = [torch.from_numpy(idx.astype(np.int64)).to(device)
                           for (_, _, idx) in self.bucketing.buckets]
        # positions for unbiased LTR
        if metadata.position is not None:
            pos = np.asarray(metadata.position, np.int64)
            self.positions = torch.from_numpy(pos).to(device)
            self.num_position_ids = int(pos.max()) + 1
            self.pos_biases = torch.zeros(self.num_position_ids,
                                          dtype=torch.float32, device=device)
        else:
            self.num_position_ids = 0
        self._pad = torch.tensor([K_MIN_SCORE], dtype=torch.float32,
                                 device=device)
        self._pad_label = torch.zeros(1, dtype=torch.float32, device=device)

    def _bucket_gradients(self, b: int, scores_b, labels_b, valid_b, key):
        """Bucket ``b``'s (lambdas, hessians, effective pair rates)."""
        raise NotImplementedError

    def _next_key(self) -> Optional[torch.Tensor]:
        """Per-iteration PRNG key for randomized subclasses."""
        return None

    def get_gradients_fast(self, scores: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
        s = scores[0]
        if self.positions is not None:
            s = s + self.pos_biases[self.positions]
        n = self.num_data
        pad_s = torch.cat([s, self._pad])
        pad_l = torch.cat([self.label, self._pad_label])
        grad = torch.zeros(n + 1, dtype=torch.float32, device=s.device)
        hess = torch.zeros_like(grad)
        eff_sum = torch.zeros((), dtype=torch.float32, device=s.device)
        key = self._next_key()
        for b, idx in enumerate(self.bucket_idx):
            lam, hes, eff = self._bucket_gradients(
                b, pad_s[idx], pad_l[idx], idx < n, key)
            flat = idx.reshape(-1)
            grad.index_add_(0, flat, lam.reshape(-1))
            hess.index_add_(0, flat, hes.reshape(-1))
            eff_sum = eff_sum + eff.sum()
        g, h = grad[:-1], hess[:-1]
        if self.weight is not None:
            g = g * self.weight
            h = h * self.weight
        if self.positions is not None:
            self._update_position_bias(g, h)
        # the fork's per-iteration effective-pair-rate line (reference:
        # src/objective/rank_objective.hpp:108-116): its host read is paid
        # only when debug logging is on
        if log.debug_enabled():
            rate = float(eff_sum) / max(self.num_queries, 1)
            self.last_effective_pair_rate = rate
            log.debug("iteration %d: effective pair rate %.4f "
                      "(mean over %d queries)",
                      self.iter_count + 1, rate, self.num_queries)
        self.iter_count += 1
        return g[None, :], h[None, :]

    def _update_position_bias(self, grad, hess) -> None:
        """Newton-Raphson on per-position utility derivatives (reference:
        rank_objective.hpp:554-591 UpdatePositionBiasFactors); the segment
        sums accumulate in float64."""
        npos = self.num_position_ids

        def segment_sum(x):
            out = torch.zeros(npos, dtype=torch.float64, device=x.device)
            return out.index_add_(0, self.positions,
                                  x.to(torch.float64)).to(torch.float32)

        first = -segment_sum(grad)
        second = -segment_sum(hess)
        counts = segment_sum(torch.ones_like(grad))
        reg = self.position_bias_regularization
        first = first - self.pos_biases * reg * counts
        second = second - counts * reg
        self.pos_biases = self.pos_biases + \
            first * self.learning_rate / (torch.abs(second) + 0.001)


@register_objective
class LambdarankNDCG(RankingBase):
    """The 18-target LambdaRank (reference: rank_objective.hpp:174-648
    LambdarankNDCG)."""
    name = "lambdarank"

    def __init__(self, config: Config) -> None:
        super().__init__(config)
        self.sigmoid = config.sigmoid
        self.norm = config.lambdarank_norm
        self.truncation_level = config.lambdarank_truncation_level
        self.target = config.lambdarank_target
        self.lambdagap_weight = config.lambdagap_weight

    def init(self, metadata, num_data: int, device: torch.device) -> None:
        super().init(metadata, num_data, device)
        max_label = int(self.label_np.max())
        if np.any(self.label_np < 0) or np.any(
                self.label_np != np.floor(self.label_np)):
            log.fatal("[lambdarank]: labels must be non-negative integers")
        gains = np.asarray(self.config.label_gain_or_default(max_label))
        if max_label >= len(gains):
            log.fatal("Label %d exceeds label_gain size %d", max_label,
                      len(gains))
        self.label_gain = torch.from_numpy(
            gains.astype(np.float32)).to(device)
        # per-query inverse max (B)DCG at the truncation level
        # (reference: rank_objective.hpp:250-266)
        inv_dcg = np.zeros(self.num_queries)
        inv_bdcg = np.zeros(self.num_queries)
        qb = self.query_boundaries
        for qi in range(self.num_queries):
            ql = self.label_np[qb[qi]:qb[qi + 1]]
            d = max_dcg_at_k(ql, self.truncation_level, gains)
            b = max_bdcg_at_k(ql, self.truncation_level)
            inv_dcg[qi] = 1.0 / d if d > 0 else 0.0
            inv_bdcg[qi] = 1.0 / b if b > 0 else 0.0
        self.inv_max_dcg = inv_dcg
        self.inv_max_bdcg = inv_bdcg
        self.bucket_aux = [
            (torch.from_numpy(inv_dcg[qids].astype(np.float32)).to(device),
             torch.from_numpy(inv_bdcg[qids].astype(np.float32)).to(device))
            for (_, qids, _) in self.bucketing.buckets]
        self.pair_entries = lattice_entries(
            self.bucketing.buckets, self.target, self.truncation_level)
        log.info("Using lambdarank objective with target '%s'", self.target)

    def _bucket_gradients(self, b, scores_b, labels_b, valid_b, key):
        inv_dcg, inv_bdcg = self.bucket_aux[b]
        return _lambdarank_bucket(
            scores_b, labels_b, valid_b, inv_dcg, inv_bdcg, self.label_gain,
            target=self.target, sigmoid=self.sigmoid, norm=self.norm,
            truncation_level=self.truncation_level,
            lambdagap_weight=self.lambdagap_weight,
            tile=tile_for(scores_b.shape[1]))


@register_objective
class RankXENDCG(RankingBase):
    """Cross-entropy NDCG surrogate (reference: rank_objective.hpp:650-724
    RankXENDCG): per-query softmax with Gumbel-perturbed gains and a
    third-order gradient correction. The per-iteration key, its per-bucket
    ``fold_in`` and per-query split draw the JAX package's threefry bits."""
    name = "rank_xendcg"

    def __init__(self, config: Config) -> None:
        super().__init__(config)
        self.seed = config.seed

    def init(self, metadata, num_data: int, device: torch.device) -> None:
        super().init(metadata, num_data, device)
        self.key = prng.PRNGKey(self.seed)
        self.pair_entries = 0

    def _next_key(self) -> torch.Tensor:
        keys = prng.split(self.key)
        self.key = keys[0]
        return keys[1]

    def _bucket_gradients(self, b, scores_b, labels_b, valid_b, key):
        return _xendcg_bucket(scores_b, labels_b, valid_b,
                              prng.fold_in(key, scores_b.shape[1]))


def _xendcg_bucket(scores, labels, valid, key):
    """One bucket's xendcg (lambdas, hessians, zeros ``[nq]``); ``key``
    splits into one key per query, each drawing its ``[L]`` uniforms."""
    nq, L = scores.shape
    nv = valid.sum(1, keepdim=True)
    sm = torch.where(valid, scores, K_MIN_SCORE)
    m = sm.max(1, keepdim=True).values
    e = torch.where(valid, torch.exp((sm - m).double()).float(), 0.0)
    rho = e / torch.clamp(e.sum(1, keepdim=True, dtype=torch.float64)
                          .to(torch.float32), min=K_EPSILON)
    u = prng.uniform(prng.split(key, nq), L, scores.device)
    phi = torch.where(valid, torch.pow(2.0, labels.to(torch.float32)) - u,
                      0.0)
    inv_denominator = 1.0 / torch.clamp(
        phi.sum(1, keepdim=True, dtype=torch.float64).to(torch.float32),
        min=K_EPSILON)

    def rowsum(x):
        return x.sum(1, keepdim=True, dtype=torch.float64).to(torch.float32)

    # third-order expansion (reference: rank_objective.hpp:695-719)
    one_minus = torch.clamp(1.0 - rho, min=K_EPSILON)
    term1 = -phi * inv_denominator + rho
    lam = term1
    params = torch.where(valid, term1 / one_minus, 0.0)
    term2 = rho * (rowsum(params) - params)
    lam = lam + term2
    params = torch.where(valid, term2 / one_minus, 0.0)
    lam = lam + rho * (rowsum(params) - params)
    hes = rho * (1.0 - rho)
    live = valid & (nv > 1)
    return (torch.where(live, lam, 0.0), torch.where(live, hes, 0.0),
            torch.zeros(nq, dtype=torch.float32, device=scores.device))
