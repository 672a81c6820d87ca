"""Piece-wise linear leaves: the moments, the solve and the evaluation.

The port of ``lambdagap_tpu/ops/linear.py`` ("Gradient Boosting With
Piece-Wise Linear Regression Trees", arXiv:1802.05640; reference:
src/treelearner/linear_tree_learner.cpp CalculateLinear). Every leaf of a
linear tree fits a ridge-regularized linear model over the numeric
features on its path. Both learners call the same three functions, so a
tree's coefficients depend only on the row -> leaf map it produced:

* :func:`accumulate_leaf_moments` — per leaf ``X^T H X`` ``[L+1, P, P]``,
  ``X^T g`` ``[L+1, P]`` and the count of rows without a NaN in the leaf's
  features (``P = FL + 1``: the padded feature slots and the intercept).
  The JAX package contracts a one-hot leaf matrix against each fixed chunk
  of rows on the MXU (~5,300 chunks a tree at 10.5 M rows). Here the rows
  are ordered by leaf once (a stable sort of the map: dataset order within
  a leaf), and each leaf's segment is ONE matrix product ``V^T [V*h | g]``
  (``addmm`` into the leaf's slice), in row chunks of ``MOMENT_ROWS`` so
  the design matrix stays bounded: about ``L + N / MOMENT_ROWS`` products
  a tree. No float atomics (``index_add_`` / ``scatter_add_`` would order
  the sums differently from run to run) and no TF32: the moments are a
  function of (rows, map) alone, bit for bit, on a given device.
* :func:`solve_linear_leaves` — ONE batched float64 solve over the
  ``[L, P, P]`` stack, host numpy, copied verbatim: the coefficients are
  the model text's payload.
* :func:`linear_leaf_values` — the per-row f32 leaf evaluation ``const +
  sum_j coeff_j * x_j`` in slot order, each product and each sum rounded
  on its own (no fused multiply-add), or ``leaf_value`` when a real slot
  reads NaN. It is the plain version of the fused predict kernel's linear
  epilogue (``csrc/traverse.cu``), and the scan oracle's and the tensor
  engine's leaf evaluation, so the three engines give the same bits.
"""
from __future__ import annotations

import contextlib
from typing import Tuple

import numpy as np
import torch

# rows of a moment chunk: bounds the [rows, P] design matrix and its
# [rows, FL] int64 feature map (~0.4 GB at FL 32) at HIGGS scale
MOMENT_ROWS = 1 << 20


def leaf_feature_width(num_numeric: int, num_leaves: int) -> int:
    """The padded per-leaf feature-slot count FL, fixed per config: a
    leaf's path holds at most ``min(num_numeric, num_leaves - 1)`` distinct
    numeric features, rounded up to a multiple of 8 (floor 8), as in the
    JAX package, so the moment stack and the solve keep one shape for the
    whole run."""
    need = max(1, min(int(num_numeric), max(int(num_leaves) - 1, 1)))
    return max(8, ((need + 7) // 8) * 8)


@contextlib.contextmanager
def _full_f32():
    """f32 matrix products in full f32 (TF32 off) within the block."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def accumulate_leaf_moments(X: torch.Tensor, leaf_idx: torch.Tensor,
                            grad: torch.Tensor, hess: torch.Tensor,
                            feat_tbl, num_leaves: int
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Per-leaf normal-equation moments on X's device.

    X: [N, D] raw f32 features (the linear_tree-retained matrix).
    leaf_idx: [N] row -> leaf map (either learner's ``row_leaf``; values
        in [0, L)). grad / hess: [N] f32 sampled gradients.
    feat_tbl: [L+1, FL] int per-leaf sorted numeric path features, ``-1``
        on padding slots (row L is the dump row, all padding).

    Returns (XtHX [L+1, P, P] f32, Xtg [L+1, P] f32, cnt [L+1] f32) with
    P = FL + 1; slot P-1 is the intercept. A row with NaN in a REAL slot
    of its leaf contributes nothing and is not counted (the reference's
    NaN fallback), as in the JAX package; out-of-bag rows (zero gradients)
    are counted."""
    N, D = X.shape
    dev = X.device
    tbl = torch.as_tensor(np.asarray(feat_tbl), device=dev).long()
    Lp1, FL = tbl.shape
    assert Lp1 == num_leaves + 1
    P = FL + 1
    leaf = leaf_idx.to(device=dev, dtype=torch.int64).clamp(0, num_leaves)
    order = torch.sort(leaf, stable=True).indices
    ls = leaf[order]
    ends = torch.cumsum(torch.bincount(ls, minlength=Lp1), 0).tolist()
    out = torch.zeros((Lp1, P, P + 1), dtype=torch.float32, device=dev)
    cnt = torch.zeros(Lp1, dtype=torch.int64, device=dev)
    with _full_f32():
        for lo in range(0, N, MOMENT_ROWS):
            hi = min(lo + MOMENT_ROWS, N)
            rows, lc = order[lo:hi], ls[lo:hi]
            feats = tbl[lc]                                    # [n, FL]
            slot = feats >= 0
            vals = torch.gather(X[rows], 1, feats.clamp(0, D - 1))
            nan = torch.isnan(vals)
            ok = ~(slot & nan).any(1) & (lc < num_leaves)
            v = torch.cat([torch.where(slot & ~nan, vals, 0.0),
                           torch.ones((hi - lo, 1), dtype=torch.float32,
                                      device=dev)], 1)         # [n, P]
            g = torch.where(ok, grad[rows], 0.0)
            h = torch.where(ok, hess[rows], 0.0)
            rhs = torch.cat([v * h[:, None], g[:, None]], 1)  # [n, P+1]
            cnt += torch.bincount(lc[ok], minlength=Lp1)
            # the leaves whose segments meet this chunk: one product each
            first = int(np.searchsorted(ends, lo, side="right"))
            for leaf_id in range(first, num_leaves):
                a = max(ends[leaf_id - 1] if leaf_id else 0, lo) - lo
                b = min(ends[leaf_id], hi) - lo
                if b > a:
                    out[leaf_id].addmm_(v[a:b].T, rhs[a:b])
                if ends[leaf_id] >= hi:
                    break
    return (out[:, :, :P].contiguous(), out[:, :, P].contiguous(),
            cnt.to(torch.float32))


def solve_linear_leaves(XtHX: np.ndarray, Xtg: np.ndarray, cnt: np.ndarray,
                        nfeat: np.ndarray, linear_lambda: float
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """ONE batched regularized solve over the [L, P, P] moment stack.

    Host float64 (the coefficients are serialized into model text and
    replayed exactly — float64 solve output is the payload contract).
    ``linear_lambda`` rides the FEATURE diagonal only (the intercept is
    unregularized, matching the reference); padding slots get identity
    rows so the batch stays non-singular regardless of ragged per-leaf
    widths. Returns (sol [L, P] f64, ok [L] bool) where ``ok`` is the
    reference's eligibility: >= 1 path feature, more valid rows than
    unknowns, finite solution, non-singular system.
    """
    L, P = Xtg.shape
    FL = P - 1
    M = XtHX.astype(np.float64).copy()
    b = -Xtg.astype(np.float64)
    slots = np.arange(FL)[None, :] < nfeat[:, None]          # [L, FL]
    fd = np.arange(FL)
    M[:, fd, fd] += np.where(slots, float(linear_lambda), 0.0)
    # padding slots (and the intercept row of feature-less leaves) would be
    # all-zero rows; identity them so ONE batched solve covers the ragged
    # stack, then mask ineligible leaves after
    dead = np.concatenate([~slots, np.zeros((L, 1), bool)], axis=1)
    for j in range(P):
        rows = dead[:, j]
        if rows.any():
            M[rows, j, :] = 0.0
            M[rows, :, j] = 0.0
            M[rows, j, j] = 1.0
            b[rows, j] = 0.0
    try:
        sol = np.linalg.solve(M, b[..., None])[..., 0]
        solved = np.ones(L, bool)
    except np.linalg.LinAlgError:
        # rare (linear_lambda=0 + degenerate leaf): retry leaf-by-leaf so
        # one singular system only constant-falls ITS leaf
        sol = np.zeros((L, P), np.float64)
        solved = np.zeros(L, bool)
        for leaf in range(L):
            try:
                sol[leaf] = np.linalg.solve(M[leaf], b[leaf])
                solved[leaf] = True
            except np.linalg.LinAlgError:
                pass   # a singular leaf keeps its constant output
    ok = (solved & (nfeat >= 1) & (cnt >= nfeat + 1)
          & np.isfinite(sol).all(axis=1))
    return sol, ok


def linear_leaf_values(x: torch.Tensor, leaf_flat: torch.Tensor,
                       leaf_value_flat: torch.Tensor,
                       leaf_const_flat: torch.Tensor,
                       leaf_feat_flat: torch.Tensor,
                       leaf_coeff_flat: torch.Tensor) -> torch.Tensor:
    """Per-row linear leaf outputs, f32 [R, K].

    x: [R, D] raw f32 rows; leaf_flat: [R, K] flat leaf indices into the
    tree-major flattened leaf tables (K: the trees evaluated per row).
    leaf_*_flat: [T*L(, FL)] flattened per-leaf tables; feature ``-1``
    marks a padding slot (coefficient 0).

    A row with NaN in any REAL slot of its leaf falls back to
    ``leaf_value``; otherwise ``leaf_const + sum_j coeff_j * x_j``, added
    in slot order, each product and each sum rounded on its own, so the
    bits are the same in every engine and in the fused kernel's epilogue
    (which may stop at a leaf's first padding slot: a padding slot adds
    +0.0, which changes at most the sign of a zero)."""
    R, K = leaf_flat.shape
    FL = leaf_feat_flat.shape[-1]
    D = x.shape[1]
    leaf = leaf_flat.long()
    feats = leaf_feat_flat[leaf].long()                # [R, K, FL]
    slot = feats >= 0
    vals = torch.gather(x, 1, feats.clamp(0, D - 1).reshape(R, K * FL)
                        ).reshape(R, K, FL)
    nan = torch.isnan(vals)
    nan_row = (slot & nan).any(-1)                     # [R, K]
    v = torch.where(slot & ~nan, vals, 0.0)
    coeff = leaf_coeff_flat[leaf]                      # [R, K, FL]
    lin = leaf_const_flat[leaf]
    for j in range(FL):
        lin = lin + coeff[..., j] * v[..., j]
    return torch.where(nan_row, leaf_value_flat[leaf], lin)
